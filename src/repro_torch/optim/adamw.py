"""AdamW with optional 8-bit (block-quantized) moment states.

The PyTorch counterpart of ``repro.optim.adamw``, with its arithmetic:
weight decay inside the step (``m̂/(√v̂+ε) + wd·p``, then ``p − lr·step``),
computed in f32 and cast back to the parameter's dtype with no f32 master
copy, and bias corrections from the step count as f32.  The 8-bit variant
stores m and v as int8 with per-block (128) f32 absmax scales
(bitsandbytes-style [arXiv:2110.02861]), v through a quadratic map.

The state is a tree mirroring the parameters, updated IN PLACE: a
stacked parameter whose gradient comes as the list of its layer slices
(what the train step produces) is updated slice by slice, so a 4B-param
model never holds a whole-stack f32 temporary.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.distributed.sharding import (P, NamedSharding, ShapeDtypeStruct, axis_names,
                                              contiguous_stride, is_dtensor, mesh_device,
                                              mesh_shape, shift_placements)
from repro_torch.tree import tree_leaves, tree_map

QBLOCK = 128


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    quantized: bool = False  # 8-bit m/v states


@dataclasses.dataclass(frozen=True)
class Q8State:
    """Block-quantized fp32 tensor: int8 payload + per-block absmax scale."""

    q: torch.Tensor  # (nblk * QBLOCK,) int8
    scale: torch.Tensor  # (nblk,) f32
    shape: Tuple[int, ...]


def _q8_zeros(shape, device=None) -> Q8State:
    nblk = -(-math.prod(shape) // QBLOCK)
    return Q8State(
        q=torch.zeros((nblk * QBLOCK,), dtype=torch.int8, device=device),
        scale=torch.zeros((nblk,), dtype=torch.float32, device=device),
        shape=tuple(shape),
    )


def _q8_read(st: Q8State, *, sqrt_scale: bool = False) -> torch.Tensor:
    q = st.q.float().reshape(-1, QBLOCK)
    x = (q * st.scale[:, None] / 127.0).reshape(-1)
    x = x[:math.prod(st.shape)].reshape(st.shape)
    return x.square() if sqrt_scale else x


def _q8_write(st: Q8State, x: torch.Tensor, *, sqrt_scale: bool = False) -> Q8State:
    """sqrt_scale stores sqrt(x) (x >= 0): a quadratic quantization map.

    Linear int8 under-flows Adam's tiny second moments to exactly 0, which
    explodes m/(sqrt(v)+eps); the quadratic map keeps the smallest nonzero
    representable value at (blockmax/127²) instead of blockmax/127.
    """
    flat = x.reshape(-1).float()
    if sqrt_scale:
        flat = torch.sqrt(torch.clamp(flat, min=0.0))
    flat = torch.nn.functional.pad(flat, (0, st.q.shape[0] - flat.shape[0]))
    blk = flat.reshape(-1, QBLOCK)
    scale = torch.clamp(blk.abs().amax(1), min=1e-12)
    q = torch.clamp(torch.round(blk / scale[:, None] * 127.0), -127, 127).to(torch.int8)
    return Q8State(q=q.reshape(-1), scale=scale, shape=st.shape)


def adamw_init(params: Any, cfg: OptConfig) -> Any:
    def mk(p):
        if cfg.quantized:
            return {"m": _q8_zeros(p.shape, p.device), "v": _q8_zeros(p.shape, p.device)}
        return {
            "m": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            "v": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        }

    device = tree_leaves(params)[0].device
    return {"mu": tree_map(mk, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _adam(p, g, m, v, b1c, b2c, cfg: OptConfig):
    """One element-wise AdamW update of ``p``, ``m`` and ``v`` in place
    (f32 moments); the reference's expression order throughout."""
    g32 = g.float()
    m.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
    v.mul_(cfg.b2).add_(g32.square(), alpha=1 - cfg.b2)
    del g32
    step = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
    p32 = p.float()
    step.add_(p32, alpha=cfg.weight_decay)
    p.copy_(p32.sub_(step, alpha=cfg.lr))


def _local(t, want: tuple, what: str):
    """A DTensor's local block, checked to lie as ``want`` says (the update
    is elementwise, so each rank's blocks of p, g, m and v must line up)."""
    if tuple(t.placements) != want:
        raise ValueError(f"{what} placed {tuple(t.placements)}, its parameter {want}")
    return t.to_local()


def adamw_update(params: Any, grads: Any, state: Any, cfg: OptConfig):
    """One AdamW step → (params, state), both updated in place.

    A gradient may be the list of a stacked parameter's layer slices.  On
    DTensors laid out alike (parameters by ``param_specs``, moments by
    ``opt_state_specs``, gradients constrained to the parameters' shardings)
    each rank updates its own blocks, with the same arithmetic."""
    count = state["count"] + 1
    c = count.to_local() if is_dtensor(count) else count
    b1c = 1.0 - torch.pow(cfg.b1, c.float())
    b2c = 1.0 - torch.pow(cfg.b2, c.float())

    def upd(p, g, mv):
        if is_dtensor(p):
            if cfg.quantized:
                raise NotImplementedError("the 8-bit update of sharded moments: "
                                          "opt_state_specs gives its layout only")
            pl = tuple(p.placements)
            if isinstance(g, list):
                g = [_local(s, shift_placements(pl, -1), "a layer's gradient") for s in g]
            else:
                g = _local(g, pl, "a gradient")
            p = p.to_local()
            mv = {"m": _local(mv["m"], pl, "m"), "v": _local(mv["v"], pl, "v")}
        if cfg.quantized:
            if isinstance(g, list):
                g = torch.stack(g)
            m = _q8_read(mv["m"])
            v = _q8_read(mv["v"], sqrt_scale=True)
            _adam(p, g, m, v, b1c, b2c, cfg)
            mv["m"] = _q8_write(mv["m"], m)
            mv["v"] = _q8_write(mv["v"], v, sqrt_scale=True)
        elif isinstance(g, list):
            for ps, gs, ms, vs in zip(p.unbind(0), g, mv["m"].unbind(0), mv["v"].unbind(0)):
                _adam(ps, gs, ms, vs, b1c, b2c, cfg)
        else:
            _adam(p, g, mv["m"], mv["v"], b1c, b2c, cfg)

    with torch.no_grad():
        tree_map(upd, params, grads, state["mu"])
        state["count"] = count
    return params, state


def opt_state_specs(param_specs: Any, cfg: OptConfig, mesh) -> Any:
    """ShapeDtypeStructs for the optimizer state, mirroring param shardings.

    fp32 moments inherit the param sharding; int8 payloads are flat and get
    sharded across every mesh axis when the block count divides (ZeRO-style
    fully-sharded optimizer state), else replicated.
    """
    names = axis_names(mesh)
    ndev = math.prod(mesh_shape(mesh).values())

    def mk(ps):
        if cfg.quantized:
            flat = math.prod(ps.shape)
            nblk = -(-flat // QBLOCK)
            total = nblk * QBLOCK
            qspec = P(names) if total % (ndev * QBLOCK) == 0 else P()
            sspec = P(names) if nblk % ndev == 0 else P()

            def q8(shape):
                return Q8State(
                    q=ShapeDtypeStruct((total,), torch.int8, NamedSharding(mesh, qspec)),
                    scale=ShapeDtypeStruct((nblk,), torch.float32, NamedSharding(mesh, sspec)),
                    shape=tuple(shape),
                )

            return {"m": q8(ps.shape), "v": q8(ps.shape)}
        return {
            "m": ShapeDtypeStruct(ps.shape, torch.float32, ps.sharding),
            "v": ShapeDtypeStruct(ps.shape, torch.float32, ps.sharding),
        }

    return {
        "mu": tree_map(mk, param_specs),
        "count": ShapeDtypeStruct((), torch.int32, NamedSharding(mesh, P())),
    }


def opt_state_from_specs(specs: Any, *, device=None) -> Any:
    """Zero f32 moments and a zero count as DTensors laid out by
    ``opt_state_specs`` (each rank allocates its own blocks only)."""
    from torch.distributed.tensor import DTensor

    def zeros(s):
        if isinstance(s, Q8State):
            raise NotImplementedError("8-bit moments on a mesh: opt_state_specs gives "
                                      "their layout only")
        sh = s.sharding
        local = torch.zeros(sh.shard_shape(s.shape), dtype=s.dtype,
                            device=device or mesh_device(sh.mesh))
        return DTensor.from_local(local, sh.mesh, sh.placements, run_check=False,
                                  shape=s.shape, stride=contiguous_stride(s.shape))

    return tree_map(zeros, specs)
