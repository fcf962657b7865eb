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

On a mesh the 8-bit payloads are flat and split over every mesh axis
(``opt_state_specs``): each rank's parameter and gradient blocks are
exchanged into the flat ranges of the payload blocks it holds (one
all-to-all over the mesh), updated there, and exchanged back (see
:class:`_FlatLayout`).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, List, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import (P, NamedSharding, ShapeDtypeStruct, axes_index,
                                              axis_names, contiguous_stride, is_dtensor,
                                              mesh_shape, shift_placements, stack_slices)
from repro_torch.knobs import sync_free
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
    x = _dequant(st.q, st.scale)
    x = x[:math.prod(st.shape)].reshape(st.shape)
    return x.square() if sqrt_scale else x


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Flat f32 values of whole blocks: payload times block scale / 127."""
    # 127 as a tensor on the payload's device: CUDA divides by a Python
    # scalar through its reciprocal, one rounding away from the CPU's (and
    # the reference's) division
    d127 = torch.full((), 127.0, device=q.device)
    return (q.float().reshape(-1, QBLOCK) * scale[:, None] / d127).reshape(-1)


def _sqrt_(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root of ``x`` (the reference's),
    in place on the card (the callers pass temporaries).  The card's f32
    ``sqrt`` is correctly rounded; PyTorch's vectorized one on the CPU is
    one ulp off for some inputs, so there it is taken in f64 and rounded
    once, which is exact since f64 holds more than 2·24 + 2 bits."""
    if x.is_cuda:
        return x.sqrt_()
    return x.double().sqrt_().float()


def _quant(flat: torch.Tensor):
    """Flat f32 values of whole blocks → (int8 payload, f32 block absmax)."""
    blk = flat.reshape(-1, QBLOCK)
    scale = torch.clamp(blk.abs().amax(1), min=1e-12)
    q = torch.clamp(torch.round(blk / scale[:, None] * 127.0), -127, 127).to(torch.int8)
    return q.reshape(-1), scale


def _q8_write(st: Q8State, x: torch.Tensor, *, sqrt_scale: bool = False) -> Q8State:
    """sqrt_scale stores sqrt(x) (x >= 0): a quadratic quantization map.

    Linear int8 under-flows Adam's tiny second moments to exactly 0, which
    explodes m/(sqrt(v)+eps); the quadratic map keeps the smallest nonzero
    representable value at (blockmax/127²) instead of blockmax/127.
    """
    flat = x.reshape(-1).float()
    if sqrt_scale:
        flat = _sqrt_(torch.clamp(flat, min=0.0))
    flat = torch.nn.functional.pad(flat, (0, st.q.shape[0] - flat.shape[0]))
    q, scale = _quant(flat)
    return Q8State(q=q, scale=scale, shape=st.shape)


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
    step = (m / b1c).div_(_sqrt_(v / b2c).add_(cfg.eps))
    p32 = p.float()
    step.add_(p32, alpha=cfg.weight_decay)
    p.copy_(p32.sub_(step, alpha=cfg.lr))


def _local(t, want: tuple, what: str):
    """A DTensor's local block, checked to lie as ``want`` says (the update
    is elementwise, so each rank's blocks of p, g, m and v must line up)."""
    if tuple(t.placements) != want:
        raise ValueError(f"{what} placed {tuple(t.placements)}, its parameter {want}")
    return t.to_local()


def bias_corrections(count: torch.Tensor, cfg: OptConfig):
    """``1 - b1**count`` and ``1 - b2**count`` in f32 for an int32 step
    count on any device.

    The power of the f32 beta is taken in f64 and rounded once to f32: the
    correctly rounded f32 power, the same on the card and the CPU.  An f32
    ``pow`` is not correctly rounded: CUDA's differs from the CPU's at some
    counts, and the CPU's (= the reference's) is one ulp off at a few (for
    b = 0.999 at counts 2958 and 3606 of the first 20,000)."""
    c = count.double()

    def corr(b):
        return 1.0 - torch.pow(float(np.float32(b)), c).float()

    return corr(cfg.b1), corr(cfg.b2)


@sync_free
def adamw_update(params: Any, grads: Any, state: Any, cfg: OptConfig):
    """One AdamW step → (params, state), both updated in place.

    A gradient may be the list of a stacked parameter's layer slices.  On
    DTensors laid out alike (parameters by ``param_specs``, moments by
    ``opt_state_specs``, gradients constrained to the parameters' shardings)
    each rank updates its own blocks, with the same arithmetic."""
    count = state["count"] + 1
    b1c, b2c = bias_corrections(count.to_local() if is_dtensor(count) else count, cfg)

    def upd(p, g, mv):
        if is_dtensor(p) and cfg.quantized:
            _q8_update_sharded(p, g, mv, b1c, b2c, cfg)
            return
        if is_dtensor(p):
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


def _q8_update_sharded(p, g, mv, b1c, b2c, cfg: OptConfig) -> None:
    """The 8-bit update of a DTensor parameter against payloads laid out
    by ``opt_state_specs``, in place: on payloads split over the mesh each
    rank updates the flat blocks it holds (its parameter and gradient
    values brought there and back by :class:`_FlatLayout`); on replicated
    payloads every rank updates the whole parameter, gathered, and keeps
    its block."""
    if isinstance(g, list):
        g = stack_slices(g)
    if tuple(g.placements) != tuple(p.placements):
        raise ValueError(f"a gradient placed {tuple(g.placements)}, its parameter "
                         f"{tuple(p.placements)}")
    m, v = mv["m"], mv["v"]
    if not any(pl.is_shard() for pl in m.q.placements):
        whole = {k: Q8State(st.q.to_local(), st.scale.to_local(), st.shape)
                 for k, st in (("m", m), ("v", v))}
        pw, gw = p.full_tensor(), g.full_tensor()
        mw = _q8_read(whole["m"])
        vw = _q8_read(whole["v"], sqrt_scale=True)
        _adam(pw, gw, mw, vw, b1c, b2c, cfg)
        for st, new in ((m, _q8_write(whole["m"], mw)),
                        (v, _q8_write(whole["v"], vw, sqrt_scale=True))):
            st.q.to_local().copy_(new.q)
            st.scale.to_local().copy_(new.scale)
        lay = _FlatLayout(p, m.q.shape[0])
        lo, size = lay.boxes[lay.me]
        p.to_local().copy_(pw[tuple(slice(a, a + n) for a, n in zip(lo, size))])
        return
    lay = _FlatLayout(p, m.q.shape[0])
    pf = lay.to_flat(p.to_local())
    gf = lay.to_flat(g.to_local())
    mf = _dequant(m.q.to_local(), m.scale.to_local())
    vf = _dequant(v.q.to_local(), v.scale.to_local()).square()
    _adam(pf, gf, mf, vf, b1c, b2c, cfg)
    for st, x in ((m, mf), (v, _sqrt_(torch.clamp(vf, min=0.0)))):
        q, scale = _quant(x)
        st.q.to_local().copy_(q)
        st.scale.to_local().copy_(scale)
    lay.from_flat(pf, p.to_local())


def _box(shape, pl, coord, sizes) -> Tuple[List[int], List[int]]:
    """(first index, length) along each dim of the block a mesh position
    holds (dims split evenly, nested in mesh-dim order)."""
    lo, size = [0] * len(shape), list(shape)
    for j, p in enumerate(pl):
        if p.is_shard():
            size[p.dim] //= sizes[j]
            lo[p.dim] += coord[j] * size[p.dim]
    return lo, size


def _count_below(shape, lo, size, x: int) -> int:
    """How many elements of the block (``lo``, ``size``) of a ``shape``
    array have a row-major flat index below ``x``."""
    if x <= 0 or not shape:
        return 0 if x <= 0 else 1
    stride = math.prod(shape[1:])
    row = x // stride
    out = min(max(row - lo[0], 0), size[0]) * math.prod(size[1:])
    if lo[0] <= row < lo[0] + size[0] and len(shape) > 1:
        out += _count_below(shape[1:], lo[1:], size[1:], x - row * stride)
    return out


def _flat_index(shape, lo, size, k0: int, k1: int, device) -> torch.Tensor:
    """Flat indices in the ``shape`` array of the block's elements ``k0``
    to ``k1 - 1`` in its own row-major order."""
    k = torch.arange(k0, k1, device=device, dtype=torch.long)
    f = torch.zeros_like(k)
    for d, stride in reversed(list(enumerate(contiguous_stride(shape)))):
        f += (k % size[d] + lo[d]) * stride
        k = k // size[d]
    return f


class _FlatLayout:
    """A DTensor parameter's blocks against its 8-bit payload's flat layout:
    the payload (``total`` values, the flat parameter padded to whole
    blocks) split evenly over every mesh position in row-major order, so
    position ``r`` holds flat indices ``[r·C, (r+1)·C)``.

    A block's elements in row-major order have rising flat indices, so each
    block meets each range in one run.  ``to_flat`` sends each block (from
    the first of the positions that hold a copy) to the ranges it meets;
    ``from_flat`` sends each range back to every position whose block it
    meets.  Each is one ``all_to_all_single`` over the mesh, its sizes
    counted on the host from the shapes alone."""

    def __init__(self, t, total: int):
        mesh = t.device_mesh
        self.shape = tuple(t.shape)
        self.n = math.prod(self.shape)
        sizes = tuple(mesh.mesh.shape)
        pl = tuple(t.placements)
        coords = list(itertools.product(*(range(s) for s in sizes)))
        self.boxes = [_box(self.shape, pl, c, sizes) for c in coords]
        self.owner = [all(c[j] == 0 for j, p in enumerate(pl) if not p.is_shard())
                      for c in coords]
        self.me = axes_index(mesh, mesh.mesh_dim_names)
        self.chunk = total // len(coords)
        self.mesh = mesh

    def _meet(self, s: int, r: int) -> Tuple[int, int]:
        """(first, end) ordinals of block ``s``'s elements in range ``r``."""
        lo, size = self.boxes[s]
        c = self.chunk
        return (_count_below(self.shape, lo, size, r * c),
                _count_below(self.shape, lo, size, (r + 1) * c))

    def _all_to_all(self, send: torch.Tensor, send_counts, recv_counts) -> torch.Tensor:
        import torch.distributed._functional_collectives as fc

        group = self.mesh._flatten().get_group() if self.mesh.ndim > 1 else self.mesh.get_group()
        out = fc.all_to_all_single(send.contiguous(), list(recv_counts), list(send_counts),
                                   group)
        return fc.wait_tensor(out)

    def to_flat(self, local: torch.Tensor) -> torch.Tensor:
        """This position's flat range of the parameter (zeros past its end)."""
        ranks = range(len(self.boxes))
        me = self.me
        send = [(lambda a, b: b - a)(*self._meet(me, r)) if self.owner[me] else 0 for r in ranks]
        meets = [self._meet(s, me) if self.owner[s] else (0, 0) for s in ranks]
        out = self._all_to_all(local.reshape(-1) if self.owner[me] else local.new_empty(0),
                               send, [b - a for a, b in meets])
        piece = local.new_zeros(self.chunk)
        idx = [_flat_index(self.shape, *self.boxes[s], a, b, local.device)
               for s, (a, b) in enumerate(meets) if b > a]
        if idx:
            piece[torch.cat(idx) - me * self.chunk] = out
        return piece

    def from_flat(self, piece: torch.Tensor, local: torch.Tensor) -> None:
        """This position's block of the parameter, written from the flat
        ranges: the inverse of ``to_flat``."""
        ranks = range(len(self.boxes))
        me = self.me
        meets = [self._meet(s, me) for s in ranks]
        idx = [_flat_index(self.shape, *self.boxes[s], a, b, piece.device) - me * self.chunk
               for s, (a, b) in enumerate(meets)]
        out = self._all_to_all(piece[torch.cat(idx)], [b - a for a, b in meets],
                               [(lambda a, b: b - a)(*self._meet(me, r)) for r in ranks])
        local.copy_(out.reshape(local.shape))


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
