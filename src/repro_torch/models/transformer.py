"""Decoder-only LM family: dense (GQA), MLA, and MoE variants.

The PyTorch counterpart of ``repro.models.transformer``.  One parameter
table (``param_table``: shapes, dtypes and partition specs) drives both
``init_params`` (real tensors) and ``param_specs`` (shapes and shardings on
a mesh); the parameters are a nested dict of tensors under the reference's names, with
the layers STACKED on a leading L dim (``params["dense"]["attn"]["wq"]`` is
(L, d, H, hd)), so that checkpoint keys and the weights carried over from
the reference map one to one.  :class:`LM` holds such a tree as an
``nn.Module``.

The forward pass unbinds every stacked parameter once (never ``p[i]`` per
layer: each ``select`` backward would allocate a zero tensor of the whole
stack) and recomputes each block in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).  The
train step takes its gradients with respect to the layer slices
themselves and updates the stacks slice by slice in place, so no
stacked gradient and no whole-stack f32 temporary is ever allocated.

Sharding strategy (single-pod mesh ("data", "model")), the reference's:
  * TP over "model": attention heads (or head_dim when heads don't divide),
    FFN hidden, vocab; experts over "model" (EP).
  * ZeRO-3/FSDP over "data": every large weight also shards a remaining
    dimension over "data".
  * batch over ("pod",)+"data" on the multi-pod mesh; "pod" is pure DP.
On DTensors (parameters placed by ``param_specs``, tokens by
``input_specs``) a step with ``dp_axes`` runs SPMD: each rank runs the
blocks on its batch shard with the layer's weights gathered one layer at a
time (ZeRO-3; a stack split over its layer dim is gathered layer by layer
inside the block, see ``unstack_leaf``), the MoE dispatch on every token
with the experts split over "model", and the gradients are reduced back
onto the parameters' shards.  The "model" axis stores heads, FFN columns
and vocab split but computes them whole: every rank of it runs the same
rows, and the head's logits are whole per row before the vocab constraint
slices them (tensor-parallel compute is not ported).  The same body runs
on plain tensors, where every constraint and ``local_call`` is a no-op and
the step is the one-device step.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig, ShapeSpec
from repro_torch.distributed.sharding import (P, LayerShard, NamedSharding, ShapeDtypeStruct,
                                              constrain, full, gather_layer, is_dtensor,
                                              leaf_tensor, local_call, mesh_shape,
                                              named_sharding, sanitize_spec, shift_placements,
                                              stack_slices, to_placements, unstack_leaf)
from repro_torch.models import layers as L
from repro_torch.optim import OptConfig, adamw_update
from repro_torch.tree import tree_leaves, tree_map

# ----------------------------------------------------------------------------
# Parameter definition table: {path: (shape, dtype, partition-spec)}
# ----------------------------------------------------------------------------

NORMS = ("ln1", "ln2", "final_norm", "q_norm", "kv_norm")
BIASES = ("bq", "bk", "bv")


def _fsdp(spec: tuple, shape: tuple, data_size: int, axes=("data",)) -> tuple:
    """Inserts the ZeRO axes at the first unsharded dim that divides.

    ``axes=("pod", "data")`` extends ZeRO-3 across pods (cross-pod weight
    gathers) — required for >100B-param models whose state exceeds one
    pod's memory even fully sharded within the pod."""
    spec = list(spec)
    entry = axes[0] if len(axes) == 1 else tuple(axes)
    for i, (s, sz) in enumerate(zip(spec, shape)):
        if s is None and sz % data_size == 0 and sz >= data_size:
            spec[i] = entry
            return tuple(spec)
    return tuple(spec)


def param_table(cfg: LMConfig, model_size: int = 1, data_size: int = 1,
                fsdp_axes=("data",)) -> Dict[str, tuple]:
    """Flat {path: (shape, dtype, spec)} table; layer leaves carry their
    leading stacked dim (spec entry None)."""
    d, V = cfg.d_model, cfg.vocab_padded
    H, Hkv, hd, f = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    dt = cfg.torch_dtype
    head_ok = H % model_size == 0
    kv_ok = Hkv % model_size == 0
    defs: Dict[str, tuple] = {
        "embed": ((V, d), dt, ("model", None)),
        "final_norm": ((d,), dt, (None,)),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ((d, V), dt, (None, "model"))

    def attn_defs(prefix: str):
        if cfg.mla:
            dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
            rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
            return {
                f"{prefix}.wq_a": ((d, rq), dt, (None, "model")),
                f"{prefix}.q_norm": ((rq,), dt, (None,)),
                f"{prefix}.wq_b": ((rq, H, dn + dr), dt, (None, "model", None)),
                f"{prefix}.wkv_a": ((d, rkv + dr), dt, (None, None)),
                f"{prefix}.kv_norm": ((rkv,), dt, (None,)),
                f"{prefix}.wk_b": ((rkv, H, dn), dt, (None, "model", None)),
                f"{prefix}.wv_b": ((rkv, H, dv), dt, (None, "model", None)),
                f"{prefix}.wo": ((H, dv, d), dt, ("model", None, None)),
            }
        qspec = (None, "model", None) if head_ok else (None, None, "model")
        kvspec = (None, "model", None) if kv_ok else (None, None, "model")
        out = {
            f"{prefix}.wq": ((d, H, hd), dt, qspec),
            f"{prefix}.wk": ((d, Hkv, hd), dt, kvspec),
            f"{prefix}.wv": ((d, Hkv, hd), dt, kvspec),
            f"{prefix}.wo": ((H, hd, d), dt,
                             ("model", None, None) if head_ok else (None, "model", None)),
        }
        if cfg.qkv_bias:
            out[f"{prefix}.bq"] = ((H, hd), dt, qspec[1:])
            out[f"{prefix}.bk"] = ((Hkv, hd), dt, kvspec[1:])
            out[f"{prefix}.bv"] = ((Hkv, hd), dt, kvspec[1:])
        return out

    def dense_ffn_defs(prefix: str):
        return {
            f"{prefix}.w1": ((d, f), dt, (None, "model")),
            f"{prefix}.w3": ((d, f), dt, (None, "model")),
            f"{prefix}.w2": ((f, d), dt, ("model", None)),
        }

    def moe_ffn_defs(prefix: str):
        E, fm = cfg.n_experts, cfg.moe_d_ff
        out = {
            f"{prefix}.router": ((d, E), torch.float32, (None, None)),
            f"{prefix}.we1": ((E, d, fm), dt, ("model", None, None)),
            f"{prefix}.we2": ((E, fm, d), dt, ("model", None, None)),
            f"{prefix}.we3": ((E, d, fm), dt, ("model", None, None)),
        }
        if cfg.n_shared:
            fs = cfg.n_shared * fm
            out[f"{prefix}.ws1"] = ((d, fs), dt, (None, "model"))
            out[f"{prefix}.ws3"] = ((d, fs), dt, (None, "model"))
            out[f"{prefix}.ws2"] = ((fs, d), dt, ("model", None))
        return out

    def block_defs(prefix: str, moe_block: bool):
        out = {f"{prefix}.ln1": ((d,), dt, (None,)), f"{prefix}.ln2": ((d,), dt, (None,))}
        out.update(attn_defs(f"{prefix}.attn"))
        out.update(moe_ffn_defs(f"{prefix}.ffn") if moe_block
                   else dense_ffn_defs(f"{prefix}.ffn"))
        return out

    n_dense, n_moe = layer_counts(cfg)
    if n_dense:
        for k, (shape, dtv, spec) in block_defs("dense", False).items():
            defs[k] = ((n_dense, *shape), dtv, (None, *spec))
    if n_moe:
        for k, (shape, dtv, spec) in block_defs("moe", True).items():
            defs[k] = ((n_moe, *shape), dtv, (None, *spec))
    # ZeRO-3 second-axis sharding on every big tensor
    out = {}
    for k, (shape, dtv, spec) in defs.items():
        if math.prod(shape) >= (1 << 20):
            spec = _fsdp(spec, shape, data_size, fsdp_axes)
        out[k] = (shape, dtv, spec)
    return out


def param_defs(cfg: LMConfig) -> Dict[str, tuple]:
    """Flat {path: (shape, dtype)} table (``param_table`` without specs)."""
    return {k: (shape, dt) for k, (shape, dt, _) in param_table(cfg).items()}


def layer_counts(cfg: LMConfig):
    """(dense layers, MoE layers): the two stacks, in execution order."""
    n_dense = cfg.first_dense_layers if cfg.moe else cfg.n_layers
    return n_dense, (cfg.n_layers - n_dense if cfg.moe else 0)


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split(".")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def param_specs(cfg: LMConfig, mesh) -> Any:
    """Nested {path: ShapeDtypeStruct} with each parameter's sharding on
    ``mesh`` (a ``DeviceMesh`` or an ``AbstractMesh``)."""
    shape = mesh_shape(mesh)
    msz = shape["model"]
    dsz = shape["data"]
    fsdp_axes = ("data",)
    if "pod" in shape and cfg.params_count() > 1e11:
        # cross-pod ZeRO: one pod cannot hold even the fully pod-sharded
        # state of a 671B model
        fsdp_axes = ("pod", "data")
        dsz = dsz * shape["pod"]
    defs = param_table(cfg, msz, dsz, fsdp_axes)
    flat = {k: ShapeDtypeStruct(shp, dt, named_sharding(mesh, shp, *spec))
            for k, (shp, dt, spec) in defs.items()}
    return _nest(flat)


def init_params(cfg: LMConfig, generator: torch.Generator, *, device=None) -> Dict[str, Any]:
    """The reference's distributions in its (sorted) order, drawn from
    ``generator`` on its device: norms one, biases zero, every other weight
    normal / sqrt(fan_in) drawn in f32 and cast.  JAX's threefry streams are
    not reproduced; weights to compare with the reference are carried over
    with :func:`repro_torch.convert.lm_params_from_numpy`."""
    device = generator.device if device is None else torch.device(device)
    flat = {}
    for name, (shape, dt) in sorted(param_defs(cfg).items()):
        if name.endswith(NORMS):
            flat[name] = torch.ones(shape, dtype=dt, device=device)
        elif name.endswith(BIASES):
            flat[name] = torch.zeros(shape, dtype=dt, device=device)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
            flat[name] = w.mul_(fan_in ** -0.5).to(dt)
            del w
    return _nest(flat)


# ----------------------------------------------------------------------------
# Layer stacks
# ----------------------------------------------------------------------------


def unstack(stacked: Dict[str, Any]) -> List[Dict[str, Any]]:
    """A stack's per-layer trees: every leaf unbound ONCE along dim 0 (a
    DTensor leaf as :func:`repro_torch.distributed.sharding.unstack_leaf`)."""
    slices = tree_map(unstack_leaf, stacked)
    n = len(tree_leaves(slices)[0])
    return [tree_map(lambda s, i=i: s[i], slices) for i in range(n)]


def stacks(tree) -> List[str]:
    """The layer stacks present in ``tree``, in execution order."""
    return [k for k in ("dense", "moe") if k in tree]


class LM(nn.Module):
    """An ``nn.Module`` over a parameter tree: the same tensors, registered
    under the reference's names (``dense.attn.wq`` is the checkpoint's
    ``params/dense/attn/wq``).  ``params()`` gives the tree back."""

    def __init__(self, cfg: LMConfig, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.tree = _Tree(params)

    def params(self) -> Dict[str, Any]:
        return self.tree.as_dict()

    def forward(self, tokens: torch.Tensor, **kw) -> torch.Tensor:
        return forward(self.cfg, self.params(), tokens, **kw)


class _Tree(nn.Module):
    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self._keys = sorted(tree)
        for k in self._keys:
            v = tree[k]
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def as_dict(self) -> Dict[str, Any]:
        return {k: (getattr(self, k).as_dict() if isinstance(getattr(self, k), _Tree)
                    else getattr(self, k)) for k in self._keys}


# ----------------------------------------------------------------------------
# Forward / loss / steps
# ----------------------------------------------------------------------------


def _constrain(x, dp_axes, ndim_tail: int, *, seq_shard: bool = False):
    """Residual-stream sharding constraint; a no-op when ``dp_axes`` is
    empty or ``x`` is a plain tensor.

    ``seq_shard`` = Megatron-style sequence parallelism: the (B, S, d)
    stream between blocks is additionally sharded over "model" on S, so the
    recomputed layer boundaries cost 1/TP of the memory."""
    if not dp_axes:
        return x
    if seq_shard and x.ndim >= 3:
        return constrain(x, P(dp_axes, "model", *([None] * (ndim_tail - 1))))
    return constrain(x, P(dp_axes, *([None] * ndim_tail)))


def _attn_half(cfg: LMConfig, p: dict, x, positions, kv_chunk):
    """(x + attention(rmsnorm(x)), the FFN's input rmsnorm of that)."""
    h = L.rmsnorm(x, p["ln1"])
    attn = L.mla_attention if cfg.mla else L.gqa_attention
    a, _ = attn(cfg, p["attn"], h, positions, kv_chunk=kv_chunk)
    x = x + a
    return x, L.rmsnorm(x, p["ln2"])


def _block(cfg: LMConfig, p: dict, x, kv_chunk, dp_axes=(), seq_shard=False):
    """One block.  Each rank runs its own rows with the layer's weights
    gathered (attention and a dense FFN read one sequence at a time); a
    layer of a split stack is gathered here, inside the recomputed block."""
    p = tree_map(gather_layer, p)
    moe = "router" in p["ffn"]
    act = P(dp_axes, None, None)
    half = {"attn": p["attn"], "ln1": p["ln1"], "ln2": p["ln2"]}

    def local(x, half, ffn=None):
        B, S = x.shape[:2]
        pos = torch.arange(S, device=x.device).expand(B, S)
        x, y = _attn_half(cfg, half, x, pos, kv_chunk)
        return (x, y) if ffn is None else x + L.swiglu(ffn, y)

    if moe:
        x, y = local_call(local, (x, half), (act, P()), (act, act))
        x = x + L.moe_ffn(cfg, p["ffn"], y, dp_axes)
    else:
        x = local_call(local, (x, half, p["ffn"]), (act, P(), P()), act)
    return _constrain(x, dp_axes, 2, seq_shard=seq_shard)


def _run_blocks(cfg, layers, x, kv_chunk, dp_axes=(), seq_shard=False):
    """Every block in turn, each recomputed in the backward pass when its
    gradients are being recorded."""
    for lp in layers:
        def fn(c, lp=lp):
            return _block(cfg, lp, c, kv_chunk, dp_axes, seq_shard)

        if torch.is_grad_enabled() and (x.requires_grad or any(
                leaf_tensor(t).requires_grad for t in tree_leaves(lp))):
            x = checkpoint(fn, x, use_reentrant=False)
        else:
            x = fn(x)
    return x


def _head(cfg, params, x):
    x = L.rmsnorm(x, params["final_norm"])
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    return torch.einsum("bsd,dv->bsv", x, head)


def forward(cfg: LMConfig, params: Any, tokens: torch.Tensor, *, dp_axes=("data",),
            kv_chunk: int = 1024, seq_shard: bool = False, last_only: bool = False,
            layers: Optional[Dict[str, list]] = None) -> torch.Tensor:
    """Training/eval forward → logits (B, S, V); (B, 1, V) if last_only.

    ``layers``: the stacks already unbound ({stack: [layer tree, ...]}),
    as the train step passes its slices (``params`` then needs only the
    embedding, final norm and head); by default unbound here.  Tokens as a
    DTensor (placed by ``input_specs``) run SPMD over ``dp_axes``."""
    if layers is None:
        layers = {k: unstack(params[k]) for k in stacks(params)}
    act = P(dp_axes, None, None)
    head = {k: params[k] for k in ("final_norm", "lm_head") if k in params}
    if "lm_head" not in head:
        head["embed"] = params["embed"]
    # on DTensors the table's rows are split over "model" (and a column
    # block over the ZeRO axes) and a lookup reads any row: gathered
    x = local_call(lambda t, e: F.embedding(t, e).to(cfg.torch_dtype),
                   (tokens, params["embed"]), (P(dp_axes, None), P()), act)
    x = _constrain(x, dp_axes, 2, seq_shard=seq_shard)
    for name in stacks(layers):
        x = _run_blocks(cfg, layers[name], x, kv_chunk, dp_axes, seq_shard)

    def finish(x, head):
        return _head(cfg, head, x[:, -1:] if last_only else x)

    logits = local_call(finish, (x, head), (act, P()), act)
    if dp_axes:
        # the reference's layout (vocab over "model"); each rank computed its
        # rows' logits over the whole vocab, so on a mesh this slices them
        # and the loss gathers them again (tensor-parallel compute is not
        # ported)
        logits = constrain(logits, P(dp_axes, None, "model"))
    return logits


def _xent(cfg: LMConfig, logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per-position next-token cross-entropy (B, S-1), the pad columns of
    ``vocab_padded`` masked out of the softmax."""
    logits = logits[:, :-1].float()
    if cfg.vocab_padded != cfg.vocab:
        col = torch.arange(cfg.vocab_padded, device=logits.device)
        logits = torch.where(col < cfg.vocab, logits, float("-inf"))
    labels = tokens[:, 1:].long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    return lse - picked


def loss_fn(cfg: LMConfig, params: Any, tokens: torch.Tensor, kv_chunk: int = 1024,
            layers: Optional[Dict[str, list]] = None, *, dp_axes=("data",),
            seq_shard: bool = False) -> torch.Tensor:
    """Causal next-token cross-entropy (mean over B·(S-1))."""
    logits = forward(cfg, params, tokens, dp_axes=dp_axes, kv_chunk=kv_chunk,
                     seq_shard=seq_shard, layers=layers)
    # each rank's rows: its mean, weighted by its share of the rows (the
    # whole batch: the mean itself; the softmax reads the whole vocab row,
    # so the vocab shards are gathered)
    B = tokens.shape[0]
    part = local_call(lambda lg, tok: _xent(cfg, lg, tok).mean() * (tok.shape[0] / B),
                      (logits, tokens), (P(dp_axes, None, None), P(dp_axes, None)), P(),
                      partial=tuple(dp_axes))
    return full(part)


def loss_and_grads(cfg: LMConfig, params: Any, tokens: torch.Tensor, *,
                   kv_chunk: int = 1024, stacked: bool = True, dp_axes=("data",),
                   seq_shard: bool = False):
    """Loss and gradients of one batch, in the params' tree.

    The gradients are taken with respect to detached leaves: each leaf
    outside the stacks, and each layer slice of a stack (a view of it).  So
    a stacked leaf's gradient comes as its per-layer slices: a list with
    ``stacked=False`` (what the train step consumes), stacked like the
    parameter with ``stacked=True``.  On DTensors each gradient has its
    leaf's placements (a stack's slices the stack's, less its layer dim);
    a stack split over its layer dim has its gradient stacked like it
    either way, each rank's block from the layers it holds."""

    def leaf(t):
        if isinstance(t, LayerShard):
            return t.with_local(t.local.detach().requires_grad_())
        return t.detach().requires_grad_()

    def grad_of(t, flat):
        g = next(flat)
        return t.with_local(g) if isinstance(t, LayerShard) else g

    top = {k: leaf(v) for k, v in params.items() if k not in ("dense", "moe")}
    layers = {k: [tree_map(leaf, lp) for lp in unstack(params[k])] for k in stacks(params)}
    targets = [top] + [lp for k in stacks(layers) for lp in layers[k]]
    with torch.enable_grad():
        loss = loss_fn(cfg, top, tokens, kv_chunk, layers=layers, dp_axes=dp_axes,
                       seq_shard=seq_shard)
        flat = iter(torch.autograd.grad(
            loss, [leaf_tensor(t) for tr in targets for t in tree_leaves(tr)]))
    grads = tree_map(lambda t: grad_of(t, flat), top)
    for k in stacks(layers):
        per_layer = [tree_map(lambda t: grad_of(t, flat), lp) for lp in layers[k]]
        grads[k] = tree_map(
            lambda *gs: _stack(gs) if stacked or isinstance(gs[0], LayerShard) else list(gs),
            *per_layer)
    return loss.detach(), grads


def _stack(gs):
    return stack_slices(gs) if isinstance(gs[0], LayerShard) or is_dtensor(gs[0]) \
        else torch.stack(gs)


def _gshard(grads, shardings, params):
    """Each gradient laid out like its parameter: constrained to
    ``shardings`` (the reference's ``param_shardings``) where given, else
    to the DTensor parameter's own placements (a gradient may hold partial
    sums until then).  A stack's per-layer list stays a list (the optimizer
    updates it slice by slice); a stack split over its layer dim has its
    gradient stacked already (``loss_and_grads``)."""
    if shardings is None:
        if not any(is_dtensor(t) for t in tree_leaves(params)):
            return grads
        shardings = params

    def one(g, sh):
        sh = sh.sharding if isinstance(sh, ShapeDtypeStruct) else sh
        pl = tuple(sh.placements)
        if isinstance(g, list):
            return [to_placements(s, shift_placements(pl, -1)) for s in g]
        return to_placements(g, pl)

    return tree_map(one, grads, shardings)


def make_train_step(cfg: LMConfig, opt_cfg: OptConfig, dp_axes=("data",),
                    kv_chunk: int = 1024, grad_accum: int = 1, seq_shard: bool = False,
                    param_shardings=None):
    """One optimizer step: ``train_step(params, opt_state, tokens) ->
    (params, opt_state, loss)``, the parameters and moments updated in place.

    ``grad_accum`` splits the batch into sequential microbatches (activation
    memory ∝ 1/grad_accum); their gradients are summed in the parameters'
    dtype and divided, as the reference's scan does.  ``param_shardings``
    (a tree of ``NamedSharding``s or ``param_specs``' structs) constrains
    the gradients to the parameters' shardings, as the reference constrains
    its accumulated gradients; on DTensors the moments must be laid out
    like the parameters (``opt_state_specs``)."""

    def grads_of(params, tok):
        return loss_and_grads(cfg, params, tok, kv_chunk=kv_chunk, stacked=False,
                              dp_axes=dp_axes, seq_shard=seq_shard)

    def train_step(params, opt_state, tokens):
        if grad_accum == 1:
            loss, grads = grads_of(params, tokens)
        else:
            B = tokens.shape[0]
            if B % grad_accum:
                raise ValueError(f"batch {B} does not split into {grad_accum} microbatches")
            if is_dtensor(tokens):
                raise NotImplementedError("grad_accum on DTensor tokens: split the batch "
                                          "before placing it")
            micro = tokens.reshape(grad_accum, B // grad_accum, tokens.shape[1])
            loss, grads = None, None
            for mtok in micro:
                l, g = grads_of(params, mtok)
                g = _gshard(g, param_shardings, params)
                if grads is None:
                    loss, grads = l, g
                else:
                    loss = loss + l
                    grads = tree_map(_add, grads, g)
            loss = loss / grad_accum
            grads = tree_map(lambda g: _scale(g, grad_accum), grads)
        grads = _gshard(grads, param_shardings, params)
        params, opt_state = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, loss

    return train_step


def _add(a, b):
    if isinstance(a, list):
        return [x.add_(y) for x, y in zip(a, b)]
    return a.add_(b)


def _scale(g, n):
    if isinstance(g, list):
        return [x.div_(n) for x in g]
    return g.div_(n)


# ---- serving -----------------------------------------------------------------


def init_caches(cfg: LMConfig, batch: int, smax: int, *, device="cuda") -> Dict[str, Any]:
    """Zero KV caches for ``make_decode_step``, stacked per layer stack:
    (L, B, Smax, Hkv, hd) keys and values (int8 with (…, 1) bf16 scales
    under ``kv_quant_int8``), or the (L, B, Smax, kv_lora + rope) MLA
    latent."""
    dt = cfg.torch_dtype

    def stack_cache(nl):
        if cfg.mla:
            lat = cfg.kv_lora_rank + cfg.qk_rope_head_dim
            return torch.zeros((nl, batch, smax, lat), dtype=dt, device=device)
        kv = (nl, batch, smax, cfg.n_kv_heads, cfg.hd)
        if cfg.kv_quant_int8:
            sc = (nl, batch, smax, cfg.n_kv_heads, 1)
            return (torch.zeros(kv, dtype=torch.int8, device=device),
                    torch.zeros(sc, dtype=torch.bfloat16, device=device),
                    torch.zeros(kv, dtype=torch.int8, device=device),
                    torch.zeros(sc, dtype=torch.bfloat16, device=device))
        return (torch.zeros(kv, dtype=dt, device=device),
                torch.zeros(kv, dtype=dt, device=device))

    n_dense, n_moe = layer_counts(cfg)
    out = {}
    if n_dense:
        out["dense"] = stack_cache(n_dense)
    if n_moe:
        out["moe"] = stack_cache(n_moe)
    return out


def make_decode_step(cfg: LMConfig):
    """One-token decode against a (B, Smax) cache at position ``cache_len``:
    ``decode_step(params, caches, tokens, cache_len) -> (logits (B, V),
    caches)``, the caches written in place.  The step takes plain tensors
    only: the sharded decode is not ported (``_cache_specs`` gives the
    sharded caches' layout)."""

    @torch.no_grad()
    def decode_step(params, caches, tokens, cache_len):
        if is_dtensor(tokens) or any(is_dtensor(t) for t in tree_leaves(params)):
            raise ValueError("the decode step writes its caches in place and takes plain "
                             "tensors; gather DTensor parameters and tokens first")
        B = tokens.shape[0]
        cache_len = int(cache_len)
        positions = torch.full((B, 1), cache_len, dtype=torch.long, device=tokens.device)
        x = F.embedding(tokens[:, None], params["embed"]).to(cfg.torch_dtype)
        attn = L.mla_attention if cfg.mla else L.gqa_attention
        for name in stacks(params):
            cache = caches[name]
            per_layer = (cache.unbind(0) if cfg.mla
                         else list(zip(*(c.unbind(0) for c in cache))))
            for lp, lc in zip(unstack(params[name]), per_layer):
                h = L.rmsnorm(x, lp["ln1"])
                a, _ = attn(cfg, lp["attn"], h, positions, kv_cache=lc, cache_len=cache_len)
                x2 = x + a
                y = L.rmsnorm(x2, lp["ln2"])
                ffn = (L.moe_ffn(cfg, lp["ffn"], y) if "router" in lp["ffn"]
                       else L.swiglu(lp["ffn"], y))
                x = x2 + ffn
        logits = _head(cfg, params, x)
        return logits[:, 0], caches

    return decode_step


def make_prefill_step(cfg: LMConfig, dp_axes=("data",), kv_chunk: int = 1024,
                      seq_shard: bool = False, batch_chunks: int = 1):
    """Full-sequence prefill → last-token logits (B, V) (the cache write is
    elided, as in the reference).  ``batch_chunks`` runs the batch in
    sequential chunks, bounding the working set; DTensor tokens run SPMD
    over ``dp_axes`` in one chunk."""

    @torch.no_grad()
    def prefill_step(params, tokens):
        B = tokens.shape[0]
        if B % batch_chunks:
            raise ValueError(f"batch {B} does not split into {batch_chunks} chunks")
        if is_dtensor(tokens):
            if batch_chunks != 1:
                raise NotImplementedError("batch_chunks on DTensor tokens")
            lg = forward(cfg, params, tokens, dp_axes=dp_axes, kv_chunk=kv_chunk,
                         seq_shard=seq_shard, last_only=True)
            sp = sanitize_spec(lg.device_mesh, lg.shape, (dp_axes, None, "model"))
            return local_call(lambda t: t[:, 0], (lg,), (sp,), P(sp[0], sp[2]))
        outs = [forward(cfg, params, t, dp_axes=dp_axes, kv_chunk=kv_chunk,
                        seq_shard=seq_shard, last_only=True)[:, 0]
                for t in tokens.chunk(batch_chunks)]
        return torch.cat(outs, 0)

    return prefill_step



def _cache_specs(cfg: LMConfig, mesh, batch: int, smax: int, dp_axes):
    """KV cache ShapeDtypeStructs (per decode cell), in ``init_caches``'
    layout."""
    n_dense, n_moe = layer_counts(cfg)
    msz = mesh_shape(mesh)["model"]

    def mk(shape, dt, spec):
        return ShapeDtypeStruct(shape, dt, named_sharding(mesh, shape, *spec))

    def stack_cache(nl):
        if cfg.mla:
            lat = cfg.kv_lora_rank + cfg.qk_rope_head_dim
            spec = (None, dp_axes, None, "model" if lat % msz == 0 else None)
            return mk((nl, batch, smax, lat), cfg.torch_dtype, spec)
        hv = cfg.n_kv_heads
        hspec = "model" if hv % msz == 0 else None
        dspec = None if hspec == "model" else ("model" if cfg.hd % msz == 0 else None)
        kvspec = (None, dp_axes, None, hspec, dspec)
        # scales: bf16, sequence-sharded over "model" (heads rarely divide)
        sspec = (None, dp_axes, "model" if hspec is None else None, hspec, None)
        kv = (nl, batch, smax, hv, cfg.hd)
        if cfg.kv_quant_int8:
            sc = (nl, batch, smax, hv, 1)
            return (mk(kv, torch.int8, kvspec), mk(sc, torch.bfloat16, sspec),
                    mk(kv, torch.int8, kvspec), mk(sc, torch.bfloat16, sspec))
        return (mk(kv, cfg.torch_dtype, kvspec), mk(kv, cfg.torch_dtype, kvspec))

    out = {}
    if n_dense:
        out["dense"] = stack_cache(n_dense)
    if n_moe:
        out["moe"] = stack_cache(n_moe)
    return out


def input_specs(cfg: LMConfig, shape: ShapeSpec, mesh, dp_axes=("data",)):
    """ShapeDtypeStructs for one LM cell (tokens / caches / cache_len)."""
    bspec = named_sharding(mesh, (shape.global_batch, max(shape.seq_len, 1)), dp_axes, None)
    rep = NamedSharding(mesh, P())
    if shape.kind in ("train", "prefill"):
        return {"tokens": ShapeDtypeStruct((shape.global_batch, shape.seq_len), torch.int32,
                                           bspec)}
    if shape.kind == "decode":
        return {
            "tokens": ShapeDtypeStruct((shape.global_batch,), torch.int32,
                                       named_sharding(mesh, (shape.global_batch,), dp_axes)),
            "caches": _cache_specs(cfg, mesh, shape.global_batch, shape.seq_len, dp_axes),
            "cache_len": ShapeDtypeStruct((), torch.int32, rep),
        }
    raise ValueError(shape.kind)
