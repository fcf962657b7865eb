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
blocks on its batch shard with the layer's weights gathered over the ZeRO
axes one layer at a time (a stack split over its layer dim is gathered
layer by layer inside the block, see ``unstack_leaf``), and
tensor-parallel over "model": its query heads (their KV heads, or K and V
whole where the KV heads do not split; its block of the query positions
where the query heads do not split either), its FFN and shared-expert
columns, MLA's head-split projections (the latent computed or gathered
whole), its vocab columns of the embedding and the head, with the
cross-entropy taken over the vocab shards.  Row-split projections leave
each rank a term of a sum, reduced onto the residual stream (a
reduce-scatter over S with ``seq_shard``).  The MoE dispatch runs on every
token with the experts split over "model"; the gradients are reduced back
onto the parameters' shards.  ``grad_accum`` and ``batch_chunks`` cut the
reference's global rows, and the decode step writes each rank's block of
the caches in place (``make_decode_step``).  The same body runs on plain
tensors, where every constraint and ``local_call`` is a no-op and the step
is the one-device step; on a (1, 1) mesh it is that step bit for bit.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig, ShapeSpec
from repro_torch.knobs import sync_free
from repro_torch.distributed.sharding import (P, LayerShard, NamedSharding, ShapeDtypeStruct,
                                              constrain, full, gather_layer, is_dtensor,
                                              is_split, leaf_tensor, local_call, mesh_shape,
                                              model_index, model_size, model_spec,
                                              named_sharding, sanitize_spec, shift_placements,
                                              spec_of, stack_slices, to_placements,
                                              unstack_leaf, zeros_from_struct)
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
    empty or ``x`` is a plain tensor.  A term of a sum over "model" (an
    attention or FFN output) is reduced here: an all-reduce, or with
    ``seq_shard`` a reduce-scatter over S.

    ``seq_shard`` = Megatron-style sequence parallelism: the (B, S, d)
    stream between blocks is additionally sharded over "model" on S, so the
    recomputed layer boundaries cost 1/TP of the memory."""
    if not dp_axes:
        return x
    if seq_shard and x.ndim >= 3:
        return constrain(x, P(dp_axes, "model", *([None] * (ndim_tail - 1))))
    return constrain(x, P(dp_axes, *([None] * ndim_tail)))


# the dims of each weight that tensor-parallel compute keeps split over
# "model" (heads, head_dim of the output projection, FFN columns or rows);
# any other split of a weight is gathered where it is used
_TP_DIMS = {"wq": (1,), "wk": (1,), "wv": (1,), "bq": (0,), "bk": (0,), "bv": (0,),
            "wq_a": (1,), "wq_b": (1,), "wk_b": (1,), "wv_b": (1,), "wo": (0, 1),
            "w1": (1,), "w3": (1,), "w2": (0,)}


def _tp_specs(p: dict, whole=()) -> dict:
    """``local_call`` in-specs of a layer's weights: each keeps its split
    over "model" on its ``_TP_DIMS`` (the keys in ``whole`` none)."""
    return {k: P() if k in whole else model_spec(v, _TP_DIMS.get(k, ()))
            for k, v in p.items()}


def _tp(spec) -> tuple:
    """The ``partial`` axes of a piece whose last projection is laid out by
    ``spec``: "model" when it is split there (each rank's term of a sum)."""
    return ("model",) if is_split(spec) else ()


def _positions(h):
    B, S = h.shape[:2]
    return torch.arange(S, device=h.device).expand(B, S)


def _attention(cfg: LMConfig, p: dict, x, kv_chunk, act):
    """The attention of a block, tensor-parallel over "model": each rank's
    heads (its term of the sum over "model" where ``wo`` is split).  Where
    the query heads do not split over "model" (their head_dim does), each
    rank takes its block of the query positions instead, against every key,
    and its rows of the output.  MLA's ``x @ wq_a`` runs on the column
    shards and is gathered, as ``q_norm`` reads the whole latent."""
    attn = p["attn"]
    specs = _tp_specs(attn)
    tp = _tp(specs["wo"])
    if not cfg.mla:
        j, m = model_index(x), model_size(x)
        S = x.shape[1]
        if m > 1 and not is_split(specs["wq"]) and S % m == 0:
            rows = slice(j * (S // m), (j + 1) * (S // m))

            def by_rows(x, ln, w):
                h = L.rmsnorm(x, ln)
                return L.gqa_attention(cfg, w, h, _positions(h), kv_chunk=kv_chunk,
                                       q_rows=rows)[0]

            return local_call(by_rows, (x, p["ln1"], attn), (act, P(), _tp_specs(attn, attn)),
                              P(act[0], "model", None))

        def local(x, ln, w):
            h = L.rmsnorm(x, ln)
            return L.gqa_attention(cfg, w, h, _positions(h), kv_chunk=kv_chunk, shard=j)[0]

        return local_call(local, (x, p["ln1"], attn), (act, P(), specs), act, partial=tp)

    cq = _mla_cq(x, p, specs["wq_a"], act)
    rest = {k: v for k, v in attn.items() if k != "wq_a"}

    def local(x, ln, cq, w):
        h = L.rmsnorm(x, ln)
        return L.mla_attention(cfg, w, h, _positions(h), kv_chunk=kv_chunk, cq=cq)[0]

    return local_call(local, (x, p["ln1"], cq, rest),
                      (act, P(), act, {k: specs[k] for k in rest}), act, partial=tp)


def _mla_cq(x, p: dict, spec, act):
    """``rmsnorm(x) @ wq_a`` on the column shards of "model", gathered."""
    cq = local_call(lambda x, ln, w: torch.einsum("bsd,dr->bsr", L.rmsnorm(x, ln), w),
                    (x, p["ln1"], p["attn"]["wq_a"]), (act, P(), spec),
                    P(act[0], *([None] * (len(act) - 2)), "model" if is_split(spec) else None))
    return constrain(cq, act)


def _ffn(cfg: LMConfig, p: dict, x, dp_axes, act):
    """The FFN of a block on rmsnorm(x): a dense SwiGLU column-split (w1,
    w3) and row-split (w2) over "model", each rank's term of the sum; an MoE
    layer through ``moe_ffn`` (experts over "model")."""
    if "router" in p["ffn"]:
        y = local_call(L.rmsnorm, (x, p["ln2"]), (act, P()), act)
        return L.moe_ffn(cfg, p["ffn"], y, dp_axes)
    specs = _tp_specs(p["ffn"])
    return local_call(lambda x, ln, w: L.swiglu(w, L.rmsnorm(x, ln)), (x, p["ln2"], p["ffn"]),
                      (act, P(), specs), act, partial=_tp(specs["w2"]))


def _block(cfg: LMConfig, p: dict, x, kv_chunk, dp_axes=(), seq_shard=False):
    """One block.  Each rank runs its own rows and, within them, its shard
    of the heads and FFN columns; the terms are reduced onto the residual
    stream.  A layer of a split stack is gathered here, inside the
    recomputed block."""
    p = tree_map(gather_layer, p)
    act = P(dp_axes, None, None)
    x = x + _constrain(_attention(cfg, p, x, kv_chunk, act), dp_axes, 2, seq_shard=seq_shard)
    x = x + _constrain(_ffn(cfg, p, x, dp_axes, act), dp_axes, 2, seq_shard=seq_shard)
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


def _embed(cfg: LMConfig, embed, tokens, dp_axes):
    """Token ids (B, S) or (B,) → (B, S or 1, d) on the batch rows.  The
    table's rows are split over "model": each rank reads the ids it holds
    (zeros elsewhere) and the terms are summed, exactly."""
    spec = model_spec(embed, (0,))
    V = embed.shape[0]
    j = model_index(embed)

    def look(t, e):
        t = t.reshape(t.shape[0], -1)
        if e.shape[0] == V:
            return F.embedding(t, e).to(cfg.torch_dtype)
        loc = t - j * e.shape[0]
        hit = (loc >= 0) & (loc < e.shape[0])
        x = F.embedding(torch.where(hit, loc, 0), e)
        return (x * hit[..., None].to(x.dtype)).to(cfg.torch_dtype)

    act = P(dp_axes, None, None)
    x = local_call(look, (tokens, embed), (P(dp_axes, *([None] * (tokens.ndim - 1))), spec),
                   act, partial=_tp(spec))
    return _constrain(x, dp_axes, 2)


def _logits(cfg: LMConfig, params, x, dp_axes, last_only: bool):
    """The head on the final norm, vocab-parallel: each rank of "model"
    computes the logits of its vocab columns, laid out P(dp, None,
    "model")."""
    act = P(dp_axes, None, None)
    head = {k: params[k] for k in ("final_norm", "lm_head") if k in params}
    if "lm_head" not in head:
        head["embed"] = params["embed"]
    specs = {k: model_spec(v, (1,) if k == "lm_head" else (0,)) for k, v in head.items()}
    vocab = specs.get("lm_head", specs.get("embed"))
    split = is_split(vocab)

    def finish(x, head):
        return _head(cfg, head, x[:, -1:] if last_only else x)

    logits = local_call(finish, (x, head), (act, specs),
                        P(dp_axes, None, "model") if split else act)
    if dp_axes and not split:
        logits = constrain(logits, P(dp_axes, None, "model"))
    return logits


def forward(cfg: LMConfig, params: Any, tokens: torch.Tensor, *, dp_axes=("data",),
            kv_chunk: int = 1024, seq_shard: bool = False, last_only: bool = False,
            layers: Optional[Dict[str, list]] = None) -> torch.Tensor:
    """Training/eval forward → logits (B, S, V); (B, 1, V) if last_only.

    ``layers``: the stacks already unbound ({stack: [layer tree, ...]}),
    as the train step passes its slices (``params`` then needs only the
    embedding, final norm and head); by default unbound here.  Tokens as a
    DTensor (placed by ``input_specs``) run SPMD over ``dp_axes`` and
    tensor-parallel over "model"; the logits come out vocab-split."""
    if layers is None:
        layers = {k: unstack(params[k]) for k in stacks(params)}
    x = _embed(cfg, params["embed"], tokens, dp_axes)
    x = _constrain(x, dp_axes, 2, seq_shard=seq_shard)
    for name in stacks(layers):
        x = _run_blocks(cfg, layers[name], x, kv_chunk, dp_axes, seq_shard)
    return _logits(cfg, params, x, dp_axes, last_only)


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


def _xent_vocab_split(cfg: LMConfig, logits, tokens, dp_axes):
    """Each rank's term of the mean cross-entropy on logits split over
    "model" by vocab columns: the row max (a max over "model"), the sum of
    exponentials and the label's logit (from the rank that holds its
    column; sums over "model"), the pad columns masked where they lie."""
    j = model_index(logits)
    rows, lg = P(dp_axes, None), P(dp_axes, None, "model")
    B = tokens.shape[0]

    def masked(lg):
        lg = lg[:, :-1].float()
        vl = lg.shape[-1]
        if cfg.vocab_padded != cfg.vocab:
            col = j * vl + torch.arange(vl, device=lg.device)
            lg = torch.where(col < cfg.vocab, lg, float("-inf"))
        return lg

    # the shift of the logsumexp: any constant gives its value, so no gradient
    mx = constrain(local_call(lambda t: masked(t.detach()).amax(-1), (logits,), (lg,), rows,
                              partial=("model",), partial_op="max"), rows)

    def terms(lg, tok, mx):
        lg = masked(lg)
        vl = lg.shape[-1]
        sumexp = torch.exp(lg - mx[..., None]).sum(-1)
        loc = tok[:, 1:].long() - j * vl
        hit = (loc >= 0) & (loc < vl)
        picked = torch.gather(lg, -1, torch.where(hit, loc, 0)[..., None])[..., 0]
        return sumexp, torch.where(hit, picked, 0.0)

    sumexp, picked = local_call(terms, (logits, tokens, mx), (lg, rows, rows), (rows, rows),
                                partial=("model",))
    sumexp, picked = constrain(sumexp, rows), constrain(picked, rows)
    return local_call(
        lambda se, pk, mx, tok: ((torch.log(se) + mx) - pk).mean() * (tok.shape[0] / B),
        (sumexp, picked, mx, tokens), (rows,) * 4, P(), partial=tuple(dp_axes))


def loss_fn(cfg: LMConfig, params: Any, tokens: torch.Tensor, kv_chunk: int = 1024,
            layers: Optional[Dict[str, list]] = None, *, dp_axes=("data",),
            seq_shard: bool = False) -> torch.Tensor:
    """Causal next-token cross-entropy (mean over B·(S-1))."""
    logits = forward(cfg, params, tokens, dp_axes=dp_axes, kv_chunk=kv_chunk,
                     seq_shard=seq_shard, layers=layers)
    # each rank's rows: its mean, weighted by its share of the rows (the
    # whole batch: the mean itself); over vocab shards, the sharded softmax
    if is_dtensor(logits) and is_split(spec_of(logits)[-1:]):
        return full(_xent_vocab_split(cfg, logits, tokens, dp_axes))
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


def microbatches(tokens, n: int) -> list:
    """The reference's microbatches: batch ``k`` is the global rows
    ``[k·B/n, (k+1)·B/n)``.  A DTensor batch is gathered (token ids only)
    and each microbatch placed again like it, over the same axes."""
    B = tokens.shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split into {n} microbatches")
    b = B // n
    if not is_dtensor(tokens):
        return list(tokens.reshape(n, b, *tokens.shape[1:]))
    mesh = tokens.device_mesh
    whole = tokens.full_tensor()
    sh = NamedSharding(mesh, sanitize_spec(mesh, (b, *tokens.shape[1:]), spec_of(tokens)))
    return [sh.distribute(whole[k * b:(k + 1) * b], device=whole.device) for k in range(n)]


def make_train_step(cfg: LMConfig, opt_cfg: OptConfig, dp_axes=("data",),
                    kv_chunk: int = 1024, grad_accum: int = 1, seq_shard: bool = False,
                    param_shardings=None):
    """One optimizer step: ``train_step(params, opt_state, tokens) ->
    (params, opt_state, loss)``, the parameters and moments updated in place.

    ``grad_accum`` splits the batch into sequential microbatches (activation
    memory ∝ 1/grad_accum), the reference's global rows each (see
    ``microbatches``; an MoE layer's capacity follows the tokens of a call,
    so the grouping decides which tokens it drops); their gradients are
    summed in the parameters' dtype and divided, as the reference's scan
    does.  ``param_shardings`` (a tree of ``NamedSharding``s or
    ``param_specs``' structs) constrains the gradients to the parameters'
    shardings, as the reference constrains its accumulated gradients; on
    DTensors the moments must be laid out by ``opt_state_specs``."""

    def grads_of(params, tok):
        return loss_and_grads(cfg, params, tok, kv_chunk=kv_chunk, stacked=False,
                              dp_axes=dp_axes, seq_shard=seq_shard)

    @sync_free
    def train_step(params, opt_state, tokens):
        if grad_accum == 1:
            loss, grads = grads_of(params, tokens)
        else:
            loss, grads = None, None
            for mtok in microbatches(tokens, grad_accum):
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


def caches_from_specs(specs, *, device=None) -> Dict[str, Any]:
    """Zero caches as DTensors laid out by ``_cache_specs`` (each rank
    allocates its own blocks only)."""
    def zeros(s):
        if isinstance(s, tuple):  # a stack's keys and values (and scales)
            return tuple(zeros(t) for t in s)
        return zeros_from_struct(s, device=device)

    return tree_map(zeros, specs)


def make_decode_step(cfg: LMConfig, dp_axes=("data",)):
    """One-token decode against a (B, Smax) cache at position ``cache_len``:
    ``decode_step(params, caches, tokens, cache_len) -> (logits (B, V),
    caches)``, the caches written in place.  ``cache_len`` is an int or a
    0-d tensor, read on the device.

    On DTensors (parameters by ``param_specs``, tokens, caches and
    ``cache_len`` by ``input_specs``) each rank decodes its batch rows and,
    within them, its shard of the heads and FFN columns, against its block
    of the caches (see ``_decode_attention``); each new entry is written
    in place by the ranks that hold its position.  The logits come out
    P(dp, "model")."""

    @sync_free
    @torch.no_grad()
    def decode_step(params, caches, tokens, cache_len):
        sharded = is_dtensor(tokens)
        if sharded != any(is_dtensor(t) for t in tree_leaves(params)):
            raise ValueError("tokens and parameters must both be DTensors or both plain")
        if sharded and not dp_axes:
            raise ValueError("DTensor inputs need dp_axes (the batch's mesh axes)")
        dev = tokens.to_local().device if sharded else tokens.device
        clen = cache_len.to_local() if is_dtensor(cache_len) else cache_len
        clen = torch.as_tensor(clen, device=dev).reshape(()).long()
        act = P(dp_axes, None, None)
        x = _embed(cfg, params["embed"], tokens, dp_axes)
        for name in stacks(params):
            cache = caches[name]
            per_layer = (unstack_leaf(cache) if cfg.mla
                         else list(zip(*(unstack_leaf(c) for c in cache))))
            for lp, lc in zip(unstack(params[name]), per_layer):
                lp = tree_map(gather_layer, lp)
                x = x + _constrain(_decode_attention(cfg, lp, x, lc, clen, act), dp_axes, 2)
                x = x + _constrain(_ffn(cfg, lp, x, dp_axes, act), dp_axes, 2)
        lg = _logits(cfg, params, x, dp_axes, last_only=False)
        if not is_dtensor(lg):
            return lg[:, 0], caches
        sp = sanitize_spec(lg.device_mesh, lg.shape, (dp_axes, None, "model"))
        return local_call(lambda t: t[:, 0], (lg,), (sp,), P(sp[0], sp[2])), caches

    return decode_step


def _decode_attention(cfg: LMConfig, p: dict, x, cache, clen, act):
    """A decode step's attention on a rank's block of the caches, the term
    of the sum over "model" where the output projection is split.

    * KV heads split over "model": the local query and KV heads, the
      one-device attention on them.
    * A whole cache (its bf16 scales, if int8, may be split over the
      sequence): queries and keys whole, the scales gathered.
    * head_dim split over "model" (GQA): each rank's partial scores over its
      slice of head_dim, summed over "model", then each rank's slice of the
      heads' outputs, gathered for the output projection.
    * MLA: a whole latent as the first case on the local heads; a latent
      split over "model" as the third, over its columns.
    """
    leaves = (cache,) if cfg.mla else cache
    cspec = [spec_of(c) if is_dtensor(c) else P() for c in leaves]
    if cfg.mla:
        if is_split(cspec[0][2:]):
            return _decode_mla_split(cfg, p, x, cache, cspec[0], clen, act)
        return _decode_local(cfg, p, x, cache, cspec, clen, act)
    if is_split(cspec[0][2:3]):  # KV heads
        return _decode_local(cfg, p, x, cache, cspec, clen, act)
    scales = cfg.kv_quant_int8 and is_split(cspec[1][1:2])
    if is_split(cspec[0][3:]):
        return _decode_gqa_hd_split(cfg, p, x, cache, cspec, clen, act, scales)
    return _decode_local(cfg, p, x, cache, cspec, clen, act, whole_q=True, scales=scales)


def _gathered_scales(cache, cspec, act):
    """The bf16 scales of an int8 cache split over its sequence, gathered
    whole over "model" (a copy; its writes go to the blocks separately)."""
    kq, ks, vq, vs = cache
    whole = P(act[0], None, None, None)
    return constrain(ks, whole), constrain(vs, whole)


def _write_scales(local, gathered, clen, shard):
    """The step's new scale, taken from the gathered copy, written into the
    block of the sequence this rank holds (if it holds that position)."""
    n, total = local.shape[1], gathered.shape[1]
    pos = torch.clamp(clen, 0, total - 1).reshape(1)
    L._write(local, gathered.index_select(1, pos), clen, first=shard * n, total=total)


def _decode_local(cfg, p, x, cache, cspec, clen, act, *, whole_q=False, scales=False):
    """The one-device attention on each rank's heads and cache block (see
    ``_decode_attention``); ``whole_q`` computes every query head (a cache
    whole over "model"), ``scales`` gathers scales split over the sequence."""
    attn = p["attn"]
    whole = ("wq", "bq") if whole_q else ()
    specs = _tp_specs(attn, whole)
    tp = _tp(specs["wo"])
    if cfg.mla:
        cq = _mla_cq(x, p, specs["wq_a"], act)
        rest = {k: v for k, v in attn.items() if k != "wq_a"}

        def local(x, ln, cq, w, c, clen):
            h = L.rmsnorm(x, ln)
            return L.mla_attention(cfg, w, h, clen.expand(h.shape[0], 1), kv_cache=c,
                                   cache_len=clen, cq=cq)[0]

        return local_call(local, (x, p["ln1"], cq, rest, cache, clen),
                          (act, P(), act, {k: specs[k] for k in rest}, cspec[0], None),
                          act, partial=tp)
    j = model_index(x)
    extra = _gathered_scales(cache, cspec, act) if scales else ()

    def local(x, ln, w, c, clen, *sc):
        h = L.rmsnorm(x, ln)
        if sc:  # attend with the gathered scales, then write the blocks
            kq, ks, vq, vs = c
            y = L.gqa_attention(cfg, w, h, clen.expand(h.shape[0], 1),
                                kv_cache=(kq, sc[0], vq, sc[1]), cache_len=clen, shard=j)[0]
            _write_scales(ks, sc[0], clen, j)
            _write_scales(vs, sc[1], clen, j)
            return y
        return L.gqa_attention(cfg, w, h, clen.expand(h.shape[0], 1), kv_cache=c,
                               cache_len=clen, shard=j)[0]

    whole4 = P(act[0], None, None, None)
    return local_call(local, (x, p["ln1"], attn, tuple(cache), clen, *extra),
                      (act, P(), specs, tuple(cspec), None, *([whole4] * len(extra))),
                      act, partial=tp)


def _decode_gqa_hd_split(cfg, p, x, cache, cspec, clen, act, scales):
    """GQA decode on a cache split over head_dim: every rank computes the
    step's queries, keys and values whole, writes its slice of head_dim,
    and scores every head on its slice; the scores are summed over "model",
    each rank attends over its slice of the values, and the heads' outputs
    are gathered for the output projection."""
    attn = p["attn"]
    specs = _tp_specs(attn, ("wq", "bq", "wk", "bk", "wv", "bv"))
    j = model_index(x)
    qkv = {k: v for k, v in attn.items() if k != "wo"}
    extra = _gathered_scales(cache, cspec, act) if scales else ()
    D = cfg.hd
    s5 = P(act[0], None, None, None, None)
    whole4 = P(act[0], None, None, None)

    def deq(c, s, dt):
        return c.to(dt) if s is None else L._dequant_int8(c, s, dt)

    def scores(x, ln, w, c, clen, *sc):
        h = L.rmsnorm(x, ln)
        pos = clen.expand(h.shape[0], 1)
        q = torch.einsum("bsd,dhk->bshk", h, w["wq"])
        k = torch.einsum("bsd,dhk->bshk", h, w["wk"])
        v = torch.einsum("bsd,dhk->bshk", h, w["wv"])
        if cfg.qkv_bias:
            q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
        q = L.rope(q, pos, cfg.rope_theta)
        k = L.rope(k, pos, cfg.rope_theta)
        dl = c[0].shape[-1]
        cols = slice(j * dl, (j + 1) * dl)
        if sc:
            kq, ks, vq, vs = c
            (knq, kns), (vnq, vns) = L._quant_int8(k), L._quant_int8(v)
            for blk, new in ((kq, knq[..., cols]), (vq, vnq[..., cols]), (sc[0], kns),
                             (sc[1], vns)):
                L._write(blk, new, clen)
            _write_scales(ks, sc[0], clen, j)
            _write_scales(vs, sc[1], clen, j)
            kc = deq(kq, sc[0], q.dtype)
        elif cfg.kv_quant_int8:
            kq, ks, vq, vs = c
            (knq, kns), (vnq, vns) = L._quant_int8(k), L._quant_int8(v)
            for blk, new in ((kq, knq[..., cols]), (ks, kns), (vq, vnq[..., cols]), (vs, vns)):
                L._write(blk, new, clen)
            kc = deq(kq, ks, q.dtype)
        else:
            L._write(c[0], k[..., cols], clen)
            L._write(c[1], v[..., cols], clen)
            kc = c[0]
        B, _, H, _ = q.shape
        hkv = kc.shape[2]
        qh = q[..., cols].reshape(B, 1, hkv, H // hkv, dl)
        return torch.einsum("bqhgd,bkhd->bqhgk", qh, kc).float()

    s = local_call(scores, (x, p["ln1"], qkv, tuple(cache), clen, *extra),
                   (act, P(), {k: specs[k] for k in qkv}, tuple(cspec), None,
                    *([whole4] * len(extra))), s5, partial=("model",))
    s = constrain(s, s5)

    def attend(s, c, clen, *sc):
        vc = c[2] if cfg.kv_quant_int8 else c[1]
        vs = sc[1] if sc else (c[3] if cfg.kv_quant_int8 else None)
        vc = deq(vc, vs, cfg.torch_dtype)
        s = s * (D ** -0.5)
        pos = torch.arange(vc.shape[1], device=vc.device)
        s = torch.where((pos < clen + 1)[None, None, None, None, :], s, L.NEG_INF)
        pr = torch.softmax(s, dim=-1).to(vc.dtype)
        out = torch.einsum("bqhgk,bkhe->bqhge", pr, vc)
        return out.reshape(out.shape[0], 1, -1, out.shape[-1])

    out = local_call(attend, (s, tuple(cache), clen, *extra),
                     (s5, tuple(cspec), None, *([whole4] * len(extra))),
                     P(act[0], None, None, "model"))
    out = constrain(out, whole4)
    wspec = model_spec(attn["wo"], _TP_DIMS["wo"])
    return local_call(lambda o, wo: torch.einsum("bshk,hkd->bsd", L.wo_slice(o, wo, j), wo),
                      (out, attn["wo"]), (whole4, wspec), act, partial=_tp(wspec))


def _decode_mla_split(cfg, p, x, cache, cspec, clen, act):
    """MLA decode on a latent cache split over "model" by columns: every
    rank computes the step's latent whole and writes its columns; the
    absorbed queries of its heads are gathered, each rank scores every
    head over its columns (summed over "model"), attends over its columns
    (gathered), and its heads run ``wv_b`` and ``wo``."""
    attn = p["attn"]
    specs = _tp_specs(attn)
    j = model_index(x)
    dn, dr, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    cq = _mla_cq(x, p, specs["wq_a"], act)
    qkeys = ("q_norm", "wq_b", "wk_b", "wkv_a", "kv_norm")
    heads = "model" if is_split(specs["wq_b"]) else None
    whole4 = P(act[0], None, None, None)

    def queries(x, ln, cq, w, c, clen):
        h = L.rmsnorm(x, ln)
        q, latent = L.mla_queries_latent(cfg, w, h, clen.expand(h.shape[0], 1), cq)
        cl = c.shape[-1]
        L._write(c, latent[..., j * cl:(j + 1) * cl], clen)
        q_abs = torch.einsum("bqhd,rhd->bqhr", q[..., :dn], w["wk_b"])
        return torch.cat([q_abs, q[..., dn:]], dim=-1)

    qcat = local_call(queries, (x, p["ln1"], cq, {k: attn[k] for k in qkeys}, cache, clen),
                      (act, P(), act, {k: specs[k] for k in qkeys}, cspec, None),
                      P(act[0], None, heads, None))
    qcat = constrain(qcat, whole4)

    def scores(qc, c):
        cl = c.shape[-1]
        return torch.einsum("bqhc,bsc->bqhs", qc[..., j * cl:(j + 1) * cl],
                            c.to(qc.dtype)).float()

    s = constrain(local_call(scores, (qcat, cache), (whole4, cspec), whole4,
                             partial=("model",)), whole4)

    def attend(s, c, clen):
        s = s * (dn + dr) ** -0.5
        pos = torch.arange(c.shape[1], device=c.device)
        s = torch.where((pos < clen + 1)[None, None, None, :], s, L.NEG_INF)
        pr = torch.softmax(s, dim=-1).to(cfg.torch_dtype)
        return torch.einsum("bqhs,bsc->bqhc", pr, c.to(pr.dtype))

    lat_out = constrain(local_call(attend, (s, cache, clen), (whole4, cspec, None),
                                   P(act[0], None, None, "model")), whole4)
    ov = {"wv_b": attn["wv_b"], "wo": attn["wo"]}

    def project(lo, w):
        hl = w["wv_b"].shape[1]
        lo = lo[:, :, j * hl:(j + 1) * hl, :r] if hl != lo.shape[2] else lo[..., :r]
        out = torch.einsum("bqhr,rhe->bqhe", lo, w["wv_b"])
        return torch.einsum("bshk,hkd->bsd", out, w["wo"])

    return local_call(project, (lat_out, ov), (whole4, {k: specs[k] for k in ov}), act,
                      partial=_tp(specs["wo"]))


def make_prefill_step(cfg: LMConfig, dp_axes=("data",), kv_chunk: int = 1024,
                      seq_shard: bool = False, batch_chunks: int = 1):
    """Full-sequence prefill → last-token logits (B, V) (the cache write is
    elided, as in the reference).  ``batch_chunks`` runs the batch in
    sequential chunks of the reference's global rows (``microbatches``),
    bounding the working set; DTensor tokens run SPMD over ``dp_axes`` and
    tensor-parallel over "model", the logits P(dp, "model")."""

    def one(params, tokens):
        lg = forward(cfg, params, tokens, dp_axes=dp_axes, kv_chunk=kv_chunk,
                     seq_shard=seq_shard, last_only=True)
        if not is_dtensor(lg):
            return lg[:, 0], None
        sp = sanitize_spec(lg.device_mesh, lg.shape, (dp_axes, None, "model"))
        return local_call(lambda t: t[:, 0], (lg,), (sp,), P(sp[0], sp[2])), sp[2]

    @sync_free
    @torch.no_grad()
    def prefill_step(params, tokens):
        outs = [one(params, t) for t in microbatches(tokens, batch_chunks)]
        if len(outs) == 1:
            return outs[0][0]
        if not is_dtensor(outs[0][0]):
            return torch.cat([o for o, _ in outs], 0)
        # each chunk's rows gathered over the dp axes, joined and placed
        # again over them (no rank holds more than the whole (B, V / model))
        vspec = outs[0][1]
        rows = [constrain(o, P(None, vspec)) for o, _ in outs]
        cat = local_call(lambda *xs: torch.cat(xs, 0), rows, (P(None, vspec),) * len(rows),
                         P(None, vspec))
        return constrain(cat, P(dp_axes, vspec))

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
