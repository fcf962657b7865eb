"""Decoder-only LM family: dense (GQA), MLA, and MoE variants.

The PyTorch counterpart of ``repro.models.transformer``.  One parameter
table (``param_defs``, shapes and dtypes) drives ``init_params``; the
parameters are a nested dict of tensors under the reference's names, with
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
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.models import layers as L
from repro_torch.optim import OptConfig, adamw_update
from repro_torch.tree import tree_leaves, tree_map

# ----------------------------------------------------------------------------
# Parameter definition table: {path: (shape, dtype)}
# ----------------------------------------------------------------------------

NORMS = ("ln1", "ln2", "final_norm", "q_norm", "kv_norm")
BIASES = ("bq", "bk", "bv")


def param_defs(cfg: LMConfig) -> Dict[str, tuple]:
    """Flat {path: (shape, dtype)} table; layer leaves carry their leading
    stacked dim.  The reference's partition specs wait for a port of
    ``repro.distributed``."""
    d, V = cfg.d_model, cfg.vocab_padded
    H, Hkv, hd, f = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    dt = cfg.torch_dtype
    defs: Dict[str, tuple] = {"embed": ((V, d), dt), "final_norm": ((d,), dt)}
    if not cfg.tie_embeddings:
        defs["lm_head"] = ((d, V), dt)

    def attn_defs(prefix: str):
        if cfg.mla:
            dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
            rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
            return {
                f"{prefix}.wq_a": ((d, rq), dt),
                f"{prefix}.q_norm": ((rq,), dt),
                f"{prefix}.wq_b": ((rq, H, dn + dr), dt),
                f"{prefix}.wkv_a": ((d, rkv + dr), dt),
                f"{prefix}.kv_norm": ((rkv,), dt),
                f"{prefix}.wk_b": ((rkv, H, dn), dt),
                f"{prefix}.wv_b": ((rkv, H, dv), dt),
                f"{prefix}.wo": ((H, dv, d), dt),
            }
        out = {
            f"{prefix}.wq": ((d, H, hd), dt),
            f"{prefix}.wk": ((d, Hkv, hd), dt),
            f"{prefix}.wv": ((d, Hkv, hd), dt),
            f"{prefix}.wo": ((H, hd, d), dt),
        }
        if cfg.qkv_bias:
            out[f"{prefix}.bq"] = ((H, hd), dt)
            out[f"{prefix}.bk"] = ((Hkv, hd), dt)
            out[f"{prefix}.bv"] = ((Hkv, hd), dt)
        return out

    def dense_ffn_defs(prefix: str):
        return {
            f"{prefix}.w1": ((d, f), dt),
            f"{prefix}.w3": ((d, f), dt),
            f"{prefix}.w2": ((f, d), dt),
        }

    def moe_ffn_defs(prefix: str):
        E, fm = cfg.n_experts, cfg.moe_d_ff
        out = {
            f"{prefix}.router": ((d, E), torch.float32),
            f"{prefix}.we1": ((E, d, fm), dt),
            f"{prefix}.we2": ((E, fm, d), dt),
            f"{prefix}.we3": ((E, d, fm), dt),
        }
        if cfg.n_shared:
            fs = cfg.n_shared * fm
            out[f"{prefix}.ws1"] = ((d, fs), dt)
            out[f"{prefix}.ws3"] = ((d, fs), dt)
            out[f"{prefix}.ws2"] = ((fs, d), dt)
        return out

    def block_defs(prefix: str, moe_block: bool):
        out = {f"{prefix}.ln1": ((d,), dt), f"{prefix}.ln2": ((d,), dt)}
        out.update(attn_defs(f"{prefix}.attn"))
        out.update(moe_ffn_defs(f"{prefix}.ffn") if moe_block
                   else dense_ffn_defs(f"{prefix}.ffn"))
        return out

    n_dense, n_moe = layer_counts(cfg)
    if n_dense:
        for k, (shape, dtv) in block_defs("dense", False).items():
            defs[k] = ((n_dense, *shape), dtv)
    if n_moe:
        for k, (shape, dtv) in block_defs("moe", True).items():
            defs[k] = ((n_moe, *shape), dtv)
    return defs


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
    """A stack's per-layer trees: every leaf unbound ONCE along dim 0."""
    slices = tree_map(lambda t: t.unbind(0), stacked)
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


def _block(cfg: LMConfig, p: dict, x, positions, kv_chunk):
    h = L.rmsnorm(x, p["ln1"])
    attn = L.mla_attention if cfg.mla else L.gqa_attention
    a, _ = attn(cfg, p["attn"], h, positions, kv_chunk=kv_chunk)
    x = x + a
    y = L.rmsnorm(x, p["ln2"])
    ffn = L.moe_ffn(cfg, p["ffn"], y) if "router" in p["ffn"] else L.swiglu(p["ffn"], y)
    return x + ffn


def _run_blocks(cfg, layers, x, positions, kv_chunk):
    """Every block in turn, each recomputed in the backward pass when its
    gradients are being recorded."""
    for lp in layers:
        if torch.is_grad_enabled() and (
                x.requires_grad or any(t.requires_grad for t in tree_leaves(lp))):
            x = checkpoint(lambda c, lp=lp: _block(cfg, lp, c, positions, kv_chunk), x,
                           use_reentrant=False)
        else:
            x = _block(cfg, lp, x, positions, kv_chunk)
    return x


def _head(cfg, params, x):
    x = L.rmsnorm(x, params["final_norm"])
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    return torch.einsum("bsd,dv->bsv", x, head)


def forward(cfg: LMConfig, params: Any, tokens: torch.Tensor, *, kv_chunk: int = 1024,
            last_only: bool = False, layers: Optional[Dict[str, list]] = None
            ) -> torch.Tensor:
    """Training/eval forward → logits (B, S, V); (B, 1, V) if last_only.

    ``layers``: the stacks already unbound ({stack: [layer tree, ...]}),
    as the train step passes its slices (``params`` then needs only the
    embedding, final norm and head); by default unbound here."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = F.embedding(tokens, params["embed"]).to(cfg.torch_dtype)
    if layers is None:
        layers = {k: unstack(params[k]) for k in stacks(params)}
    for name in stacks(layers):
        x = _run_blocks(cfg, layers[name], x, positions, kv_chunk)
    if last_only:
        x = x[:, -1:]
    return _head(cfg, params, x)


def loss_fn(cfg: LMConfig, params: Any, tokens: torch.Tensor, kv_chunk: int = 1024,
            layers: Optional[Dict[str, list]] = None) -> torch.Tensor:
    """Causal next-token cross-entropy (mean over B·(S-1)); the pad columns
    of ``vocab_padded`` are masked out of the softmax."""
    logits = forward(cfg, params, tokens, kv_chunk=kv_chunk, layers=layers)
    logits = logits[:, :-1].float()
    if cfg.vocab_padded != cfg.vocab:
        col = torch.arange(cfg.vocab_padded, device=logits.device)
        logits = torch.where(col < cfg.vocab, logits, float("-inf"))
    labels = tokens[:, 1:].long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (lse - picked).mean()


def loss_and_grads(cfg: LMConfig, params: Any, tokens: torch.Tensor, *,
                   kv_chunk: int = 1024, stacked: bool = True):
    """Loss and gradients of one batch, in the params' tree.

    The gradients are taken with respect to detached leaves: each leaf
    outside the stacks, and each layer slice of a stack (a view of it).  So
    a stacked leaf's gradient comes as its per-layer slices: a list with
    ``stacked=False`` (what the train step consumes), stacked like the
    parameter with ``stacked=True``."""
    top = {k: v.detach().requires_grad_() for k, v in params.items()
           if k not in ("dense", "moe")}
    layers = {k: [tree_map(lambda t: t.detach().requires_grad_(), lp)
                  for lp in unstack(params[k])] for k in stacks(params)}
    targets = [top] + [lp for k in stacks(layers) for lp in layers[k]]
    with torch.enable_grad():
        loss = loss_fn(cfg, top, tokens, kv_chunk, layers=layers)
        flat = iter(torch.autograd.grad(loss, [t for tr in targets for t in tree_leaves(tr)]))
    grads = tree_map(lambda _: next(flat), top)
    for k in stacks(layers):
        per_layer = [tree_map(lambda _: next(flat), lp) for lp in layers[k]]
        grads[k] = tree_map(lambda *gs: torch.stack(gs) if stacked else list(gs), *per_layer)
    return loss.detach(), grads


def make_train_step(cfg: LMConfig, opt_cfg: OptConfig, kv_chunk: int = 1024,
                    grad_accum: int = 1):
    """One optimizer step: ``train_step(params, opt_state, tokens) ->
    (params, opt_state, loss)``, the parameters and moments updated in place.

    ``grad_accum`` splits the batch into sequential microbatches (activation
    memory ∝ 1/grad_accum); their gradients are summed in the parameters'
    dtype and divided, as the reference's scan does."""

    def train_step(params, opt_state, tokens):
        if grad_accum == 1:
            loss, grads = loss_and_grads(cfg, params, tokens, kv_chunk=kv_chunk,
                                         stacked=False)
        else:
            B = tokens.shape[0]
            if B % grad_accum:
                raise ValueError(f"batch {B} does not split into {grad_accum} microbatches")
            micro = tokens.reshape(grad_accum, B // grad_accum, tokens.shape[1])
            loss, grads = None, None
            for mtok in micro:
                l, g = loss_and_grads(cfg, params, mtok, kv_chunk=kv_chunk, stacked=False)
                if grads is None:
                    loss, grads = l, g
                else:
                    loss = loss + l
                    grads = tree_map(_add, grads, g)
            loss = loss / grad_accum
            grads = tree_map(lambda g: _scale(g, grad_accum), grads)
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
    caches)``, the caches written in place."""

    @torch.no_grad()
    def decode_step(params, caches, tokens, cache_len):
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


def make_prefill_step(cfg: LMConfig, kv_chunk: int = 1024, batch_chunks: int = 1):
    """Full-sequence prefill → last-token logits (B, V) (the cache write is
    elided, as in the reference).  ``batch_chunks`` runs the batch in
    sequential chunks, bounding the working set."""

    @torch.no_grad()
    def prefill_step(params, tokens):
        B = tokens.shape[0]
        if B % batch_chunks:
            raise ValueError(f"batch {B} does not split into {batch_chunks} chunks")
        outs = [forward(cfg, params, t, kv_chunk=kv_chunk, last_only=True)[:, 0]
                for t in tokens.chunk(batch_chunks)]
        return torch.cat(outs, 0)

    return prefill_step
