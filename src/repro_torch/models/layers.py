"""Transformer building blocks: RMSNorm, RoPE, GQA/MLA attention, MoE.

The PyTorch counterpart of ``repro.models.layers``, with the same
arithmetic in the same dtypes: parameters are dicts of tensors under the
reference's names, and attention is the same KV-chunked online softmax
(Rabe–Staats) with its accumulator in ``v.dtype``, so the 32K-prefill
cells never materialize an S×S score matrix.

Tensor parallelism: the attention functions take the local shards of a
rank of "model" (``shard`` is its index there).  Query heads split over
"model" run locally; KV projections given whole are cut to the KV heads
the local query heads read; an output projection split over head_dim reads
its slice of the heads' outputs.  Given whole weights they are the
one-device functions.  Cache positions are tensors read on the device, so
no step syncs with the host.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.distributed.sharding import P, constrain, is_split, local_call, model_spec

NEG_INF = float("-inf")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Squares summed in f32, the scaling in ``x.dtype``."""
    ss = x.float().square().sum(-1)
    var = (ss / x.shape[-1])[..., None]
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over INTERLEAVED pairs (x[..., 0::2], x[..., 1::2]).

    x: (..., S, H, D) with D even; positions: (..., S)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = positions.float()[..., :, None, None] * freqs  # (.., S, 1, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


# ----------------------------------------------------------------------------
# Chunked (online-softmax) attention — the memory-efficient prefill/train path
# ----------------------------------------------------------------------------


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, Dv)
    *,
    causal: bool,
    q_offset: int = 0,
    kv_chunk: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks (no S×S buffer).

    GQA: Hq must be a multiple of Hkv; KV heads are broadcast.
    ``q_offset`` is the absolute position of q[0].  The last chunk is padded
    to ``kv_chunk`` and masked, as the reference's scan pads it.
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    g = Hq // Hkv
    sc = scale if scale is not None else D ** -0.5
    nchunks = -(-Sk // kv_chunk)
    pad = nchunks * kv_chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qh = q.reshape(B, Sq, Hkv, g, D)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, Sq, Hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, Hkv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, Hkv, g, Dv), dtype=v.dtype, device=q.device)
    for c in range(nchunks):
        kblk = k[:, c * kv_chunk:(c + 1) * kv_chunk]
        vblk = v[:, c * kv_chunk:(c + 1) * kv_chunk]
        kpos = c * kv_chunk + torch.arange(kv_chunk, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qh, kblk).float() * sc
        mask = (kpos < Sk)[None, None, None, None, :]  # padding
        if causal:
            mask = mask & (kpos[None, None, None, None, :]
                           <= qpos[None, :, None, None, None])
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        # guard fully-masked rows (m_new = -inf) against NaNs
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bqhgk,bkhe->bqhge", p.to(v.dtype), vblk)
        acc = acc * corr[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
    return out.reshape(B, Sq, Hq, Dv)


# ----------------------------------------------------------------------------
# GQA attention block (dense archs) — params as dicts of tensors
# ----------------------------------------------------------------------------


def gqa_attention(
    cfg: LMConfig,
    p: dict,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,
    *,
    kv_cache: Optional[tuple] = None,  # (k, v[, scales]) running cache
    cache_len=0,
    kv_chunk: int = 1024,
    shard: int = 0,
    q_rows: Optional[slice] = None,
):
    """Returns (out, kv): with a cache, kv is the cache with this step's keys
    and values written in place at ``cache_len`` (layout (B, Smax, Hkv, D));
    without one, the step's (k, v).  On a rank's shards (see the module
    docstring) ``out`` is its term of the sum over "model".  ``q_rows``
    (no cache): only those query positions, against every key."""
    p = _local_kv_heads(cfg, p, shard)
    xq, pq = (x, positions) if q_rows is None else (x[:, q_rows], positions[:, q_rows])
    q = torch.einsum("bsd,dhk->bshk", xq, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = rope(q, pq, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if kv_cache is None:
        out = chunked_attention(q, k, v, causal=True, kv_chunk=kv_chunk,
                                q_offset=0 if q_rows is None else q_rows.start)
        new_cache = (k, v)
    else:
        out, new_cache = _attend_with_cache(cfg, q, k, v, kv_cache, cache_len)
    y = torch.einsum("bshk,hkd->bsd", wo_slice(out, p["wo"], shard), p["wo"])
    return y, new_cache


def wo_slice(out: torch.Tensor, wo: torch.Tensor, shard: int) -> torch.Tensor:
    """The part of the heads' outputs (B, S, H, D) that a rank's block of
    the output projection (H or H/m, D or D/m, d) reads."""
    hl, dl = wo.shape[:2]
    if hl != out.shape[2]:
        out = out[:, :, shard * hl:(shard + 1) * hl]
    if dl != out.shape[3]:
        out = out[..., shard * dl:(shard + 1) * dl]
    return out


def _local_kv_heads(cfg: LMConfig, p: dict, shard: int) -> dict:
    """Local query heads with whole KV projections: the KV projections cut
    to the heads those query heads read (a contiguous run when the groups
    line up, else one KV head for each query head)."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    hl = p["wq"].shape[1]
    if hl == H or p["wk"].shape[1] != Hkv:
        return p
    g = H // Hkv
    lo = shard * hl
    if hl % g == 0:
        sel = slice(lo // g, (lo + hl) // g)
    elif g % hl == 0:
        sel = slice(lo // g, lo // g + 1)
    else:
        sel = torch.arange(lo, lo + hl, device=p["wk"].device) // g
    p = dict(p)
    for k in ("wk", "wv"):
        p[k] = p[k][:, sel]
    for k in ("bk", "bv"):
        if k in p:
            p[k] = p[k][sel]
    return p


def _quant_int8(x: torch.Tensor):
    """Per-(token, head) symmetric int8 quantization of KV entries, with bf16
    scales (round half to even, as ``jnp.round``)."""
    x32 = x.float()
    amax = x32.abs().amax(-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    qx = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return qx, scale.to(torch.bfloat16)


def _dequant_int8(qx: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (qx.float() * scale.float()).to(dtype)


def _write(cache: torch.Tensor, new: torch.Tensor, start, *, first: int = 0,
           total: Optional[int] = None) -> None:
    """``dynamic_update_slice`` along axis 1, in place (the start is clamped so
    that the update fits, as the reference's); ``start`` an int or a 0-d
    tensor, read on the device.  ``cache`` may be the block of positions
    ``[first, first + len)`` of a cache ``total`` long, split over its
    sequence: then only the positions it holds are written."""
    S, n = new.shape[1], cache.shape[1]
    total = n if total is None else total
    dev = cache.device
    pos = torch.clamp(torch.as_tensor(start, device=dev), 0, total - S)
    pos = pos + torch.arange(S, device=dev)
    new = new.to(cache.dtype)
    if first == 0 and total == n:
        cache.index_copy_(1, pos, new)
        return
    loc = pos - first
    hit = (loc >= 0) & (loc < n)
    loc = torch.clamp(loc, 0, n - 1)
    keep = hit.reshape(1, S, *([1] * (new.ndim - 2)))
    cache.index_copy_(1, loc, torch.where(keep, new, cache.index_select(1, loc)))


def _attend_with_cache(cfg: LMConfig, q, k_new, v_new, cache, cache_len,
                       kv_chunk: int = 2048):
    """Decode path: insert new KV at ``cache_len``, attend over the cache.

    The int8 cache is dequantized PER CHUNK inside the online softmax; the
    full-precision cache is never materialized.
    """
    S = k_new.shape[1]
    if cfg.kv_quant_int8:
        kq, ks, vq, vs = cache
        knq, kns = _quant_int8(k_new)
        vnq, vns = _quant_int8(v_new)
        for c, new in ((kq, knq), (ks, kns), (vq, vnq), (vs, vns)):
            _write(c, new, cache_len)
        out = _decode_attention_q8(q, kq, ks, vq, vs, cache_len + S, kv_chunk)
        return out, (kq, ks, vq, vs)
    kc, vc = cache
    _write(kc, k_new, cache_len)
    _write(vc, v_new, cache_len)
    out = _masked_decode_attention(q, kc, vc, cache_len + S)
    return out, (kc, vc)


def _decode_attention_q8(q, kq, ks, vq, vs, valid_len, kv_chunk):
    """Online softmax over int8 cache chunks (dequantized chunk by chunk)."""
    B, Sq, Hq, D = q.shape
    _, Smax, Hkv, _ = kq.shape
    g = Hq // Hkv
    qh = q.reshape(B, Sq, Hkv, g, D)
    kv_chunk = min(kv_chunk, Smax)  # smoke-scale caches are tiny
    if Smax % kv_chunk:
        raise ValueError(f"cache length {Smax} is not a multiple of {kv_chunk}")
    m = torch.full((B, Sq, Hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, Hkv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, Hkv, g, D), dtype=q.dtype, device=q.device)
    for c in range(Smax // kv_chunk):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        kblk = _dequant_int8(kq[:, sl], ks[:, sl], q.dtype)
        vblk = _dequant_int8(vq[:, sl], vs[:, sl], q.dtype)
        kpos = c * kv_chunk + torch.arange(kv_chunk, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qh, kblk).float()
        s = s * (D ** -0.5)
        mask = (kpos < valid_len)[None, None, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        pr = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + pr.sum(-1)
        pv = torch.einsum("bqhgk,bkhe->bqhge", pr.to(vblk.dtype), vblk)
        acc = acc * corr[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
    return out.reshape(B, Sq, Hq, D)


def _masked_decode_attention(q, k, v, valid_len):
    """Plain attention over a (B, Smax, Hkv, D) cache with a length mask."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    g = Hq // Hkv
    qh = q.reshape(B, Sq, Hkv, g, D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qh, k).float() * (D ** -0.5)
    pos = torch.arange(Sk, device=q.device)
    s = torch.where((pos < valid_len)[None, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bqhgk,bkhe->bqhge", p, v)
    return out.reshape(B, Sq, Hq, Dv)


# ----------------------------------------------------------------------------
# MLA attention (DeepSeek-V3): low-rank Q + compressed latent KV cache
# ----------------------------------------------------------------------------


def mla_attention(
    cfg: LMConfig,
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    kv_cache: Optional[torch.Tensor] = None,  # (B, Smax, kv_lora + rope_dim)
    cache_len=0,
    kv_chunk: int = 1024,
    cq: Optional[torch.Tensor] = None,
):
    """Multi-head Latent Attention [arXiv:2412.19437 §2.1].

    The cache stores only the compressed latent c_kv (kv_lora_rank) and the
    decoupled RoPE key (qk_rope_head_dim); it is written in place.  ``cq``
    is ``x @ wq_a`` where the caller has it (gathered from the column
    shards of "model"); ``wq_b``, ``wk_b``, ``wv_b`` and ``wo`` may hold a
    rank's heads, and ``out`` is then its term of the sum over "model".
    """
    q, latent = mla_queries_latent(cfg, p, x, positions, cq)
    S = x.shape[1]
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    r = cfg.kv_lora_rank
    q_nope, q_rope = q[..., :dn], q[..., dn:]

    scale = (dn + dr) ** -0.5
    if kv_cache is not None:
        # --- absorbed decode: score and attend in the LATENT space; per-head
        # K/V are never expanded over the cache.
        _write(kv_cache, latent, cache_len)
        lat_all = kv_cache.to(x.dtype)
        valid = cache_len + S
        ckv_all = lat_all[..., :r]  # (B, Smax, r)
        kr_all = lat_all[..., r:]  # (B, Smax, dr)
        q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope, p["wk_b"])
        sc = (
            torch.einsum("bqhr,bsr->bqhs", q_abs, ckv_all)
            + torch.einsum("bqhd,bsd->bqhs", q_rope, kr_all)
        ).float() * scale
        pos_k = torch.arange(lat_all.shape[1], device=x.device)
        sc = torch.where((pos_k < valid)[None, None, None, :], sc, NEG_INF)
        pr = torch.softmax(sc, dim=-1).to(x.dtype)
        lat_out = torch.einsum("bqhs,bsr->bqhr", pr, ckv_all)
        out = torch.einsum("bqhr,rhe->bqhe", lat_out, p["wv_b"])
        y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
        return y, kv_cache

    # --- prefill/train: expand the latent to per-head keys/values
    ckv_all = latent[..., :r]
    kr_all = latent[..., r:]
    k_nope = torch.einsum("bsr,rhk->bshk", ckv_all, p["wk_b"])  # (B, Sk, H, dn)
    v_all = torch.einsum("bsr,rhk->bshk", ckv_all, p["wv_b"])  # (B, Sk, H, dv)
    k_all = torch.cat(
        [k_nope, kr_all[:, :, None, :].expand(*k_nope.shape[:3], dr)], dim=-1
    )
    out = chunked_attention(q, k_all, v_all, causal=True, kv_chunk=kv_chunk,
                            scale=scale)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, kv_cache


def mla_queries_latent(cfg: LMConfig, p: dict, x, positions, cq=None):
    """MLA's queries (B, S, H, dn + dr), their rope half rotated, and the
    step's latent (B, S, r + dr): the normed c_kv and the rotated rope key."""
    dn = cfg.qk_nope_head_dim
    r = cfg.kv_lora_rank
    # --- queries (low-rank)
    if cq is None:
        cq = torch.einsum("bsd,dr->bsr", x, p["wq_a"])
    cq = rmsnorm(cq, p["q_norm"])
    q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"])  # (B, S, H, dn + dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], positions, cfg.rope_theta)], dim=-1)
    # --- compressed KV latent + decoupled rope key
    ckv_full = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])  # (B, S, r + dr)
    ckv = rmsnorm(ckv_full[..., :r], p["kv_norm"])
    k_rope = rope(ckv_full[..., r:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return q, torch.cat([ckv, k_rope], dim=-1)


# ----------------------------------------------------------------------------
# FFN: SwiGLU dense + sort-free gather-based MoE dispatch
# ----------------------------------------------------------------------------


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(torch.einsum("bsd,df->bsf", x, p["w1"])) * torch.einsum(
        "bsd,df->bsf", x, p["w3"]
    )
    return torch.einsum("bsf,fd->bsd", h, p["w2"])


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: ties go to the lower index
    (a stable descending sort; ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(cfg: LMConfig, T: int) -> int:
    """Slots an expert takes: cf · T · k / E, at least 8 and a multiple of 8."""
    raw = -(-int(cfg.capacity_factor * T * cfg.top_k) // cfg.n_experts)  # ceil
    return max(8, -(-raw // 8) * 8)


def _moe_route(cfg: LMConfig, router, xt):
    """The dispatch over every token of ``xt`` (T, d): (xin (E, C, d) the
    tokens each expert reads, topv (T, K) the gate weights, gslot (T·K,)
    where each (token, k) landed, in_cap (T·K,) whether it fit)."""
    T, d = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    dev = xt.device
    gates = torch.softmax(torch.einsum("td,de->te", xt.float(), router), dim=-1)
    topv, topi = top_k(gates, K)  # (T, K)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    flat_e = topi.reshape(-1)  # (T*K,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    stk = flat_t[order]
    # exact counts with a shape known ahead (``bincount``'s is the data's)
    counts = torch.zeros(E, dtype=se.dtype, device=dev).scatter_add_(0, se, torch.ones_like(se))
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    C = moe_capacity(cfg, T)

    slots = torch.arange(C, device=dev)
    slot_idx = starts[:, None] + slots[None, :]  # (E, C)
    slot_ok = slots[None, :] < counts[:, None]
    tok = torch.where(slot_ok, stk[torch.clamp(slot_idx, 0, T * K - 1)], 0)
    xin = xt[tok] * slot_ok[..., None].to(xt.dtype)  # (E, C, d)

    # inverse permutation: where did flat slot (t, k) land?
    iorder = torch.argsort(order, stable=True)  # (T*K,)
    pos = iorder - starts[flat_e]
    in_cap = pos < C
    gslot = torch.clamp(flat_e * C + pos, 0, E * C - 1)
    return xin, topv, gslot, in_cap


def _moe_experts(xin, we1, we3, we2):
    h = F.silu(torch.einsum("ecd,edf->ecf", xin, we1)) * torch.einsum("ecd,edf->ecf", xin, we3)
    return torch.einsum("ecf,efd->ecd", h, we2)  # (E, C, d)


def _moe_shared(p, xt):
    sh = F.silu(torch.einsum("td,df->tf", xt, p["ws1"])) * torch.einsum("td,df->tf", xt, p["ws3"])
    return torch.einsum("tf,fd->td", sh, p["ws2"])


def moe_ffn(cfg: LMConfig, p: dict, x: torch.Tensor, dp_axes: tuple = ()) -> torch.Tensor:
    """Top-k MoE with shared experts — gather-only dispatch (no scatters).

    Tokens are sorted by assigned expert (one stable argsort); each expert
    reads its slots by gather, computes, and tokens gather their results
    back through the inverse permutation.  Tokens past an expert's capacity
    are dropped in the reference's order.

    Sharding (when ``x`` is a DTensor): token-major tensors stay sharded
    over dp, expert-major tensors over "model" (EP), as the reference's
    ``tok_c`` and ``exp_c`` constraints say; on plain tensors both, and
    every ``local_call``, are no-ops.
    """

    def tok_c(t):  # token-sharded constraint
        return constrain(t, P(dp_axes, *([None] * (t.ndim - 1)))) if dp_axes else t

    def exp_c(t):  # expert-sharded constraint
        return constrain(t, P("model", *([None] * (t.ndim - 1)))) if dp_axes else t

    B, S, d = x.shape
    K = cfg.top_k
    tok, rep = P(dp_axes, None), P()
    xt = tok_c(local_call(lambda x: x.reshape(-1, d), (x,), (P(dp_axes, None, None),), tok))
    # one argsort over every token, with the capacity of the whole batch:
    # no split of it gives the same dispatch, so the tokens are gathered
    xin, topv, gslot, in_cap = local_call(lambda xt, r: _moe_route(cfg, r, xt),
                                          (xt, p["router"]), (rep, rep), (rep,) * 4)
    xin = exp_c(xin)
    ex = P("model", None, None)
    yslots = exp_c(local_call(_moe_experts, (xin, p["we1"], p["we3"], p["we2"]), (ex,) * 4, ex))
    # a token's k results sit in any expert's slots: the slots are gathered
    ytk = tok_c(local_call(lambda ys, gs, ok: ys.reshape(-1, d)[gs] * ok[:, None].to(ys.dtype),
                           (yslots, gslot, in_cap), (rep, rep, rep), rep))
    y = local_call(lambda ytk, tv: (ytk.reshape(-1, K, d) * tv[..., None].to(ytk.dtype)).sum(1),
                   (ytk, topv), (tok, tok), tok)
    if cfg.n_shared:
        # column-split over "model" (ws1, ws3), row-split (ws2): partial sums
        shared = {k: p[k] for k in ("ws1", "ws2", "ws3")}
        specs = {"ws1": model_spec(p["ws1"], (1,)), "ws3": model_spec(p["ws3"], (1,)),
                 "ws2": model_spec(p["ws2"], (0,))}
        tp = ("model",) if is_split(specs["ws2"]) else ()
        y = y + tok_c(local_call(_moe_shared, (shared, xt), (specs, tok), tok, partial=tp))
    return local_call(lambda y: y.reshape(-1, S, d), (y,), (tok,), P(dp_axes, None, None))
