"""MIND: multi-interest network with dynamic (capsule) routing.

The PyTorch counterpart of ``repro.models.recsys`` [arXiv:1904.08030]:
user behaviour sequence → B2I dynamic routing into ``n_interests``
capsules → label-aware attention (train) or max-dot scoring
(serve/retrieval).  The hot path is the lookup in a multi-million-row
item table (``index_select`` and masking, as the reference's ``jnp.take``).

Item ids must lie in ``[0, n_items)``: the reference's ``jnp.take`` fills
an out-of-range id where the card's indexing would assert, so every lookup
here checks its ids and raises ``IndexError`` instead
(:class:`repro_torch.data.recsys.BehaviorStream` keeps them in range).
The reference's sharding (``param_specs``, ``input_specs``) waits for a
port of ``repro.distributed``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RecsysConfig, ShapeSpec
from repro_torch.optim import adamw_update


def param_defs(cfg: RecsysConfig) -> Dict[str, tuple]:
    dt = cfg.torch_dtype
    d = cfg.embed_dim
    return {
        "item_table": ((cfg.n_items, d), dt),
        "bilinear": ((d, d), dt),  # B2I routing map S
        "label_att": ((d, d), dt),
        "out_proj": ((d, d), dt),
    }


def init_params(cfg: RecsysConfig, generator: torch.Generator, *, device=None):
    """Normal / sqrt(last dim) drawn in f32 from ``generator`` in the
    reference's (sorted) order and cast; JAX's streams are not reproduced
    (weights to compare come through
    :func:`repro_torch.convert.recsys_params_from_numpy`)."""
    device = generator.device if device is None else torch.device(device)
    out = {}
    for name, (shape, dt) in sorted(param_defs(cfg).items()):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        out[name] = w.mul_(shape[-1] ** -0.5).to(dt)
    return out


def take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (any shape of ids); raises ``IndexError`` on an id
    outside ``[0, len(table))``."""
    if ids.numel() and bool(((ids < 0) | (ids >= table.shape[0])).any()):
        bad = ids[(ids < 0) | (ids >= table.shape[0])][0]
        raise IndexError(f"item id {int(bad)} outside [0, {table.shape[0]})")
    return table.index_select(0, ids.reshape(-1)).reshape(*ids.shape, table.shape[-1])


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor):
    """EmbeddingBag(sum) built from take + mask, as the reference."""
    e = take(table, ids)  # (..., L, d)
    return torch.sum(e * mask[..., None].to(e.dtype), dim=-2)


def _squash(v):
    n2 = torch.sum(torch.square(v), dim=-1, keepdim=True)
    return (n2 / (1 + n2)) * v / torch.sqrt(n2 + 1e-9)


def interests(cfg: RecsysConfig, params, hist_ids, hist_mask):
    """B2I dynamic routing → (B, n_interests, d) interest capsules.  The
    routing logits carry the gradient through every iteration."""
    e = take(params["item_table"], hist_ids)  # (B, L, d)
    e = e * hist_mask[..., None].to(e.dtype)
    u = e @ params["bilinear"]  # behaviour→interest map (shared S)
    B, Lh, d = u.shape
    K = cfg.n_interests
    dev = u.device
    # routing logits initialized deterministically (hash-like, fixed seed)
    b = torch.zeros((B, Lh, K), dtype=torch.float32, device=dev) + 0.01 * torch.sin(
        torch.arange(Lh, dtype=torch.float32, device=dev)[None, :, None]
        * (1.0 + torch.arange(K, dtype=torch.float32, device=dev))[None, None, :])
    caps = None
    for _ in range(cfg.capsule_iters):
        wgt = torch.softmax(b, dim=-1) * hist_mask[..., None]
        caps = _squash(torch.einsum("blk,bld->bkd", wgt.to(u.dtype), u))
        b = b + torch.einsum("bkd,bld->blk", caps, u).float()
    return caps  # (B, K, d)


def train_loss(cfg: RecsysConfig, params, batch):
    """Label-aware attention + in-batch sampled-softmax retrieval loss; the
    in-batch logits are (B, B) in f32."""
    caps = interests(cfg, params, batch["hist_ids"], batch["hist_mask"])
    tgt = take(params["item_table"], batch["target_id"])  # (B, d)
    att = torch.softmax(
        torch.einsum("bkd,bd->bk", caps, tgt @ params["label_att"]).float() * 4.0,
        dim=-1)
    user = torch.einsum("bk,bkd->bd", att.to(caps.dtype), caps)
    user = user @ params["out_proj"]
    logits = (user @ tgt.T).float()  # in-batch negatives (B, B)
    lab = torch.arange(logits.shape[0], device=logits.device)
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, lab[:, None]))


def serve_scores(cfg: RecsysConfig, params, batch):
    """Online inference: max-over-interests dot with per-request candidates."""
    caps = interests(cfg, params, batch["hist_ids"], batch["hist_mask"])
    cand = take(params["item_table"], batch["cand_ids"])  # (B, C, d)
    s = torch.einsum("bkd,bcd->bkc", caps, cand)
    return torch.amax(s, dim=1)  # (B, C)


def retrieval_scores(cfg: RecsysConfig, params, batch):
    """One query against the candidate megabatch: batched dot, no loop."""
    caps = interests(cfg, params, batch["hist_ids"], batch["hist_mask"])  # (1, K, d)
    cand = take(params["item_table"], batch["cand_ids"])  # (C, d)
    s = torch.einsum("kd,cd->kc", caps[0], cand)
    return torch.amax(s, dim=0)  # (C,)


def loss_and_grads(cfg: RecsysConfig, params, batch):
    """(loss, gradients as a dict like the params)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        loss = train_loss(cfg, leaves, batch)
        grads = torch.autograd.grad(loss, [leaves[k] for k in sorted(leaves)])
    return loss.detach(), dict(zip(sorted(leaves), grads))


def make_step(cfg: RecsysConfig, shape: ShapeSpec, opt_cfg=None):
    """The cell's step: ``step(params, opt_state, batch) -> (params,
    opt_state, loss)`` for ``recsys_train`` (AdamW in place), ``step(params,
    batch) -> scores`` (no gradients) for ``recsys_serve`` and
    ``recsys_retrieval``."""
    if shape.kind == "recsys_train":

        def step(params, opt_state, batch):
            loss, grads = loss_and_grads(cfg, params, batch)
            params, opt_state = adamw_update(params, grads, opt_state, opt_cfg)
            return params, opt_state, loss

        return step
    score = {"recsys_serve": serve_scores, "recsys_retrieval": retrieval_scores}.get(shape.kind)
    if score is None:
        raise ValueError(shape.kind)

    @torch.no_grad()
    def serve(params, batch):
        return score(cfg, params, batch)

    return serve

