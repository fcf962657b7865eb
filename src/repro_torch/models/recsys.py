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

Sharding (``param_specs``, ``input_specs``): the item table is row-sharded
over ("data", "model"), the batch over the dp axes.  On DTensors every
step runs SPMD: every rank looks up every id of the batch in the rows it
holds (zeros elsewhere) and the sum over the table's axes lands on the
batch rows; each rank then routes its own users, against the targets of
the whole batch (the in-batch negatives) in training, against its rows'
candidates in serving.  Retrieval routes its one query on every rank and
scores each rank's block of the candidates.  A sharded lookup fills an
out-of-range id with NaN, as the reference's ``jnp.take`` does, instead of
raising: no rank holds it, and the check would read the ids on the host.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RecsysConfig, ShapeSpec
from repro_torch.knobs import sync_free
from repro_torch.distributed.sharding import (P, NamedSharding, ShapeDtypeStruct, axes_index,
                                              constrain, entry_axes, full, is_dtensor, like,
                                              local_call, named_sharding, sanitize_spec,
                                              spec_of)
from repro_torch.optim import adamw_update


def param_table(cfg: RecsysConfig) -> Dict[str, tuple]:
    """{name: (shape, dtype, spec)}."""
    dt = cfg.torch_dtype
    d = cfg.embed_dim
    return {
        "item_table": ((cfg.n_items, d), dt, (("data", "model"), None)),
        "bilinear": ((d, d), dt, (None, None)),  # B2I routing map S
        "label_att": ((d, d), dt, (None, None)),
        "out_proj": ((d, d), dt, (None, None)),
    }


def param_defs(cfg: RecsysConfig) -> Dict[str, tuple]:
    """{name: (shape, dtype)} (``param_table`` without specs)."""
    return {k: (shape, dt) for k, (shape, dt, _) in param_table(cfg).items()}


def param_specs(cfg: RecsysConfig, mesh):
    """{name: ShapeDtypeStruct} with each weight's sharding."""
    return {k: ShapeDtypeStruct(shape, dt, named_sharding(mesh, shape, *spec))
            for k, (shape, dt, spec) in param_table(cfg).items()}


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
    if ids.numel() and ((ids < 0) | (ids >= table.shape[0])).any():
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
    return _capsules(cfg, params, take(params["item_table"], hist_ids), hist_mask)


def _capsules(cfg: RecsysConfig, params, e, hist_mask):
    """The routing of the looked-up behaviours ``e`` (B, L, d)."""
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


def _user_logp(cfg: RecsysConfig, params, caps, tgt, tgt_all, first: int):
    """The log-probability of each user's own target among every target of
    the batch (users ``first``, ``first + 1``, ... of it)."""
    att = torch.softmax(
        torch.einsum("bkd,bd->bk", caps, tgt @ params["label_att"]).float() * 4.0,
        dim=-1)
    user = torch.einsum("bk,bkd->bd", att.to(caps.dtype), caps)
    user = user @ params["out_proj"]
    logits = (user @ tgt_all.T).float()  # in-batch negatives (B, B)
    lab = first + torch.arange(logits.shape[0], device=logits.device)
    logp = F.log_softmax(logits, dim=-1)
    return torch.gather(logp, 1, lab[:, None])


def train_loss(cfg: RecsysConfig, params, batch):
    """Label-aware attention + in-batch sampled-softmax retrieval loss; the
    in-batch logits are (B, B) in f32.  On DTensors the batch's own
    placements name the dp axes: each rank routes its own users against
    the targets of the whole batch (gathered)."""
    ids = batch["hist_ids"]
    dp_axes = _dp(ids)
    e = _take(params["item_table"], ids, dp_axes)  # (B, L, d)
    tgt = _take(params["item_table"], batch["target_id"], dp_axes)  # (B, d)
    B = tgt.shape[0]
    first = axes_index(tgt.device_mesh, dp_axes) if is_dtensor(tgt) else 0
    rows = P(dp_axes, None)
    small = {k: params[k] for k in ("bilinear", "label_att", "out_proj")}

    def local(e, mask, tgt, tgt_all, p):
        caps = _capsules(cfg, p, e, mask)
        logp = _user_logp(cfg, p, caps, tgt, tgt_all, first * tgt.shape[0])
        # this rank's mean, weighted by its share of the users
        return -torch.mean(logp) * (tgt.shape[0] / B)

    part = local_call(local, (e, batch["hist_mask"], tgt, tgt, small),
                      (P(dp_axes, None, None), rows, rows, P(), P()), P(),
                      partial=dp_axes)
    return full(part)


def _dp(t) -> tuple:
    """The mesh axes a batch array's rows are split over (none if plain)."""
    return entry_axes(spec_of(t)[0]) if is_dtensor(t) else ()


def _take(table, ids, dp_axes):
    """``take`` from the item table, which may be row-sharded: then the ids
    are gathered, each rank looks up the rows it holds (zeros elsewhere:
    every id hits one rank, so the sum over the table's axes is exact) and
    the sum lands on the batch rows of ``dp_axes``."""
    row_axes = entry_axes(spec_of(table)[0]) if is_dtensor(table) else ()
    n = table.shape[0]
    first = axes_index(table.device_mesh, row_axes) if row_axes else 0

    def look(tab, ids):
        if tab.shape[0] == n:  # the whole table on this rank
            return take(tab, ids)
        loc = ids.long() - first * tab.shape[0]
        hit = (loc >= 0) & (loc < tab.shape[0])
        e = tab.index_select(0, torch.where(hit, loc, 0).reshape(-1))
        e = e.reshape(*ids.shape, tab.shape[1]) * hit[..., None].to(e.dtype)
        if first == 0:  # an id no rank holds: NaN, once
            e = torch.where(((ids < 0) | (ids >= n))[..., None], float("nan"), e)
        return e

    out = local_call(look, (table, ids), (spec_of(table) if row_axes else P(), P()),
                     P(*([None] * (ids.ndim + 1))), partial=row_axes)
    return constrain(out, _rows(out, dp_axes))


def _rows(t, dp_axes) -> P:
    """A batch array's rows over ``dp_axes`` (dropped where they do not
    split them: retrieval's one query)."""
    spec = P(dp_axes, *([None] * (t.ndim - 1)))
    return sanitize_spec(t.device_mesh, t.shape, spec) if is_dtensor(t) else spec


def _interests_rows(cfg: RecsysConfig, params, batch):
    """The interest capsules of the batch's users on their rows (every
    rank's copy where the rows are not split)."""
    ids = batch["hist_ids"]
    e = _take(params["item_table"], ids, _dp(ids))  # (B, L, d)
    rows = _rows(e, _dp(ids))
    caps = local_call(lambda e, m, w: _capsules(cfg, {"bilinear": w}, e, m),
                      (e, batch["hist_mask"], params["bilinear"]), (rows, P(*rows[:2]), P()),
                      rows)
    return caps, rows


def serve_scores(cfg: RecsysConfig, params, batch):
    """Online inference: max-over-interests dot with per-request candidates
    (on DTensors each rank scores its rows)."""
    caps, rows = _interests_rows(cfg, params, batch)
    cand = _take(params["item_table"], batch["cand_ids"], _dp(batch["cand_ids"]))  # (B, C, d)
    return local_call(lambda caps, cand: torch.amax(torch.einsum("bkd,bcd->bkc", caps, cand),
                                                    dim=1),  # (B, C)
                      (caps, cand), (rows, rows), P(*rows[:2]))


def retrieval_scores(cfg: RecsysConfig, params, batch):
    """One query against the candidate megabatch: batched dot, no loop (on
    DTensors each rank scores its block of the candidates)."""
    caps, rows = _interests_rows(cfg, params, batch)  # (1, K, d)
    dp = _dp(batch["cand_ids"])
    cand = _take(params["item_table"], batch["cand_ids"], dp)  # (C, d)
    crow = _rows(cand, dp)
    return local_call(lambda caps, cand: torch.amax(torch.einsum("kd,cd->kc", caps[0], cand),
                                                    dim=0),  # (C,)
                      (caps, cand), (rows, crow), P(crow[0]))


def loss_and_grads(cfg: RecsysConfig, params, batch):
    """(loss, gradients as a dict like the params; on DTensors each laid
    out like its parameter)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        loss = train_loss(cfg, leaves, batch)
        grads = torch.autograd.grad(loss, [leaves[k] for k in sorted(leaves)])
    return loss.detach(), {k: like(g, leaves[k]) for k, g in zip(sorted(leaves), grads)}


def make_step(cfg: RecsysConfig, shape: ShapeSpec, opt_cfg=None):
    """The cell's step: ``step(params, opt_state, batch) -> (params,
    opt_state, loss)`` for ``recsys_train`` (AdamW in place), ``step(params,
    batch) -> scores`` (no gradients) for ``recsys_serve`` and
    ``recsys_retrieval``."""
    if shape.kind == "recsys_train":

        @sync_free
        def step(params, opt_state, batch):
            loss, grads = loss_and_grads(cfg, params, batch)
            params, opt_state = adamw_update(params, grads, opt_state, opt_cfg)
            return params, opt_state, loss

        return step
    score = {"recsys_serve": serve_scores, "recsys_retrieval": retrieval_scores}.get(shape.kind)
    if score is None:
        raise ValueError(shape.kind)

    @sync_free
    @torch.no_grad()
    def serve(params, batch):
        return score(cfg, params, batch)

    return serve



def input_specs(cfg: RecsysConfig, shape: ShapeSpec, mesh, dp_axes=("data",)):
    """Input ShapeDtypeStructs per MIND cell: the batch rows over
    ``dp_axes``; retrieval's one query replicated, its candidates split."""
    dt = torch.float32
    B = shape.batch
    Lh = cfg.hist_len
    i32 = torch.int32

    def arr(s, dtype, sh=None):
        if sh is None:
            sh = named_sharding(mesh, s, dp_axes, *([None] * (len(s) - 1)))
        return ShapeDtypeStruct(s, dtype, sh)

    base = {"hist_ids": arr((B, Lh), i32), "hist_mask": arr((B, Lh), dt)}
    if shape.kind == "recsys_train":
        base["target_id"] = arr((B,), i32)
        return base
    if shape.kind == "recsys_serve":
        ncand = 256  # per-request rerank set
        base["cand_ids"] = arr((B, ncand), i32)
        return base
    if shape.kind == "recsys_retrieval":
        rep = NamedSharding(mesh, P(None, None))
        return {
            "hist_ids": arr((1, Lh), i32, rep),
            "hist_mask": arr((1, Lh), dt, rep),
            "cand_ids": arr((shape.n_candidates,), i32),
        }
    raise ValueError(shape.kind)
