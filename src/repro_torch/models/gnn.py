"""GNN family: GraphSAGE, GatedGCN, SchNet, GraphCast.

The PyTorch counterpart of ``repro.models.gnn``, with its names, its
parameter table and its nested parameter dict (``l0.self``,
``i1.filter2``, ``p3.edge1``, ...), so that weights converted from the
reference (:func:`repro_torch.convert.gnn_params_from_numpy`) and
checkpoints line up.

All four share the message-passing substrate of the Steiner core:
edge-index gather → per-edge message → a scatter-add into the destination
rows (``index_add``: the reference's ``jax.ops.segment_sum``).  On the card
``index_add`` on floats adds with atomics, so a row's sum is taken in no
fixed order and differs from the CPU's in the last bits.  Graph tensors
are padded and static:

  nodes:  x (N, F)          edges: (E, 2) int32 src/dst
  sampled minibatch (GraphSAGE shape): fixed fanout feature tensors
  molecule batch: (G, n, f) dense small graphs with an (E, 2) edge template

Every layer is recomputed in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).  Edge and
node ids must lie in range: the card's indexing asserts where the
reference's gather would clamp.  The reference's sharding (``param_specs``,
``make_specs``, ``input_specs`` and the ``_cons`` constraints) waits for a
port of ``repro.distributed``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GNNConfig, ShapeSpec
from repro_torch.optim import adamw_update
from repro_torch.tree import tree_leaves, tree_map


class _ScatterSum(torch.autograd.Function):
    """``index_add`` into zeros whose backward keeps only the index:
    autograd's own ``index_add`` saves the (E, d) messages for their shape,
    which at ogb_products' 6.2·10^7 edges is a 31.7 GB tensor held from the
    recomputed forward until the backward."""

    @staticmethod
    def forward(ctx, msg, dst, n):
        ctx.save_for_backward(dst)
        out = msg.new_zeros((*msg.shape[:-2], n, msg.shape[-1]))
        return out.index_add_(-2, dst, msg)

    @staticmethod
    def backward(ctx, grad):
        (dst,) = ctx.saved_tensors
        return grad.index_select(-2, dst), None, None


def scatter_sum(msg: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` over dim -2: (..., E, d) → (..., n, d)."""
    return _ScatterSum.apply(msg, dst, n)


def seg_mean(msg, dst, n):
    s = scatter_sum(msg, dst, n)
    c = torch.bincount(dst, minlength=n).to(msg.dtype)[:, None]  # exact counts
    return s / torch.clamp(c, min=1.0)


def _gather(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``h[idx]`` along dim -2; its backward is an ``index_add``."""
    return h.index_select(-2, idx)


def _remat(fn, *args):
    """``fn(*args)``, recomputed in the backward pass when gradients are
    being recorded (the reference's ``jax.checkpoint``)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ----------------------------------------------------------------------------
# Parameter tables
# ----------------------------------------------------------------------------


def param_defs(cfg: GNNConfig, d_feat: int) -> Dict[str, tuple]:
    """Flat {path: (shape, dtype)}: the reference's table without its
    partition specs."""
    dt = cfg.torch_dtype
    h = cfg.d_hidden
    defs: Dict[str, tuple] = {}

    def lin(name, din, dout):
        defs[name] = ((din, dout), dt)

    if cfg.kind == "sage":
        din = d_feat
        for i in range(cfg.n_layers):
            lin(f"l{i}.self", din, h)
            lin(f"l{i}.nbr", din, h)
            din = h
        lin("out", h, cfg.n_classes)
    elif cfg.kind == "gatedgcn":
        lin("enc", d_feat, h)
        lin("enc_e", 1, h)
        for i in range(cfg.n_layers):
            for nm in ("A", "B", "D", "E", "U", "V"):
                lin(f"l{i}.{nm}", h, h)
            defs[f"l{i}.ln_n"] = ((h,), dt)
            defs[f"l{i}.ln_e"] = ((h,), dt)
        lin("out", h, cfg.n_classes)
    elif cfg.kind == "schnet":
        lin("embed", d_feat, h)
        for i in range(cfg.n_interactions):
            lin(f"i{i}.filter1", cfg.rbf, h)
            lin(f"i{i}.filter2", h, h)
            lin(f"i{i}.in", h, h)
            lin(f"i{i}.out1", h, h)
            lin(f"i{i}.out2", h, h)
        lin("head1", h, h)
        lin("head2", h, 1)
    elif cfg.kind == "graphcast":
        lin("enc_grid", d_feat, h)
        lin("enc_g2m", 4, h)
        lin("enc_mesh", 4, h)
        lin("enc_m2g", 4, h)
        for i in range(cfg.n_layers):
            lin(f"p{i}.edge1", 3 * h, h)
            lin(f"p{i}.edge2", h, h)
            lin(f"p{i}.node1", 2 * h, h)
            lin(f"p{i}.node2", h, h)
        lin("g2m_edge", 3 * h, h)
        lin("m2g_edge", 3 * h, h)
        lin("g2m_node", 2 * h, h)
        lin("m2g_node", 2 * h, h)
        lin("dec1", h, h)
        lin("dec2", h, cfg.n_vars)
    else:
        raise ValueError(cfg.kind)
    return defs


def _nest(flat):
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split(".")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def init_params(cfg: GNNConfig, d_feat: int, generator: torch.Generator, *, device=None):
    """The reference's distributions in its (sorted) order, drawn from
    ``generator`` on its device: layer-norm scales one, every weight normal
    / sqrt(fan_in) drawn in f32 and cast.  JAX's threefry streams are not
    reproduced; weights to compare with the reference are carried over with
    :func:`repro_torch.convert.gnn_params_from_numpy`."""
    device = generator.device if device is None else torch.device(device)
    flat = {}
    for name, (shape, dt) in sorted(param_defs(cfg, d_feat).items()):
        if name.endswith(("ln_n", "ln_e")):
            flat[name] = torch.ones(shape, dtype=dt, device=device)
        else:
            w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
            flat[name] = w.mul_(shape[0] ** -0.5).to(dt)
    return _nest(flat)


# ----------------------------------------------------------------------------
# Forward passes
# ----------------------------------------------------------------------------


def _l2_normalize(h):
    return h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True), min=1e-6)


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x (torch's softplus
    returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def sage_forward_full(cfg, params, x, edges):
    """Full-graph GraphSAGE (mean aggregator)."""
    n = x.shape[0]
    src, dst = edges[:, 0], edges[:, 1]

    def layer(h, p):
        nbr = seg_mean(_gather(h, src), dst, n)
        return _l2_normalize(F.relu(h @ p["self"] + nbr @ p["nbr"]))

    h = x
    for i in range(cfg.n_layers):
        h = _remat(layer, h, params[f"l{i}"])
    return h @ params["out"]


def sage_forward_sampled(cfg, params, feats: Tuple[torch.Tensor, ...]):
    """Fanout-sampled GraphSAGE: feats[k] = (B·prod(fanout[:k]), F)."""
    depth = cfg.n_layers
    hs = list(feats)  # hop 0 = batch nodes, hop k = sampled neighbors
    for i in range(depth):
        p = params[f"l{i}"]
        new = []
        for hop in range(depth - i):
            cur = hs[hop]
            nxt = hs[hop + 1].reshape(cur.shape[0], -1, hs[hop + 1].shape[-1])
            nbr = nxt.mean(dim=1)
            new.append(_l2_normalize(F.relu(cur @ p["self"] + nbr @ p["nbr"])))
        hs = new
    return hs[0] @ params["out"]


def _ln(x, scale, eps=1e-5):
    """Layer norm over the last dim with the population variance."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale


def gatedgcn_forward(cfg, params, x, edges, ew):
    """GatedGCN [arXiv:2003.00982]: edge-gated mean aggregation."""
    n = x.shape[0]
    src, dst = edges[:, 0], edges[:, 1]
    h = x @ params["enc"]
    e = ew[:, None] @ params["enc_e"]

    def layer(h, e, p):
        hs = _gather(h, src)
        hd = _gather(h, dst)
        eh = e @ p["D"] + hs @ p["E"] + hd @ p["V"]
        e_new = e + F.relu(_ln(eh, p["ln_e"]))
        gate = torch.sigmoid(e_new)
        msg = gate * (hs @ p["B"])
        den = scatter_sum(gate, dst, n) + 1e-6
        agg = scatter_sum(msg, dst, n) / den
        h_new = h + F.relu(_ln(h @ p["A"] + agg @ p["U"], p["ln_n"]))
        # the bf16 edge-feature carry of the reference: a rounding step of
        # the model, its gradient rounded through the same two casts
        return h_new, e_new.to(torch.bfloat16).to(e.dtype)

    for i in range(cfg.n_layers):
        h, e = _remat(layer, h, e, params[f"l{i}"])
    return h @ params["out"]


def rbf_centers(cfg, dtype=torch.float32, device=None):
    """``jnp.linspace(0, cutoff, rbf)`` as XLA computes it, bit for bit.

    The reference's ``start·(1 - t) + stop·t`` with ``t = i / (rbf - 1)``
    is folded by XLA into ``i · (f32(1 / (rbf - 1)) · stop)`` (the start is
    0), and ``stop`` appended."""
    div = cfg.rbf - 1
    stop = torch.tensor(cfg.cutoff, dtype=dtype, device=device)
    if div <= 0:
        return torch.zeros((1,), dtype=dtype, device=device)
    scale = (torch.tensor(1.0, dtype=dtype, device=device) / div) * stop
    return torch.cat([torch.arange(div, dtype=dtype, device=device) * scale, stop.reshape(1)])


def schnet_forward(cfg, params, z_feat, pos, edges):
    """SchNet [arXiv:1706.08566]: continuous-filter convolutions.

    z_feat: (N, F) atom-type features; pos: (N, 3); edges: (E, 2).  Returns
    the sum-pooled energy of the graph.  With a leading molecule axis
    (z_feat (G, N, F), pos (G, N, 3)) every molecule shares the edge
    template and the result is (G,): the reference's ``jax.vmap``.
    """
    n = z_feat.shape[-2]
    src, dst = edges[:, 0], edges[:, 1]
    h = z_feat @ params["embed"]
    d = torch.linalg.vector_norm(_gather(pos, src) - _gather(pos, dst) + 1e-9, dim=-1)
    mu = rbf_centers(cfg, h.dtype, h.device)
    gamma = 10.0 / cfg.cutoff
    rbf = torch.exp(-gamma * torch.square(d[..., None] - mu))  # (..., E, rbf)
    # smooth cutoff
    fcut = 0.5 * (torch.cos(math.pi * torch.clamp(d / cfg.cutoff, 0, 1)) + 1.0)

    def interaction(h, p):
        wfil = softplus(rbf @ p["filter1"]) @ p["filter2"]
        wfil = wfil * fcut[..., None]
        m = _gather(h @ p["in"], src) * wfil
        agg = scatter_sum(m, dst, n)
        return h + softplus(agg @ p["out1"]) @ p["out2"]

    for i in range(cfg.n_interactions):
        h = _remat(interaction, h, params[f"i{i}"])
    e_atom = softplus(h @ params["head1"]) @ params["head2"]
    return e_atom.sum(dim=(-2, -1))


def graphcast_forward(cfg, params, grid_x, g2m, mesh_e, m2g, n_mesh):
    """GraphCast-style encode-process-decode [arXiv:2212.12794].

    grid_x: (Ng, F); g2m/m2g/mesh_e: (E?, 2) index pairs + implicit unit
    edge features; n_mesh: mesh node count.  Returns (Ng, n_vars).
    """
    ng = grid_x.shape[0]
    h_grid = F.relu(grid_x @ params["enc_grid"])

    def efeat(e, n_src_nodes):
        # cheap structural edge features (degree-free): normalized ids
        one = torch.ones((e.shape[0],), dtype=h_grid.dtype, device=e.device)
        return torch.stack([e[:, 0].to(h_grid.dtype) / max(n_src_nodes, 1),
                            e[:, 1].to(h_grid.dtype) / max(n_mesh, 1), one, one * 0], -1)

    # encode grid → mesh (recomputed in the backward pass like every layer)
    def encode(h_grid):
        he = F.relu(efeat(g2m, ng) @ params["enc_g2m"])
        msg = F.relu(torch.cat([_gather(h_grid, g2m[:, 0]), he, he], -1) @ params["g2m_edge"])
        h_mesh = scatter_sum(msg, g2m[:, 1], n_mesh)
        return F.relu(torch.cat([h_mesh, h_mesh], -1) @ params["g2m_node"])

    h_mesh = _remat(encode, h_grid)
    # process on the mesh
    e_h = F.relu(efeat(mesh_e, n_mesh) @ params["enc_mesh"])

    def processor(h_mesh, e_h, p):
        em = torch.cat([e_h, _gather(h_mesh, mesh_e[:, 0]), _gather(h_mesh, mesh_e[:, 1])], -1)
        e_h = e_h + F.relu(F.relu(em @ p["edge1"]) @ p["edge2"])
        agg = scatter_sum(e_h, mesh_e[:, 1], n_mesh)
        nm = torch.cat([h_mesh, agg], -1)
        return h_mesh + F.relu(F.relu(nm @ p["node1"]) @ p["node2"]), e_h

    for i in range(cfg.n_layers):
        h_mesh, e_h = _remat(processor, h_mesh, e_h, params[f"p{i}"])

    # decode mesh → grid
    def decode(h_mesh, h_grid):
        he2 = F.relu(efeat(m2g, n_mesh) @ params["enc_m2g"])
        msg2 = F.relu(torch.cat([_gather(h_mesh, m2g[:, 0]), he2, he2], -1)
                      @ params["m2g_edge"])
        h_out = scatter_sum(msg2, m2g[:, 1], ng)
        h_out = F.relu(torch.cat([h_grid, h_out], -1) @ params["m2g_node"])
        return F.relu(h_out @ params["dec1"]) @ params["dec2"]

    return _remat(decode, h_mesh, h_grid)


# ----------------------------------------------------------------------------
# Per-cell losses and the train step
# ----------------------------------------------------------------------------


def effective_graph(shape: ShapeSpec) -> Tuple[int, int, int]:
    """(N, E, F) of the concrete graph a cell runs on.

    gnn_sampled → the sampled k-hop subgraph (disjoint-union form for
    non-SAGE archs); gnn_batched → the disjoint union of the molecule
    batch; gnn_full → as given.  N and E are padded to multiples of 512.
    """
    def pad(x):
        return -(-x // 512) * 512

    if shape.kind == "gnn_sampled":
        b = shape.batch_nodes
        f1, f2 = shape.fanout
        return pad(b * (1 + f1 + f1 * f2)), pad(b * f1 + b * f1 * f2), shape.d_feat
    if shape.kind == "gnn_batched":
        g = shape.graph_batch
        return pad(g * shape.n_nodes), pad(g * shape.n_edges), shape.d_feat
    return pad(shape.n_nodes), pad(shape.n_edges), shape.d_feat


def loss_fn(cfg: GNNConfig, shape: ShapeSpec, params, batch) -> torch.Tensor:
    """The cell's loss: node-classification cross-entropy (SAGE, GatedGCN),
    squared energy error (SchNet), mean squared error (GraphCast)."""
    if cfg.kind == "sage" and shape.kind == "gnn_sampled":
        logits = sage_forward_sampled(cfg, params, batch["feats"])
    elif cfg.kind == "sage":
        logits = sage_forward_full(cfg, params, batch["x"], batch["edges"])
    elif cfg.kind == "gatedgcn":
        logits = gatedgcn_forward(cfg, params, batch["x"], batch["edges"], batch["ew"])
    elif cfg.kind == "schnet":
        if shape.kind == "gnn_batched":
            e = schnet_forward(cfg, params, batch["z"], batch["pos"], batch["edges_t"])
            return torch.mean(torch.square(e - batch["energy"]))
        e = schnet_forward(cfg, params, batch["x"], batch["pos"], batch["edges"])
        return torch.square(e - batch["energy_sum"])
    elif cfg.kind == "graphcast":
        out = graphcast_forward(cfg, params, batch["x"], batch["g2m"], batch["mesh_e"],
                                batch["m2g"], n_mesh=batch["x"].shape[0] // 4 + 1)
        return torch.mean(torch.square(out - batch["target"]))
    else:
        raise ValueError(cfg.kind)
    logp = F.log_softmax(logits.float(), dim=-1)
    lab = batch["labels"].long()
    return -torch.mean(torch.gather(logp, 1, lab[:, None]))


def loss_and_grads(cfg: GNNConfig, shape: ShapeSpec, params, batch):
    """(loss, gradients in the params' tree), taken with respect to
    detached copies of the leaves."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = loss_fn(cfg, shape, leaves, batch)
        flat = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    return loss.detach(), tree_map(lambda _: next(flat), leaves)


def make_train_step(cfg: GNNConfig, shape: ShapeSpec, opt_cfg):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``
    for the given cell: value and gradients, then the port's AdamW, the
    parameters and moments updated in place."""

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, shape, params, batch)
        params, opt_state = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, loss

    return train_step
