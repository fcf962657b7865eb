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
reference's gather would clamp.

Distribution (``param_specs``, ``input_specs``, ``make_specs``): edges
sharded over every mesh axis, node features over the dp axes' rows with
the feature dim over "model" where divisible.  On DTensors with
``dp_axes`` every step runs SPMD: each rank gathers the node table,
computes the messages of its edge shard and scatters them into partial
node sums, which the node constraint reduces onto the row shards; the node
updates run on each rank's rows (GraphSAGE, GatedGCN, SchNet on a graph,
GraphCast's grid, mesh and their edges; a node or edge count that does not
split over the dp axes is held whole, as ``sanitize_spec`` drops the
axis).  SchNet's molecule batch runs each rank's molecules.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GNNConfig, ShapeSpec
from repro_torch.knobs import sync_free
from repro_torch.distributed.sharding import (P, NamedSharding, ShapeDtypeStruct, constrain,
                                              entry_axes, full, is_dtensor, like,
                                              local_call, named_sharding, sanitize_spec)
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


def counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of ``0 .. n-1`` occurs in ``idx``, exactly (a
    ``bincount`` whose shape is known ahead, not the data's)."""
    idx = idx.long()
    return torch.zeros(n, dtype=torch.long, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def seg_mean(msg, dst, n):
    s = scatter_sum(msg, dst, n)
    c = counts(dst, n).to(msg.dtype)[:, None]  # exact counts
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


def param_table(cfg: GNNConfig, d_feat: int) -> Dict[str, tuple]:
    """Flat {path: (shape, dtype, spec)}."""
    dt = cfg.torch_dtype
    h = cfg.d_hidden
    defs: Dict[str, tuple] = {}

    def lin(name, din, dout, spec=(None, "model")):
        defs[name] = ((din, dout), dt, spec)

    if cfg.kind == "sage":
        din = d_feat
        for i in range(cfg.n_layers):
            lin(f"l{i}.self", din, h)
            lin(f"l{i}.nbr", din, h)
            din = h
        lin("out", h, cfg.n_classes, (None, None))
    elif cfg.kind == "gatedgcn":
        lin("enc", d_feat, h)
        lin("enc_e", 1, h, (None, None))
        for i in range(cfg.n_layers):
            for nm in ("A", "B", "D", "E", "U", "V"):
                lin(f"l{i}.{nm}", h, h)
            defs[f"l{i}.ln_n"] = ((h,), dt, (None,))
            defs[f"l{i}.ln_e"] = ((h,), dt, (None,))
        lin("out", h, cfg.n_classes, (None, None))
    elif cfg.kind == "schnet":
        lin("embed", d_feat, h, (None, None))
        for i in range(cfg.n_interactions):
            lin(f"i{i}.filter1", cfg.rbf, h, (None, None))
            lin(f"i{i}.filter2", h, h)
            lin(f"i{i}.in", h, h)
            lin(f"i{i}.out1", h, h)
            lin(f"i{i}.out2", h, h)
        lin("head1", h, h)
        lin("head2", h, 1, (None, None))
    elif cfg.kind == "graphcast":
        lin("enc_grid", d_feat, h)
        lin("enc_g2m", 4, h, (None, None))
        lin("enc_mesh", 4, h, (None, None))
        lin("enc_m2g", 4, h, (None, None))
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
        lin("dec2", h, cfg.n_vars, (None, None))
    else:
        raise ValueError(cfg.kind)
    return defs


def param_defs(cfg: GNNConfig, d_feat: int) -> Dict[str, tuple]:
    """Flat {path: (shape, dtype)} (``param_table`` without specs)."""
    return {k: (shape, dt) for k, (shape, dt, _) in param_table(cfg, d_feat).items()}


def _nest(flat):
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split(".")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def param_specs(cfg: GNNConfig, d_feat: int, mesh):
    """Nested {path: ShapeDtypeStruct} with each weight's sharding."""
    flat = {k: ShapeDtypeStruct(shape, dt, named_sharding(mesh, shape, *spec))
            for k, (shape, dt, spec) in param_table(cfg, d_feat).items()}
    return _nest(flat)


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


def _cons(x, spec):
    """Sharding constraint; skipped when spec is None (and a no-op on a
    plain tensor)."""
    if spec is None:
        return x
    return constrain(x, spec)


def make_specs(dp_axes, h):
    """(node_spec, edge_spec) for message passing.

    Edge tensors: rows over EVERY mesh axis (edge MLPs contract the full
    feature dim anyway).  Node tensors: rows over dp, features over "model"
    when divisible (2D-SpMV), else replicated (gatedgcn's 70)."""
    if not dp_axes:
        return None, None
    espec = P((*dp_axes, "model"), None)
    nspec = P(dp_axes, "model") if h % 16 == 0 else P(dp_axes, None)
    return nspec, espec


def _check_dp(dp_axes, *xs):
    if any(is_dtensor(x) for x in xs) and not dp_axes:
        raise ValueError("DTensor inputs need dp_axes (the batch's mesh axes)")


def _layouts(dp_axes, h):
    """(node constraint, edge constraint, node rows, edge rows, the edge
    axes) of ``local_call``; the constraints None without ``dp_axes``."""
    nspec, espec = make_specs(dp_axes, h)
    eax = (*dp_axes, "model")
    return nspec, espec, P(dp_axes, None), P(eax, None), eax


def sage_forward_full(cfg, params, x, edges, dp_axes=()):
    """Full-graph GraphSAGE (mean aggregator).

    On DTensors, per layer, each rank's edge shard gathers its sources
    from the whole node table (no split of a gather by arbitrary ids: the
    table is gathered) and scatters partial sums into every row; the node
    constraint reduces them onto the row shards."""
    _check_dp(dp_axes, x, edges)
    n = x.shape[0]
    nspec, _, rows, erows, eax = _layouts(dp_axes, cfg.d_hidden)
    rep = P()

    def messages(h, e):
        msg = _gather(h, e[:, 0])
        s = scatter_sum(msg, e[:, 1], n)
        c = counts(e[:, 1], n).to(msg.dtype)[:, None]  # exact counts
        return s, c

    def node(h, s, c, p):
        nbr = s / torch.clamp(c, min=1.0)
        return _l2_normalize(F.relu(h @ p["self"] + nbr @ p["nbr"]))

    def layer(h, p):
        s, c = local_call(messages, (h, edges), (rep, erows), (rep, rep), partial=eax)
        h = local_call(node, (h, s, c, p), (rows, rows, rows, rep), rows)
        return _cons(h, nspec)

    h = x
    for i in range(cfg.n_layers):
        h = _remat(layer, h, params[f"l{i}"])
    return local_call(lambda h, w: h @ w, (h, params["out"]), (rows, rep), rows)


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


def gatedgcn_forward(cfg, params, x, edges, ew, dp_axes=()):
    """GatedGCN [arXiv:2003.00982]: edge-gated mean aggregation.

    On DTensors the edge update, gate and messages run on each rank's edge
    shard (the node table gathered), the gate and message sums are reduced
    onto the node rows, the node update runs on each rank's rows."""
    _check_dp(dp_axes, x, edges, ew)
    n = x.shape[0]
    nspec, espec, rows, erows, eax = _layouts(dp_axes, cfg.d_hidden)
    rep = P()
    h = _cons(local_call(lambda x, w: x @ w, (x, params["enc"]), (rows, rep), rows), nspec)
    e = _cons(local_call(lambda ew, w: ew[:, None] @ w, (ew, params["enc_e"]),
                         (P(eax), rep), erows), espec)

    def edge(h, e, ed, p):
        hs = _gather(h, ed[:, 0])
        hd = _gather(h, ed[:, 1])
        eh = e @ p["D"] + hs @ p["E"] + hd @ p["V"]
        e_new = e + F.relu(_ln(eh, p["ln_e"]))
        gate = torch.sigmoid(e_new)
        msg = gate * (hs @ p["B"])
        # the bf16 edge-feature carry of the reference: a rounding step of
        # the model, its gradient rounded through the same two casts
        return (scatter_sum(gate, ed[:, 1], n), scatter_sum(msg, ed[:, 1], n),
                e_new.to(torch.bfloat16).to(e.dtype))

    def node(h, den, agg, p):
        agg = agg / (den + 1e-6)
        return h + F.relu(_ln(h @ p["A"] + agg @ p["U"], p["ln_n"]))

    def layer(h, e, p):
        den, agg, e_new = local_call(edge, (h, e, edges, p), (rep, erows, erows, rep),
                                     (rep, rep, erows), partial=eax)
        h_new = local_call(node, (h, den, agg, p), (rows, rows, rows, rep), rows)
        return _cons(h_new, nspec), _cons(e_new, espec)

    for i in range(cfg.n_layers):
        h, e = _remat(layer, h, e, params[f"l{i}"])
    return local_call(lambda h, w: h @ w, (h, params["out"]), (rows, rep), rows)


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


def _fit(ref, shape, spec) -> P:
    """``spec`` with the axes that do not split ``shape`` dropped, on the
    mesh of ``ref`` (``spec`` itself for a plain tensor)."""
    return sanitize_spec(ref.device_mesh, shape, spec) if is_dtensor(ref) else P(*spec)


def _edge_layout(e, eax):
    """(in-spec, partial axes) of an edge array split over ``eax`` as far as
    its length allows: the messages of each rank's edges are a term of a sum
    over exactly the axes that split them."""
    spec = _fit(e, e.shape, P(eax, None))
    return spec, entry_axes(spec[0])


def schnet_forward(cfg, params, z_feat, pos, edges, dp_axes=()):
    """SchNet [arXiv:1706.08566]: continuous-filter convolutions.

    z_feat: (N, F) atom-type features; pos: (N, 3); edges: (E, 2).  Returns
    the sum-pooled energy of the graph.  With a leading molecule axis
    (z_feat (G, N, F), pos (G, N, 3)) every molecule shares the edge
    template and the result is (G,): the reference's ``jax.vmap``.

    On DTensors (a graph, not a molecule batch) each rank's edge shard
    computes its geometry and filters once, then per interaction its
    messages into partial node sums; the node updates run on each rank's
    rows and the energy is summed over them.
    """
    _check_dp(dp_axes, z_feat, pos, edges)
    n = z_feat.shape[-2]
    nspec, _, rows, _, eax = _layouts(dp_axes, cfg.d_hidden)
    es, ep = _edge_layout(edges, eax)
    rep = P()
    h = _cons(local_call(lambda z, w: z @ w, (z_feat, params["embed"]), (rows, rep), rows),
              nspec)

    def geometry(pos, e):
        d = torch.linalg.vector_norm(_gather(pos, e[:, 0]) - _gather(pos, e[:, 1]) + 1e-9,
                                     dim=-1)
        mu = rbf_centers(cfg, pos.dtype, pos.device)
        gamma = 10.0 / cfg.cutoff
        rbf = torch.exp(-gamma * torch.square(d[..., None] - mu))  # (..., E, rbf)
        # smooth cutoff
        return rbf, 0.5 * (torch.cos(math.pi * torch.clamp(d / cfg.cutoff, 0, 1)) + 1.0)

    rbf, fcut = local_call(geometry, (pos, edges), (rep, es), (es, P(es[0])))

    def messages(h, rbf, fcut, e, p):
        wfil = softplus(rbf @ p["filter1"]) @ p["filter2"]
        wfil = wfil * fcut[..., None]
        m = _gather(h @ p["in"], e[:, 0]) * wfil
        return scatter_sum(m, e[:, 1], n)

    def interaction(h, p):
        agg = local_call(messages, (h, rbf, fcut, edges, p), (rep, es, P(es[0]), es, rep), rep,
                         partial=ep)
        h = local_call(lambda h, agg, p: h + softplus(agg @ p["out1"]) @ p["out2"],
                       (h, agg, p), (rows, rows, rep), rows)
        return _cons(h, nspec)

    for i in range(cfg.n_interactions):
        h = _remat(interaction, h, params[f"i{i}"])
    head = {k: params[k] for k in ("head1", "head2")}
    e = local_call(lambda h, w: (softplus(h @ w["head1"]) @ w["head2"]).sum(dim=(-2, -1)),
                   (h, head), (rows, rep), P(), partial=tuple(dp_axes))
    return full(e)


def graphcast_forward(cfg, params, grid_x, g2m, mesh_e, m2g, n_mesh, dp_axes=()):
    """GraphCast-style encode-process-decode [arXiv:2212.12794].

    grid_x: (Ng, F); g2m/m2g/mesh_e: (E?, 2) index pairs + implicit unit
    edge features; n_mesh: mesh node count.  Returns (Ng, n_vars).

    On DTensors each rank's shard of every edge array sends its messages
    into partial sums over the target nodes (the source table gathered);
    the grid's and the mesh's node updates run on each rank's rows (the
    mesh's whole where n_mesh does not split over the dp axes).
    """
    _check_dp(dp_axes, grid_x, g2m, mesh_e, m2g)
    ng = grid_x.shape[0]
    h = cfg.d_hidden
    nspec, _, _, _, eax = _layouts(dp_axes, h)
    rep = P()
    grows = _fit(grid_x, grid_x.shape, P(dp_axes, None))
    mrows = _fit(grid_x, (n_mesh, h), P(dp_axes, None))
    (gs, gp), (ms, mp), (ds, dq) = (_edge_layout(e, eax) for e in (g2m, mesh_e, m2g))

    def efeat(e, n_src_nodes, dtype):
        # cheap structural edge features (degree-free): normalized ids
        one = torch.ones((e.shape[0],), dtype=dtype, device=e.device)
        return torch.stack([e[:, 0].to(dtype) / max(n_src_nodes, 1),
                            e[:, 1].to(dtype) / max(n_mesh, 1), one, one * 0], -1)

    h_grid = _cons(local_call(lambda x, w: F.relu(x @ w), (grid_x, params["enc_grid"]),
                              (grows, rep), grows), nspec)
    enc = {k: params[k] for k in ("enc_g2m", "g2m_edge")}

    # encode grid → mesh (recomputed in the backward pass like every layer)
    def encode(h_grid):
        def msgs(hg, e, w):
            he = F.relu(efeat(e, ng, hg.dtype) @ w["enc_g2m"])
            msg = F.relu(torch.cat([_gather(hg, e[:, 0]), he, he], -1) @ w["g2m_edge"])
            return scatter_sum(msg, e[:, 1], n_mesh)

        h_mesh = local_call(msgs, (h_grid, g2m, enc), (rep, gs, rep), rep, partial=gp)
        return local_call(lambda hm, w: F.relu(torch.cat([hm, hm], -1) @ w),
                          (h_mesh, params["g2m_node"]), (mrows, rep), mrows)

    h_mesh = _cons(_remat(encode, h_grid), nspec)
    # process on the mesh
    e_h = local_call(lambda e, w: F.relu(efeat(e, n_mesh, w.dtype) @ w),
                     (mesh_e, params["enc_mesh"]), (ms, rep), ms)

    def edge(hm, eh, e, p):
        em = torch.cat([eh, _gather(hm, e[:, 0]), _gather(hm, e[:, 1])], -1)
        eh = eh + F.relu(F.relu(em @ p["edge1"]) @ p["edge2"])
        return eh, scatter_sum(eh, e[:, 1], n_mesh)

    def node(hm, agg, p):
        nm = torch.cat([hm, agg], -1)
        return hm + F.relu(F.relu(nm @ p["node1"]) @ p["node2"])

    def processor(h_mesh, e_h, p):
        e_h, agg = local_call(edge, (h_mesh, e_h, mesh_e, p), (rep, ms, ms, rep), (ms, rep),
                              partial=mp)
        h_mesh = local_call(node, (h_mesh, agg, p), (mrows, mrows, rep), mrows)
        return _cons(h_mesh, nspec), e_h

    for i in range(cfg.n_layers):
        h_mesh, e_h = _remat(processor, h_mesh, e_h, params[f"p{i}"])

    # decode mesh → grid
    dec = {k: params[k] for k in ("enc_m2g", "m2g_edge", "m2g_node", "dec1", "dec2")}

    def decode(h_mesh, h_grid):
        def msgs(hm, e, w):
            he2 = F.relu(efeat(e, n_mesh, hm.dtype) @ w["enc_m2g"])
            msg2 = F.relu(torch.cat([_gather(hm, e[:, 0]), he2, he2], -1) @ w["m2g_edge"])
            return scatter_sum(msg2, e[:, 1], ng)

        h_out = local_call(msgs, (h_mesh, m2g, dec), (rep, ds, rep), rep, partial=dq)

        def out(hg, ho, w):
            ho = F.relu(torch.cat([hg, ho], -1) @ w["m2g_node"])
            return F.relu(ho @ w["dec1"]) @ w["dec2"]

        return local_call(out, (h_grid, h_out, dec), (grows, grows, rep), grows)

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


def _xent_rows(logits, lab):
    logp = F.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, 1, lab.long()[:, None])


def loss_fn(cfg: GNNConfig, shape: ShapeSpec, params, batch, dp_axes=()) -> torch.Tensor:
    """The cell's loss: node-classification cross-entropy (SAGE, GatedGCN),
    squared energy error (SchNet), mean squared error (GraphCast)."""
    if cfg.kind == "sage" and shape.kind == "gnn_sampled":
        logits = sage_forward_sampled(cfg, params, batch["feats"])
    elif cfg.kind == "sage":
        logits = sage_forward_full(cfg, params, batch["x"], batch["edges"], dp_axes)
    elif cfg.kind == "gatedgcn":
        logits = gatedgcn_forward(cfg, params, batch["x"], batch["edges"], batch["ew"],
                                  dp_axes)
    elif cfg.kind == "schnet":
        if shape.kind == "gnn_batched":
            # each rank's molecules: its mean, weighted by its share of them
            G = batch["z"].shape[0]
            mol = P(dp_axes, None, None)

            def local(p, z, pos, e, en):
                err = schnet_forward(cfg, p, z, pos, e) - en
                return torch.mean(torch.square(err)) * (en.shape[0] / G)

            _check_dp(dp_axes, batch["z"])
            return full(local_call(local, (params, batch["z"], batch["pos"], batch["edges_t"],
                                           batch["energy"]),
                                   (P(), mol, mol, P(), P(dp_axes)), P(),
                                   partial=tuple(dp_axes)))
        e = schnet_forward(cfg, params, batch["x"], batch["pos"], batch["edges"], dp_axes)
        return torch.square(e - full(batch["energy_sum"]))
    elif cfg.kind == "graphcast":
        out = graphcast_forward(cfg, params, batch["x"], batch["g2m"], batch["mesh_e"],
                                batch["m2g"], n_mesh=batch["x"].shape[0] // 4 + 1,
                                dp_axes=dp_axes)
        n = out.shape[0]
        rows = _fit(out, out.shape, P(dp_axes, None))
        return full(local_call(
            lambda o, t: torch.mean(torch.square(o - t)) * (o.shape[0] / n),
            (out, batch["target"]), (rows, rows), P(),
            partial=entry_axes(rows[0])))
    else:
        raise ValueError(cfg.kind)
    # each rank's rows: its mean, weighted by its share of the nodes (the
    # whole graph: the mean itself)
    n = logits.shape[0]
    part = local_call(lambda lg, lab: -torch.mean(_xent_rows(lg, lab)) * (lab.shape[0] / n),
                      (logits, batch["labels"]), (P(dp_axes, None), P(dp_axes)), P(),
                      partial=tuple(dp_axes))
    return full(part)


def loss_and_grads(cfg: GNNConfig, shape: ShapeSpec, params, batch, dp_axes=()):
    """(loss, gradients in the params' tree), taken with respect to
    detached copies of the leaves; on DTensors each gradient laid out like
    its parameter."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = loss_fn(cfg, shape, leaves, batch, dp_axes)
        flat = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    grads = tree_map(lambda p: like(next(flat), p), leaves)
    return loss.detach(), grads


def make_train_step(cfg: GNNConfig, shape: ShapeSpec, opt_cfg, dp_axes=()):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``
    for the given cell: value and gradients, then the port's AdamW, the
    parameters and moments updated in place."""

    @sync_free
    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, shape, params, batch, dp_axes)
        params, opt_state = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, loss

    return train_step


def input_specs(cfg: GNNConfig, shape: ShapeSpec, mesh, dp_axes=("data",)):
    """Input ShapeDtypeStructs per GNN cell: every array's rows over
    ``dp_axes``, SchNet's edge template and energy sum replicated."""
    dt = cfg.torch_dtype
    rep = NamedSharding(mesh, P())

    def arr(shape_, dtype, sh=None):
        if sh is None:
            sh = named_sharding(mesh, shape_, dp_axes, *([None] * (len(shape_) - 1)))
        return ShapeDtypeStruct(shape_, dtype, sh)

    N, E, F_ = effective_graph(shape)
    i32 = torch.int32
    if cfg.kind == "sage" and shape.kind == "gnn_sampled":
        B = shape.batch_nodes
        f1, f2 = shape.fanout
        return {
            "feats": (arr((B, F_), dt), arr((B * f1, F_), dt), arr((B * f1 * f2, F_), dt)),
            "labels": arr((B,), i32),
        }
    if cfg.kind == "sage":
        return {"x": arr((N, F_), dt), "edges": arr((E, 2), i32), "labels": arr((N,), i32)}
    if cfg.kind == "gatedgcn":
        return {"x": arr((N, F_), dt), "edges": arr((E, 2), i32), "ew": arr((E,), dt),
                "labels": arr((N,), i32)}
    if cfg.kind == "schnet":
        if shape.kind == "gnn_batched":
            G = shape.graph_batch
            n1, e1 = shape.n_nodes, shape.n_edges  # per molecule
            return {
                "z": arr((G, n1, F_), dt),
                "pos": arr((G, n1, 3), dt),
                "edges_t": arr((e1, 2), i32, rep),
                "energy": arr((G,), dt),
            }
        return {"x": arr((N, F_), dt), "pos": arr((N, 3), dt), "edges": arr((E, 2), i32),
                "energy_sum": arr((), dt, rep)}
    if cfg.kind == "graphcast":
        n_mesh = N // 4 + 1
        em = min(E, 8 * n_mesh)
        return {
            "x": arr((N, F_), dt),
            "g2m": arr((E, 2), i32),
            "mesh_e": arr((em, 2), i32),
            "m2g": arr((E, 2), i32),
            "target": arr((N, cfg.n_vars), dt),
        }
    raise ValueError((cfg.kind, shape.kind))
