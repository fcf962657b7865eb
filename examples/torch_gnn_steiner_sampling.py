"""Steiner-tree-driven GNN training on the PyTorch port.

    PYTHONPATH=src python examples/torch_gnn_steiner_sampling.py
    PYTHONPATH=src python examples/torch_gnn_steiner_sampling.py --device cpu

The counterpart of examples/gnn_steiner_sampling.py, the same program: the
paper's use case (§I) is explaining connections between seed entities, and
here the Steiner engine becomes a *subgraph sampler* for GNN training.  For
each batch of 12 random seed vertices of an RMAT scale-11 graph, the
2-approximate Steiner tree connecting them (``steiner_tree``, mode
"bucket") plus its 1-hop halo is the training subgraph of one AdamW step of
the reduced graphsage-reddit model, 8 steps in all.  Runs on the GPU unless
``--device cpu`` is given.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.graph import from_edges
from repro_torch.core.steiner import steiner_tree
from repro_torch.data.graphs import rmat_edges
from repro_torch.models import gnn as gnn_mod
from repro_torch.optim import OptConfig, adamw_init


def steiner_subgraph(g, src, dst, seeds, n, solve=None):
    """Vertices of the Steiner tree + 1-hop halo, as a relabeled subgraph.

    ``src``/``dst``: one direction of every edge, as tensors on the graph's
    device; ``solve(seeds)`` gives the tree's ``SteinerResult`` (by default
    ``steiner_tree(g, seeds)``).  Returns (vertex ids, (E', 2) int32 edges
    among them renumbered, the tree's total distance)."""
    res = steiner_tree(g, seeds) if solve is None else solve(seeds)
    marked = res.tree.in_tree_vertex
    halo = marked.clone()
    halo[src[marked[dst]]] = True  # 1-hop in-neighbors of tree vertices
    halo[dst[marked[src]]] = True
    verts = torch.nonzero(halo).flatten()
    remap = torch.full((n,), -1, dtype=torch.int64, device=halo.device)
    remap[verts] = torch.arange(len(verts), device=halo.device)
    keep = halo[src] & halo[dst]
    e = torch.stack([remap[src[keep]], remap[dst[keep]]], 1).to(torch.int32)
    return verts, e, float(res.tree.total_distance)


def train_on_steiner_subgraphs(g, src, dst, n, feats, labels, cfg, params, opt_cfg, rng, *,
                               steps=8, n_seeds=12, solve=None, log=print):
    """``steps`` AdamW steps of ``cfg`` (``params`` updated in place), each on
    the Steiner subgraph of ``n_seeds`` seeds drawn from ``rng`` without
    replacement.  ``feats`` (n, F) and ``labels`` (n,) are tensors on the
    graph's device.  Returns one record a step: seeds, vertices, edges,
    total distance, loss, seconds."""
    opt_state = adamw_init(params, opt_cfg)
    records = []
    for step in range(steps):
        t0 = time.perf_counter()
        seeds = rng.choice(n, size=n_seeds, replace=False).astype(np.int32)
        verts, sub_edges, D = steiner_subgraph(g, src, dst, seeds, n, solve)
        shape = ShapeSpec(name="steiner_batch", kind="gnn_full", n_nodes=len(verts),
                          n_edges=len(sub_edges), d_feat=feats.shape[1])
        train = gnn_mod.make_train_step(cfg, shape, opt_cfg)
        batch = {"x": feats[verts], "edges": sub_edges, "labels": labels[verts]}
        params, opt_state, loss = train(params, opt_state, batch)
        records.append({"seeds": seeds, "verts": verts, "edges": sub_edges, "D": D,
                        "loss": float(loss), "s": time.perf_counter() - t0})
        log(f"step {step}: steiner D={D:7.0f}, subgraph |V|={len(verts):5d} "
            f"|E|={len(sub_edges):6d}, loss={records[-1]['loss']:.4f}")
    return records


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()

    dev = torch.device(args.device)
    rng = np.random.default_rng(0)
    src, dst, w, n = rmat_edges(11, 8, max_weight=50, seed=3)
    g = from_edges(src, dst, w, n, pad_to=64, device=dev)
    # synthetic node features/labels: label = community-ish hash
    feats = torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32)).to(dev)
    labels = torch.from_numpy((np.arange(n) * 2654435761 % 5).astype(np.int32)).to(dev)

    cfg = get_arch("graphsage-reddit").reduced
    gen = torch.Generator(device=dev).manual_seed(0)
    params = gnn_mod.init_params(cfg, 16, gen)
    records = train_on_steiner_subgraphs(
        g, torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev), n, feats, labels,
        cfg, params, OptConfig(lr=1e-2), rng, steps=args.steps)
    losses = [r["loss"] for r in records]
    assert losses[-1] < losses[0], losses
    print("GNN learns on Steiner-sampled subgraphs: OK")


if __name__ == "__main__":
    main()
