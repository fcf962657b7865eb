"""Steiner tree edge identification (paper Alg. 2 Steps 4-6 / Alg. 6).

After the MST of the distance graph is known, every cross-cell bridge whose
seed pair is not an MST edge is pruned (one bridge per MST pair), and the
predecessor pointers are walked from both endpoints of each surviving
bridge back to the owning seeds by pointer doubling, as in
``repro.core.tree``.  Two identities keep this lookup-free:

  * weight of tree edge (pred[v], v)  =  dist[v] - dist[pred[v]]
  * weight of the bridge of MST pair p =  dmat[p] - dist[u_p] - dist[v_p]
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.mst import mst_pairs
from repro_torch.core.voronoi import VoronoiState


@dataclasses.dataclass(frozen=True)
class SteinerTree:
    """Dense encoding of the output Steiner tree G_S.

    In-cell path edges are ``(pred[v], v)`` for every ``path_edge[v]``;
    cross-cell bridges are ``(bridge_u[i], bridge_v[i])`` for every
    ``bridge_valid[i]`` (one per MST pair).
    """

    in_tree_vertex: torch.Tensor  # (N,) bool
    path_edge: torch.Tensor  # (N,) bool
    bridge_u: torch.Tensor  # (S,) i32
    bridge_v: torch.Tensor  # (S,) i32
    bridge_w: torch.Tensor  # (S,) f32
    bridge_valid: torch.Tensor  # (S,) bool
    total_distance: torch.Tensor  # f32 scalar: D(G_S)
    num_edges: torch.Tensor  # i32 scalar: |E_S|


def bridge_endpoints(
    dmat: torch.Tensor,
    umat: torch.Tensor,
    vmat: torch.Tensor,
    dist: torch.Tensor,
    parent: torch.Tensor,
    S: int,
):
    """Alg. 2 Step 4: the surviving bridge (u, v, w) per MST pair.

    Row i describes the bridge of MST edge (parent[i], i); the root row
    (parent[i] == i) is invalid.
    """
    keys = mst_pairs(parent, S)
    valid = keys < S * S
    k = torch.clamp(keys, max=S * S - 1)
    bu = torch.where(valid, umat[k], 0)
    bv = torch.where(valid, vmat[k], 0)
    bw = torch.where(valid, dmat[k] - dist[bu] - dist[bv], 0.0)
    return bu, bv, bw, valid


def mark_paths(st: VoronoiState, endpoints: torch.Tensor) -> torch.Tensor:
    """Marks every vertex on the pred-chain from ``endpoints`` to its seed.

    Pointer doubling: each round marks the pointer targets of the marked
    vertices, then squares the pointer; one host sync a round.  Only the
    marked entries are scattered (the reference takes a segment max over
    every vertex), which gives the same marks.
    """
    marked = endpoints
    ptr = st.pred
    while True:
        new = marked.clone()
        new[ptr[marked]] = True
        ptr = ptr[ptr]
        done = not bool(torch.any(new != marked))
        obs.host_read(2)  # the masked gather and the flag
        if done:
            return new
        marked = new


def extract_tree(
    n: int,
    st: VoronoiState,
    dmat: torch.Tensor,
    umat: torch.Tensor,
    vmat: torch.Tensor,
    parent: torch.Tensor,
    S: int,
) -> SteinerTree:
    """Alg. 2 Steps 4-7: prune bridges, walk predecessors, total distance."""
    bu, bv, bw, bvalid = bridge_endpoints(dmat, umat, vmat, st.dist, parent, S)
    endpoints = torch.zeros(n, dtype=torch.bool, device=st.dist.device)
    endpoints[bu[bvalid]] = True
    endpoints[bv[bvalid]] = True
    obs.host_read(2)  # the two masked gathers
    marked = mark_paths(st, endpoints)

    # In-cell tree edges: (pred[v], v) for marked non-root vertices.
    ids = torch.arange(n, dtype=torch.int32, device=st.pred.device)
    path_edge = marked & (st.pred != ids)
    path_w = torch.where(path_edge, st.dist - st.dist[st.pred], 0.0)
    total = path_w.sum() + bw.sum()
    nedges = path_edge.sum() + bvalid.sum()
    return SteinerTree(
        in_tree_vertex=marked,
        path_edge=path_edge,
        bridge_u=bu,
        bridge_v=bv,
        bridge_w=bw,
        bridge_valid=bvalid,
        total_distance=total,
        num_edges=nedges.to(torch.int32),
    )


def tree_edge_sets(st: VoronoiState, tree: SteinerTree, n_lanes=None):
    """Host-side: the undirected edge set {(u, v)} of G_S per lane.

    Arrays may carry a leading (B,) lane axis or none (one lane);
    ``n_lanes`` materializes (and fetches) only the first lanes.

    Returns:
      list of ``frozenset[(u, v)]``, one per materialized lane.
    """

    def fetch(x):
        x = x if x.dim() == 2 else x[None]
        return (x if n_lanes is None else x[:n_lanes]).cpu().numpy()

    pred, pe = fetch(st.pred), fetch(tree.path_edge)
    bu, bv, bvalid = fetch(tree.bridge_u), fetch(tree.bridge_v), fetch(tree.bridge_valid)
    lanes = pe.shape[0]
    out = []
    for i in range(lanes):
        es = set()
        for v in np.nonzero(pe[i])[0]:
            a, b = int(pred[i, v]), int(v)
            es.add((min(a, b), max(a, b)))
        for j in np.nonzero(bvalid[i])[0]:
            a, b = int(bu[i, j]), int(bv[i, j])
            es.add((min(a, b), max(a, b)))
        out.append(frozenset(es))
    return out


def tree_edge_list(st: VoronoiState, tree: SteinerTree):
    """Host-side: materializes the undirected edge set {(u, v)} of G_S
    (single lane; thin wrapper over :func:`tree_edge_sets`)."""
    return set(tree_edge_sets(st, tree)[0])
