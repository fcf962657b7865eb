"""The Steiner pipeline after the Voronoi fixpoint (paper Alg. 2 Steps 2-7).

  2. distance graph G'1 (min cross-cell bridges)      distance_graph.py
  3. MST G'2 of G'1 (Prim)                            mst.py
  4. bridge pruning to the MST pairs                  tree.py
  5. predecessor walk -> tree edges, total distance   tree.py

Approximation bound: D(G_S)/D_min <= 2(1 - 1/l) (Mehlhorn).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import distance_graph as dgmod
from repro_torch.core import mst as mstmod
from repro_torch.core import tree as treemod
from repro_torch.core import voronoi as vmod
from repro_torch.core.graph import Graph


@dataclasses.dataclass(frozen=True)
class SteinerResult:
    tree: treemod.SteinerTree
    state: vmod.VoronoiState
    stats: vmod.VoronoiStats
    parent: torch.Tensor  # (S,) MST parent over seed indices
    dmat: torch.Tensor  # (S*S,) distance-graph weights


def finish_pipeline(
    g: Graph,
    st: vmod.VoronoiState,
    stats: vmod.VoronoiStats,
    S: int,
    mst_algo: str = "prim",
) -> SteinerResult:
    """Stages 2-5 (distance graph -> MST -> pruning -> walk) from converged
    Voronoi state."""
    if mst_algo == "boruvka":
        raise NotImplementedError(
            "mst_algo='boruvka' is not ported yet: see ROADMAP.md, queue 1 "
            "(modules to port)"
        )
    if mst_algo != "prim":
        raise ValueError(f"unknown mst_algo: {mst_algo!r}")
    dmat, umat, vmat = dgmod.distance_graph(g, st, S)
    wmat = dmat.view(S, S)
    wmat = torch.minimum(wmat, wmat.T)  # symmetrize upper-triangular table
    wmat.fill_diagonal_(float("inf"))
    parent = mstmod.prim_dense(wmat)
    tree = treemod.extract_tree(g.n, st, dmat, umat, vmat, parent, S)
    return SteinerResult(tree=tree, state=st, stats=stats, parent=parent, dmat=dmat)
