"""End-to-end 2-approximation Steiner tree (paper Alg. 2 / Alg. 3), one device.

  1. Voronoi cells (multi-source shortest paths)      voronoi.py
  2. distance graph G'1 (min cross-cell bridges)      distance_graph.py
  3. MST G'2 of G'1 (Prim or Borůvka)                mst.py
  4. bridge pruning to the MST pairs                  tree.py
  5. predecessor walk -> tree edges, total distance   tree.py

Approximation bound: D(G_S)/D_min <= 2(1 - 1/l) (Mehlhorn).
:func:`run_pipeline` runs all five stages over the COO graph (modes "dense"
and "bucket"); :func:`steiner_tree` is the reference's shim over the
``"single"`` solver backend.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core import distance_graph as dgmod
from repro_torch.core import mst as mstmod
from repro_torch.core import tree as treemod
from repro_torch.core import voronoi as vmod
from repro_torch.core.graph import EllGraph, Graph


@dataclasses.dataclass(frozen=True)
class SteinerResult:
    tree: treemod.SteinerTree
    state: vmod.VoronoiState
    stats: vmod.VoronoiStats
    parent: torch.Tensor  # (S,) MST parent over seed indices
    dmat: torch.Tensor  # (S*S,) distance-graph weights


def mst_parent(dmat: torch.Tensor, S: int, mst_algo: str) -> torch.Tensor:
    """The MST parent array of the (S*S,) upper-triangular pair table."""
    wmat = dmat.view(S, S)
    wmat = torch.minimum(wmat, wmat.T)  # symmetrize upper-triangular table
    wmat.fill_diagonal_(float("inf"))
    if mst_algo == "prim":
        return mstmod.prim_dense(wmat)
    return mstmod.boruvka_dense(wmat)


def finish_pipeline(
    g: Graph,
    st: vmod.VoronoiState,
    stats: vmod.VoronoiStats,
    S: int,
    mst_algo: str = "prim",
) -> SteinerResult:
    """Stages 2-5 (distance graph -> MST -> pruning -> walk) from converged
    Voronoi state."""
    if mst_algo not in ("prim", "boruvka"):
        raise ValueError(f"unknown mst_algo: {mst_algo!r}")
    dmat, umat, vmat = dgmod.distance_graph(g, st, S)
    # Prim never syncs: on the card the span times its one launch (the
    # kernel's device time shows under its own name in a device trace); on
    # the CPU it times the plain loop's S - 1 steps
    with obs.child("solve:mst", "solve:tail"):
        parent = mst_parent(dmat, S, mst_algo)
    tree = treemod.extract_tree(g.n, st, dmat, umat, vmat, parent, S)
    return SteinerResult(tree=tree, state=st, stats=stats, parent=parent, dmat=dmat)


def run_pipeline(
    g: Graph,
    seeds: torch.Tensor,
    *,
    num_seeds: Optional[int] = None,
    mode: str = "bucket",
    mst_algo: str = "prim",
    delta: Optional[float] = None,
    max_iters: Optional[int] = None,
    telemetry_rounds: int = 0,
    init: Optional[vmod.VoronoiState] = None,
) -> SteinerResult:
    """The full pipeline over the COO graph (modes "dense" and "bucket"),
    on the graph's device.

    ``telemetry_rounds`` sizes the per-round telemetry buffer returned as
    ``result.stats.history`` (0: None); ``init`` warm-starts the Voronoi
    relaxation (see :func:`repro_torch.core.voronoi.voronoi_cells`).
    """
    S = int(num_seeds if num_seeds is not None else seeds.shape[0])
    st, stats = vmod.voronoi_cells(
        g, seeds, mode=mode, delta=delta, max_iters=max_iters,
        telemetry_rounds=telemetry_rounds, init=init,
    )
    return finish_pipeline(g, st, stats, S, mst_algo)


def steiner_tree(
    g: Graph,
    seeds,
    *,
    num_seeds: Optional[int] = None,
    mode: str = "bucket",
    mst_algo: str = "prim",
    delta: Optional[float] = None,
    max_iters: Optional[int] = None,
    ell: Optional[EllGraph] = None,
    ell_width: int = 32,
    frontier_size: int = 1024,
) -> SteinerResult:
    """Computes a 2-approximate Steiner minimal tree for (g, seeds) on the
    graph's device.

    The reference's thin shim over the ``"single"`` backend of
    :mod:`repro_torch.solver`, with the same arguments: ``mode`` is "dense"
    | "bucket" | "frontier" | "pallas"; ``ell`` a prebuilt ELL view for
    "frontier"/"pallas" (else the memoized view of width ``ell_width``);
    ``frontier_size`` the top-K rows a round of mode "frontier".

    Returns:
      SteinerResult; ``result.tree.total_distance`` is D(G_S).
    """
    from repro_torch.solver.config import SolverConfig
    from repro_torch.solver.registry import get_backend

    cfg = SolverConfig(
        backend="single", mode=mode, mst_algo=mst_algo, delta=delta, max_iters=max_iters,
        ell_width=ell_width, frontier_size=frontier_size,
    )
    backend = get_backend("single")
    backend.validate(cfg)
    seeds = torch.as_tensor(seeds, dtype=torch.int32, device=g.device)
    S = int(num_seeds if num_seeds is not None else seeds.shape[0])
    return backend.solve_raw(cfg, g, seeds, S, ell=ell)
