"""The batched Steiner pipeline: B seed sets against one resident graph.

Counterpart of ``repro.serve.batch``.  The reference vmaps the whole
pipeline over a leading query axis; here the ``"batch"`` backend of
:mod:`repro_torch.solver` runs the Voronoi fixpoint of all B lanes with one
min-plus kernel launch a round, then the tail lane by lane.  Every lane
computes exactly what the single-query pipeline computes, bit for bit.
Modes "dense" and "bucket" run lane by lane through the single pipeline.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.graph import Graph
from repro_torch.core.steiner import SteinerResult


def steiner_tree_batch(
    g: Graph,
    seeds,
    *,
    num_seeds: Optional[int] = None,
    mode: str = "bucket",
    mst_algo: str = "prim",
    delta: Optional[float] = None,
    max_iters: Optional[int] = None,
) -> SteinerResult:
    """Computes B Steiner trees at once over the shared graph ``g``, on the
    graph's device.

    Args:
      g: symmetric weighted graph (padded COO), shared by every query.
      seeds: (B, S) int32 seed vertex ids; rows may carry duplicate seeds
        (inert padding, see :func:`repro_torch.serve.plan.pad_seed_set`).
      num_seeds: S (defaults to seeds.shape[1]).
      mode: Voronoi schedule, "dense" | "bucket" | "pallas" (the min-plus
        kernel path; its ELL view is memoized on first use).
      mst_algo: "prim" | "boruvka".
      delta: bucket width of mode="bucket".
      max_iters: safety cap on relaxation rounds.

    Returns:
      SteinerResult with a leading (B,) axis on every array;
      ``result.tree.total_distance`` is (B,) f32.
    """
    from repro_torch.solver.config import SolverConfig
    from repro_torch.solver.registry import get_backend

    seeds = torch.as_tensor(seeds, dtype=torch.int32, device=g.device)
    if seeds.dim() != 2:
        raise ValueError(f"seeds must be (B, S), got shape {tuple(seeds.shape)}")
    cfg = SolverConfig(
        backend="batch", mode=mode, mst_algo=mst_algo, delta=delta, max_iters=max_iters
    )
    backend = get_backend("batch")
    backend.validate(cfg)
    S = int(num_seeds if num_seeds is not None else seeds.shape[1])
    return backend.solve_raw(cfg, g, seeds, S)
