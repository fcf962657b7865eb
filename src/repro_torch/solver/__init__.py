"""Solver API: ``SteinerSolver(cfg, device=...).prepare(graph).solve(seeds)``.

``backend="single"`` runs modes "dense", "bucket", "frontier" and "pallas"
(with or without ``pallas_frontier``), ``backend="batch"`` modes "dense",
"bucket" and "pallas", each with ``mst_algo`` "prim" or "boruvka"; ``prepare``
takes an in-memory graph or an on-disk graph store.  The mesh backends are
not ported yet.
"""

from repro_torch.solver import backends as _backends  # registers the backends
from repro_torch.solver.api import PreparedGraph, SteinerSolver
from repro_torch.solver.config import BACKENDS, MODES, SolverConfig
from repro_torch.solver.registry import (
    SolveOutput,
    SolveTelemetry,
    get_backend,
    register_backend,
)

__all__ = [
    "BACKENDS",
    "MODES",
    "PreparedGraph",
    "SolveOutput",
    "SolveTelemetry",
    "SolverConfig",
    "SteinerSolver",
    "get_backend",
    "register_backend",
]
