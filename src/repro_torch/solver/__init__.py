"""Solver API: ``SteinerSolver(cfg, device=...).prepare(graph).solve(seeds)``.

``backend="single"`` runs modes "dense", "bucket", "frontier" and "pallas"
(with or without ``pallas_frontier``), ``backend="batch"`` modes "dense",
"bucket" and "pallas", ``backend="mesh1d"`` modes "dense", "bucket" and
"frontier" and ``backend="mesh2d"`` modes "dense" and "bucket" over
``torch.distributed``, each with ``mst_algo`` "prim" or "boruvka"; ``prepare``
takes an in-memory graph or an on-disk graph store.
"""

from repro_torch.solver import backends as _backends  # registers the backends
from repro_torch.solver.api import PreparedGraph, SteinerSolver
from repro_torch.solver.config import BACKENDS, MODES, SolverConfig
from repro_torch.solver.registry import (
    SolveOutput,
    SolveTelemetry,
    available_backends,
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
    "available_backends",
    "get_backend",
    "register_backend",
]
