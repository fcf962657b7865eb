"""Solver API: ``SteinerSolver(cfg, device=...).prepare(graph).solve(seeds)``.

Only ``mode="pallas"`` with ``backend="single"`` or ``backend="batch"`` is
ported so far.
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
