"""Voronoi cell state and per-round telemetry (what the min-plus schedule needs).

Per-vertex state (paper Table II): ``dist[v]`` is the distance to the owning
seed, ``lab[v]`` the owning seed's index (``S`` when unreached), ``pred[v]``
the predecessor on the shortest path (``v`` for seeds and unreached).
Updates follow the strict lexicographic order on ``(dist, lab, pred)`` of
``repro.core.voronoi``, so every schedule reaches the same fixpoint.

The dense, bucket and frontier schedules of the JAX package are not ported
yet; the min-plus kernel schedule lives in :mod:`repro_torch.kernels.minplus.ops`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class VoronoiState:
    """Per-vertex Voronoi state: (dist, lab, pred)."""

    dist: torch.Tensor  # (N,) f32
    lab: torch.Tensor  # (N,) i32; == S for unreached
    pred: torch.Tensor  # (N,) i32; == v for seeds / unreached


@dataclasses.dataclass(frozen=True)
class VoronoiStats:
    """Convergence statistics (the paper's Fig. 5/6 message metrics).

    ``relaxations`` and ``messages`` are f32 like the reference's loop
    carries, so they are exact only below 2**24.
    """

    iterations: torch.Tensor  # i32 scalar: number of global rounds
    relaxations: torch.Tensor  # f32 scalar: vertex-state improvements
    messages: torch.Tensor  # f32 scalar: candidate transmissions attempted
    # (H+1, 4) f32 per-round telemetry ring: rows 0..H-1 hold rounds 0..H-1
    # in (frontier, messages, relaxations, unreached) order; row H absorbs
    # rounds >= H.  None when the loop ran with telemetry_rounds=0.
    history: Optional[torch.Tensor] = None


def _round_row(
    frontier: torch.Tensor,
    messages: torch.Tensor,
    relaxations: torch.Tensor,
    dist: torch.Tensor,
) -> torch.Tensor:
    """One telemetry row: (frontier, messages, relaxations, unreached), f32.

    With a leading lane axis (counts (B,), ``dist`` (B, N)) it gives one row
    a lane, (B, 4).
    """
    unreached = (~torch.isfinite(dist)).sum(dim=-1)
    return torch.stack([frontier, messages, relaxations, unreached], dim=-1).to(torch.float32)


def _hist_write(hist: torch.Tensor, it: int, row: torch.Tensor) -> torch.Tensor:
    """Writes ``row`` at round ``it`` in place, clamped into the spill slot H."""
    hist[min(it, hist.shape[0] - 1)] = row
    return hist


def init_state(n: int, seeds: torch.Tensor) -> VoronoiState:
    """Paper Alg. 3 INITIALIZATION: seeds at distance 0 owning themselves.

    Duplicate seed entries are inert: the label scatter is a ``min``, so a
    vertex listed at several seed indices is owned by the lowest index and
    the higher duplicates label empty cells.
    """
    dev = seeds.device
    S = seeds.shape[0]
    dist = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    dist[seeds] = 0.0
    lab = torch.full((n,), S, dtype=torch.int32, device=dev)
    lab.scatter_reduce_(
        0, seeds.long(), torch.arange(S, dtype=torch.int32, device=dev), "amin",
        include_self=True,
    )
    pred = torch.arange(n, dtype=torch.int32, device=dev)
    return VoronoiState(dist=dist, lab=lab, pred=pred)


def init_states(n: int, seeds: torch.Tensor) -> VoronoiState:
    """:func:`init_state` of every row of a (B, S) seed batch, stacked into
    (B, N) tensors (a lane of duplicate seeds stays inert, as in one)."""
    lanes = [init_state(n, row) for row in seeds]
    return VoronoiState(
        dist=torch.stack([st.dist for st in lanes]),
        lab=torch.stack([st.lab for st in lanes]),
        pred=torch.stack([st.pred for st in lanes]),
    )
