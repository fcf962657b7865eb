"""String-keyed backend registry and the uniform solve result.

A backend is a singleton object wrapping one execution strategy, with
``validate(cfg)``, ``prepare(cfg, graph, device) -> artifacts`` and
``solve(cfg, artifacts, seeds, S) -> SolveOutput``.  Register with
``@register_backend("name")``; look up with ``get_backend(name)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs

_REGISTRY: Dict[str, Any] = {}


@dataclasses.dataclass(frozen=True)
class SolveTelemetry:
    """Convergence telemetry of one solve, as plain Python values.

    Attributes:
      iterations: global relaxation rounds until the fixpoint.
      relaxations: vertex-state improvements across all rounds.
      messages: candidate transmissions attempted ("messages", Fig. 6).
      per_round: (R, 4) f32 array, one row per round (frontier, messages,
        relaxations, unreached), R = min(iterations, telemetry_rounds);
        None when telemetry_rounds=0.
      per_rank: (R, n_ranks, 4) f32 flight-recorder buffer, one channel
        row per rank and round (obs.ROUND_CHANNELS), with
        ``SolverConfig.telemetry_per_rank=True`` (mesh backends); else None.

    Counters ride the loop as f32, like the reference's, so they are exact
    only below 2**24 per solve.
    """

    iterations: int
    relaxations: int
    messages: int
    per_round: Optional[np.ndarray] = None
    per_rank: Optional[np.ndarray] = None


_NP_DTYPES = {
    torch.float32: np.float32, torch.int32: np.int32, torch.int64: np.int64,
    torch.bool: np.bool_,
}


def to_host(*xs):
    """Brings several tensors to the host in one explicit ``.cpu()`` fetch.

    They travel as one f64 buffer (f32, bool and int32 values round-trip
    exactly) and come back as numpy arrays of their own dtype and shape;
    anything that is not a tensor passes through.
    """
    ts = [x for x in xs if isinstance(x, torch.Tensor)]
    if not ts:
        return list(xs)
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in ts]).cpu().numpy()
    obs.host_read()
    out, off = [], 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            k = x.numel()
            out.append(flat[off:off + k].astype(_NP_DTYPES[x.dtype]).reshape(x.shape))
            off += k
        else:
            out.append(x)
    return out


def telemetry_from_counts(
    iterations, relaxations, messages, history, telemetry_rounds: int, per_rank=None,
) -> SolveTelemetry:
    """Builds a :class:`SolveTelemetry` from the loop's counters.

    Takes tensors (fetched here in one go) or host values; ``history`` is
    the raw (H+1, 4) buffer or None, and its spill slot and unused rows are
    trimmed here; ``per_rank`` is the raw (H+1, n_ranks, 4) flight-recorder
    buffer or None, trimmed the same way.
    """
    iterations, relaxations, messages, history, per_rank = to_host(
        iterations, relaxations, messages, history, per_rank
    )
    iters = int(iterations)
    keep = min(iters, telemetry_rounds)
    per_round = rank_rows = None
    if history is not None and telemetry_rounds > 0:
        per_round = np.asarray(history)[:keep]
    if per_rank is not None and telemetry_rounds > 0:
        rank_rows = np.asarray(per_rank)[:keep]
    return SolveTelemetry(
        iterations=iters,
        relaxations=int(round(float(relaxations))),
        messages=int(round(float(messages))),
        per_round=per_round,
        per_rank=rank_rows,
    )


@dataclasses.dataclass(frozen=True)
class SolveOutput:
    """Backend-independent view of one solve.

    Attributes:
      total_distance: D(G_S), a float.
      num_edges: |E_S|, an int.
      raw: the backend-native result (:class:`SteinerResult`).
      telemetry: :class:`SolveTelemetry`.
    """

    total_distance: Any
    num_edges: Any
    raw: Any
    telemetry: Optional[SolveTelemetry] = None


def register_backend(name: str):
    """Class decorator: instantiate and register the backend under ``name``."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls()
        return cls

    return deco


def get_backend(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
