"""Observability: process-local metrics, spans and per-round telemetry.

Counterpart of ``repro.obs``, zero-cost when disabled: the module-level
recorder is ``None`` until :func:`enable` is called, :func:`span` returns a
shared no-op context manager, and the solver's per-round telemetry rides in
loop state that is carried whether or not obs is on (gated only by the
``telemetry_rounds`` config knob), so switching obs on or off never changes
a result, a counter, a per-round row or the number of kernel launches.  No
span synchronizes the device or fetches from it.

Typical use::

    from repro_torch import obs

    obs.enable(trace=True)
    ... run solves, serve traffic, graphstore builds ...
    obs.export_chrome_trace("trace.json")     # load in ui.perfetto.dev
    print(obs.prometheus_text())              # scrape-format metrics

The package imports the standard library and numpy only, never torch, so
the graphstore CLI instruments itself without the device stack.  Also
here: the per-rank flight recorder's analytics
(:mod:`repro_torch.obs.flight`).  Each process keeps its own recorder: on
a mesh of several ranks, every rank records its own spans, and the
per-rank tracks come from the flight buffer each rank already holds.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    parse_prometheus,
)
from repro_torch.obs.trace import Tracer, validate_chrome_trace

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ROUND_CHANNELS",
    "Tracer",
    "counter",
    "disable",
    "emit_round_telemetry",
    "enable",
    "enabled",
    "export_chrome_trace",
    "gauge",
    "histogram",
    "now",
    "parse_prometheus",
    "prometheus_text",
    "registry",
    "reset",
    "span",
    "tracer",
    "tracing",
    "validate_chrome_trace",
]

# Channel order of every per-round telemetry row, shared by all fixpoint
# loops (voronoi dense/bucket/frontier, pallas, mesh1d, mesh2d).
ROUND_CHANNELS = ("frontier", "messages", "relaxations", "unreached")

_registry: Optional[MetricsRegistry] = None
_tracer: Optional[Tracer] = None
_enabled: bool = False


class _NoopSpan:
    """Shared do-nothing context manager handed out while obs is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


def enable(trace: bool = True, metrics: bool = True) -> None:
    """Turns on recording; idempotent, keeps existing data on re-enable."""
    global _enabled, _registry, _tracer
    _enabled = True
    if metrics and _registry is None:
        _registry = MetricsRegistry()
    if trace and _tracer is None:
        _tracer = Tracer()


def disable() -> None:
    """Stops recording; accumulated data stays readable via registry()/tracer()."""
    global _enabled
    _enabled = False


def reset() -> None:
    """Drops all recorded data and returns to the disabled state (tests)."""
    global _enabled, _registry, _tracer
    _enabled = False
    _registry = None
    _tracer = None


def enabled() -> bool:
    return _enabled


def tracing() -> bool:
    """True when spans are actually being recorded (enabled + tracer)."""
    return _enabled and _tracer is not None


def registry() -> Optional[MetricsRegistry]:
    return _registry


def tracer() -> Optional[Tracer]:
    return _tracer


def now() -> float:
    """Timestamp for retroactive spans (:func:`add_span`,
    :func:`emit_round_telemetry`): plain ``time.perf_counter()``."""
    return time.perf_counter()


def span(name: str, tid: int = 0, **args):
    """A live span on the global tracer, or the shared no-op when off."""
    if _enabled and _tracer is not None:
        return _tracer.span(name, tid=tid, **args)
    return _NOOP_SPAN


def add_span(name: str, t_start: float, t_end: float, tid: int = 0, **args) -> None:
    """Retroactive span (no-op when disabled); stamps from time.perf_counter()."""
    if _enabled and _tracer is not None:
        _tracer.add_span(name, t_start, t_end, tid=tid, **args)


def counter(name: str, help: str = "", labels=None) -> Optional[Counter]:
    """The named counter on the global registry, or None when disabled."""
    if _enabled and _registry is not None:
        return _registry.counter(name, help, labels)
    return None


def gauge(name: str, help: str = "", labels=None) -> Optional[Gauge]:
    if _enabled and _registry is not None:
        return _registry.gauge(name, help, labels)
    return None


def histogram(name: str, help: str = "", labels=None) -> Optional[Histogram]:
    if _enabled and _registry is not None:
        return _registry.histogram(name, help, labels)
    return None


def prometheus_text() -> str:
    return _registry.prometheus_text() if _registry is not None else ""


def export_chrome_trace(path: str) -> bool:
    """Writes the accumulated trace; returns False if nothing was recorded."""
    if _tracer is None:
        return False
    _tracer.export_chrome(path)
    return True


def emit_round_telemetry(
    per_round,
    t_start: float,
    t_end: float,
    *,
    label: str,
    tid: int = 0,
    extra_args: Optional[Dict[str, object]] = None,
    per_rank=None,
) -> None:
    """Renders per-round convergence telemetry into the trace.

    ``per_round`` is the (R, 4) host array of ROUND_CHANNELS rows carried
    out of a fixpoint loop.  Timing each round would cost a device sync a
    round, so the R round spans evenly subdivide the real ``[t_start,
    t_end]`` solve interval, flagged ``synthetic_timing`` so trace readers
    do not take them for measured durations.  Counter events at each round
    boundary draw the convergence curves (frontier, messages, relaxations,
    unreached) as Perfetto tracks.  ``per_rank``, the (R, n_ranks, 4)
    flight-recorder buffer of a solve run with ``telemetry_per_rank=True``,
    adds one ``rank[{label}/{k}]`` counter track per mesh rank, which shows
    load imbalance round by round.  No-op when tracing is off or the solve
    recorded zero rounds.
    """
    if not tracing() or per_round is None:
        return
    rounds = int(per_round.shape[0])
    if rounds == 0:
        return
    dt = (t_end - t_start) / rounds
    for r in range(rounds):
        row = per_round[r]
        values = {c: float(row[i]) for i, c in enumerate(ROUND_CHANNELS)}
        args = {"round": r, "synthetic_timing": True, **values}
        if extra_args:
            args.update(extra_args)
        _tracer.add_span(
            f"round[{label}]",
            t_start + r * dt,
            t_start + (r + 1) * dt,
            tid=tid,
            **args,
        )
        _tracer.add_counter(
            f"convergence[{label}]", t_start + r * dt, values, tid=tid
        )
    if per_rank is not None:
        for r in range(min(rounds, int(per_rank.shape[0]))):
            t = t_start + r * dt
            for k in range(int(per_rank.shape[1])):
                vals = {
                    c: float(per_rank[r, k, i])
                    for i, c in enumerate(ROUND_CHANNELS)
                }
                _tracer.add_counter(f"rank[{label}/{k}]", t, vals, tid=tid)
