"""Observability: process-local metrics, spans and per-round telemetry.

Counterpart of ``repro.obs``, zero-cost when disabled: the module-level
recorder is ``None`` until :func:`enable` is called, :func:`span` and
:func:`child` return a shared no-op context manager, :func:`host_read` and
:func:`round_boundary` return at once, and the solver's per-round telemetry
rides in loop state that is carried whether or not obs is on (gated only by
the ``telemetry_rounds`` config knob), so switching obs on or off never
changes a result, a counter, a per-round row or the number of kernel
launches.  No span, stamp or tally synchronizes the device or fetches from
it: each reads the host's clock or adds to a count.

**One clock with the device trace.**  Every ``ts`` is Unix-epoch
microseconds, the clock of ``torch.profiler``'s events, so ``ts * 1e3``
lies on a device trace's nanosecond axis (:mod:`repro_torch.obs.trace`
says how the offset is read and how far it can drift).  Callers still pass
``time.perf_counter()`` stamps (:func:`now`).

**Requests.**  A solve (``PreparedGraph.solve``) is a request: its
``solve`` span carries ``req``, a per-process count, and ``host_reads``,
the device-to-host reads the solve made, each counted at its site
(:func:`host_read`: the round flags, the pair tables' ``nonzero``, the
tree's masked indexing and marking rounds, the final fetch).  Its child
spans (:func:`child`) carry the same ``req`` and name their ``parent``:
``solve:voronoi`` (the fixpoint loop), ``solve:tail`` (distance graph, MST
and tree) and, inside it, ``solve:mst``.  The kernel schedules of mode
"pallas" (:func:`~repro_torch.kernels.minplus.ops.voronoi_cells_pallas` and
its lanes twin) stamp each round's end at its one host read
(:func:`round_boundary`), so their ``round[...]`` spans are measured; the
other schedules' rounds are an even split of the solve, flagged
``synthetic_timing`` (:func:`emit_round_telemetry`).

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

import contextlib
import contextvars
import time
from typing import Dict, List, Optional, Sequence

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
    "Request",
    "Tracer",
    "child",
    "counter",
    "disable",
    "emit_round_telemetry",
    "enable",
    "enabled",
    "export_chrome_trace",
    "gauge",
    "histogram",
    "host_read",
    "now",
    "parse_prometheus",
    "prometheus_text",
    "registry",
    "request",
    "reset",
    "round_boundary",
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


class Request:
    """One solve on the trace: its id, the host reads it made so far
    (:func:`host_read`) and its fixpoint loop's round boundaries
    (:func:`round_boundary`, ``perf_counter`` stamps)."""

    __slots__ = ("id", "host_reads", "round_stamps")

    def __init__(self, req_id: int) -> None:
        self.id = req_id
        self.host_reads = 0
        self.round_stamps: List[float] = []


# the request open in this thread or task; set only while tracing
_current: "contextvars.ContextVar[Optional[Request]]" = contextvars.ContextVar(
    "repro_torch_obs_request", default=None)


def enable(trace: bool = True, metrics: bool = True) -> None:
    """Turns on recording; idempotent, keeps existing data on re-enable.
    Re-reads the tracer's clock offset (:meth:`Tracer.sync_clock`)."""
    global _enabled, _registry, _tracer
    _enabled = True
    if metrics and _registry is None:
        _registry = MetricsRegistry()
    if trace and _tracer is None:
        _tracer = Tracer()
    elif _tracer is not None:
        _tracer.sync_clock()


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
    :func:`emit_round_telemetry`): plain ``time.perf_counter()``, which the
    tracer writes on the Unix epoch."""
    return time.perf_counter()


@contextlib.contextmanager
def request(name: str, tid: int = 0, **args):
    """A span that opens a request: yields its :class:`Request` (None when
    not tracing) and records the span at exit with ``args``, ``req`` and
    the ``host_reads`` counted inside it (on error too)."""
    tr = _tracer
    if not (_enabled and tr is not None):
        yield None
        return
    req = Request(tr.next_request())
    token = _current.set(req)
    start = time.perf_counter()
    try:
        yield req
    finally:
        _current.reset(token)
        tr.add_span(name, start, time.perf_counter(), tid=tid, req=req.id,
                    host_reads=req.host_reads, **args)


def child(name: str, parent: str, **args):
    """A live span inside the open request, carrying its ``req`` and the
    name of its ``parent`` span; the shared no-op outside a request."""
    req = _current.get()
    if req is None or not (_enabled and _tracer is not None):
        return _NOOP_SPAN
    return _tracer.span(name, parent=parent, req=req.id, **args)


def host_read(n: int = 1) -> None:
    """Counts ``n`` device-to-host reads on the open request.  Called at
    the read's site; it reads nothing itself and is a no-op outside a
    request."""
    req = _current.get()
    if req is not None:
        req.host_reads += n


def round_boundary(read: bool = True) -> None:
    """Stamps a boundary of the open request's fixpoint rounds: once as
    the loop starts (``read=False``), then at each round's one host read,
    which it also counts.  A no-op outside a request."""
    req = _current.get()
    if req is not None:
        req.round_stamps.append(time.perf_counter())
        req.host_reads += read


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
    round_stamps: Optional[Sequence[float]] = None,
) -> None:
    """Renders per-round convergence telemetry into the trace.

    ``per_round`` is the (R, 4) host array of ROUND_CHANNELS rows carried
    out of a fixpoint loop.  ``round_stamps`` are the loop's round
    boundaries on the host's clock (:func:`round_boundary`): its start,
    then the end of each round, taken at the round's one host read, so no
    stamp costs a sync.  The kernel schedules of mode "pallas" keep them;
    given at least R + 1, round r spans ``[round_stamps[r],
    round_stamps[r + 1]]``, measured.  Without them (the other schedules,
    whose rounds are not stamped) the R round spans evenly subdivide the
    real ``[t_start, t_end]`` solve interval, flagged ``synthetic_timing``
    so trace readers do not take them for measured durations.  Counter
    events at each round's start draw the convergence curves (frontier,
    messages, relaxations, unreached) as Perfetto tracks.  ``per_rank``,
    the (R, n_ranks, 4) flight-recorder buffer of a solve run with
    ``telemetry_per_rank=True``, adds one ``rank[{label}/{k}]`` counter
    track per mesh rank, which shows load imbalance round by round.  No-op
    when tracing is off or the solve recorded zero rounds.
    """
    if not tracing() or per_round is None:
        return
    rounds = int(per_round.shape[0])
    if rounds == 0:
        return
    measured = round_stamps is not None and len(round_stamps) > rounds
    if measured:
        bounds = list(round_stamps[: rounds + 1])
    else:
        dt = (t_end - t_start) / rounds
        bounds = [t_start + r * dt for r in range(rounds + 1)]
    for r in range(rounds):
        row = per_round[r]
        values = {c: float(row[i]) for i, c in enumerate(ROUND_CHANNELS)}
        args = {"round": r, **values} if measured else {
            "round": r, "synthetic_timing": True, **values}
        if extra_args:
            args.update(extra_args)
        _tracer.add_span(f"round[{label}]", bounds[r], bounds[r + 1], tid=tid, **args)
        _tracer.add_counter(f"convergence[{label}]", bounds[r], values, tid=tid)
    if per_rank is not None:
        for r in range(min(rounds, int(per_rank.shape[0]))):
            for k in range(int(per_rank.shape[1])):
                vals = {
                    c: float(per_rank[r, k, i])
                    for i, c in enumerate(ROUND_CHANNELS)
                }
                _tracer.add_counter(f"rank[{label}/{k}]", bounds[r], vals, tid=tid)
