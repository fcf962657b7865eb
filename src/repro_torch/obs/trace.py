"""Span tracer with Chrome trace-event JSON export.

A copy of ``repro.obs.trace`` (the standard library only).  Spans are
recorded as *complete* ("X") events, one record per span with ``ts``/``dur``
in microseconds, which Perfetto and ``chrome://tracing`` load directly.
Counter ("C") events carry the per-round convergence series (frontier
size, messages, relaxations, unreached) so the curves render as tracks
under the solve span.

Two recording styles coexist:

  with tracer.span("solve", mode="frontier"): ...   # live timing
  tracer.add_span("round", t0, t1, round=3, ...)    # retroactive

Retroactive spans serve where a context manager cannot sit: the serve
engine's queue wait (it starts at submit() and is known to have ended only
at flush()) and the per-round telemetry of a solve (its rounds run without
a host clock; their timestamps are synthesized afterwards and flagged
``synthetic_timing`` in the event args).

A span's clock is the host's: it never synchronizes the device, so a span
around queued device work measures the host's enqueue unless the block
ends in a fetch to the host.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import sys
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

# Live tracers, flushed at interpreter exit so spans still open inside a
# `with span()` (daemon threads, os._exit-adjacent teardown) are recorded
# instead of silently dropped.
_LIVE_TRACERS: "weakref.WeakSet[Tracer]" = weakref.WeakSet()


@atexit.register
def _flush_leaked_spans() -> None:
    for tr in list(_LIVE_TRACERS):
        leaked = tr.flush_open_spans()
        if leaked:
            print(
                f"repro_torch.obs: flushed {len(leaked)} span(s) still open at "
                f"interpreter exit: {', '.join(sorted(set(leaked)))}",
                file=sys.stderr,
            )


class Tracer:
    """Accumulates trace events; thread-safe appends, one export at end."""

    def __init__(self, process_name: str = "repro_torch") -> None:
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._process_name = process_name
        self._open: Dict[object, tuple] = {}
        _LIVE_TRACERS.add(self)

    def _us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, tid: int = 0, **args):
        """Times a block; records one X event when it exits (even on error)."""
        start = time.perf_counter()
        token = object()
        with self._lock:
            self._open[token] = (name, start, tid, args)
        try:
            yield self
        finally:
            with self._lock:
                self._open.pop(token, None)
            self.add_span(name, start, time.perf_counter(), tid=tid, **args)

    def flush_open_spans(self) -> List[str]:
        """Records every still-open ``span()`` scope as ending now.

        Returns the names flushed (normally empty; the atexit hook calls
        this for scopes the interpreter tears down mid-block)."""
        with self._lock:
            pending = list(self._open.values())
            self._open.clear()
        end = time.perf_counter()
        for name, start, tid, args in pending:
            self.add_span(name, start, end, tid=tid, leaked=True, **args)
        return [name for name, _, _, _ in pending]

    def add_span(
        self, name: str, t_start: float, t_end: float, tid: int = 0, **args
    ) -> None:
        """Records a span from ``time.perf_counter()`` stamps taken earlier."""
        ev = {
            "name": name,
            "ph": "X",
            "ts": self._us(t_start),
            "dur": max(0.0, (t_end - t_start) * 1e6),
            "pid": 0,
            "tid": tid,
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def add_counter(
        self, name: str, t: float, values: Dict[str, float], tid: int = 0
    ) -> None:
        """Records a counter sample (renders as a track of stacked series)."""
        ev = {
            "name": name,
            "ph": "C",
            "ts": self._us(t),
            "pid": 0,
            "tid": tid,
            "args": {k: float(v) for k, v in values.items()},
        }
        with self._lock:
            self._events.append(ev)

    def add_instant(self, name: str, tid: int = 0, **args) -> None:
        ev = {
            "name": name,
            "ph": "i",
            "s": "t",
            "ts": self._us(time.perf_counter()),
            "pid": 0,
            "tid": tid,
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def now(self) -> float:
        """Timestamp source for add_span/add_counter (perf_counter)."""
        return time.perf_counter()

    def __len__(self) -> int:
        return len(self._events)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def chrome_trace(self) -> Dict[str, Any]:
        """The JSON-object trace format: sorted events + process metadata."""
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": 0,
                "tid": 0,
                "args": {"name": self._process_name},
            }
        ]
        events = sorted(self.events(), key=lambda e: e["ts"])
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> None:
        """Atomic write (tmp + rename), like the graphstore manifests: a
        crash mid-dump cannot leave a truncated trace behind."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.chrome_trace(), f)
        os.replace(tmp, path)


def validate_chrome_trace(doc: Any) -> int:
    """Schema check for a Chrome trace document; returns the event count.

    Accepts either the JSON-object format (``{"traceEvents": [...]}``)
    or a bare event array.  Raises ValueError on: missing/negative
    ``ts``, negative ``dur``, non-monotonic ``ts`` ordering within the
    array, unpaired B/E events per (pid, tid), or unknown phases.
    """
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError("object-format trace missing 'traceEvents' list")
    elif isinstance(doc, list):
        events = doc
    else:
        raise ValueError(f"trace must be an object or array, got {type(doc)}")

    open_stacks: Dict[Any, List[str]] = {}
    prev_ts: Optional[float] = None
    n = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        ph = ev.get("ph")
        if ph not in ("X", "B", "E", "C", "M", "i", "I"):
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        if ph == "M":
            continue  # metadata events carry no timestamp contract
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i}: bad ts {ts!r}")
        if prev_ts is not None and ts < prev_ts:
            raise ValueError(
                f"event {i}: ts {ts} < previous {prev_ts} (not monotonic)"
            )
        prev_ts = ts
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: X event bad dur {dur!r}")
        elif ph == "B":
            open_stacks.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                ev.get("name", "")
            )
        elif ph == "E":
            stack = open_stacks.get((ev.get("pid"), ev.get("tid")), [])
            if not stack:
                raise ValueError(f"event {i}: E without matching B")
            stack.pop()
        n += 1
    leftovers = {k: v for k, v in open_stacks.items() if v}
    if leftovers:
        raise ValueError(f"unclosed B events: {leftovers}")
    return n
