"""Process-local metrics: counters, gauges, histograms, Prometheus text.

A copy of ``repro.obs.metrics`` (stdlib + numpy only): a
:class:`MetricsRegistry` holds named series (optionally labeled), and
:meth:`MetricsRegistry.prometheus_text` dumps them in the Prometheus text
exposition format.  The serve engine keeps a private registry per server
instance (two servers in one process must not share counters).

Histograms keep a bounded reservoir (newest ``reservoir`` observations)
for p50/p99, plus exact running ``count``/``sum``.
"""

from __future__ import annotations

import collections
import re
import threading
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np

# Prometheus metric-name grammar; label values are free-form strings.
_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

LabelItems = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Mapping[str, str]]) -> LabelItems:
    if not labels:
        return ()
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name: {k!r}")
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(items: LabelItems, extra: LabelItems = ()) -> str:
    merged = items + extra
    if not merged:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in merged)
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    # HELP text escapes only backslash and newline (no quotes) per the
    # exposition-format spec; an unescaped newline would corrupt the dump.
    return v.replace("\\", "\\\\").replace("\n", "\\n")


class Counter:
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up, got inc({amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self) -> None:
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Bounded-reservoir distribution with exact count/sum.

    The reservoir keeps the newest ``reservoir`` observations (a deque,
    not sampling): long-lived services report *recent* latency, matching
    the serve engine's historical bounded-deque behavior.
    """

    kind = "histogram"

    def __init__(self, reservoir: int = 16384) -> None:
        self._obs: "collections.deque[float]" = collections.deque(
            maxlen=reservoir
        )
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._obs.append(float(value))
            self._count += 1
            self._sum += float(value)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def values(self) -> Tuple[float, ...]:
        """Snapshot of the reservoir (the newest observations)."""
        return tuple(self._obs)

    def percentile(self, p: float) -> Optional[float]:
        """p-th percentile of the reservoir; None before any observation."""
        if not self._obs:
            return None
        return float(np.percentile(np.asarray(self._obs), p))

    def percentiles(self, ps: Iterable[float]) -> Tuple[Optional[float], ...]:
        if not self._obs:
            return tuple(None for _ in ps)
        arr = np.asarray(self._obs)
        return tuple(float(np.percentile(arr, p)) for p in ps)


class MetricsRegistry:
    """Named metric series, each optionally split by a label set.

    ``counter``/``gauge``/``histogram`` are get-or-create: repeated calls
    with the same (name, labels) return the same object, and a name is
    permanently bound to its first kind (re-registering ``x`` as a gauge
    after it was a counter raises).
    """

    def __init__(self) -> None:
        self._kinds: Dict[str, str] = {}
        self._help: Dict[str, str] = {}
        self._series: Dict[Tuple[str, LabelItems], object] = {}
        self._lock = threading.Lock()

    def _get(self, name, kind, help, labels, factory):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        key = (name, _label_key(labels))
        with self._lock:
            bound = self._kinds.get(name)
            if bound is None:
                self._kinds[name] = kind
                self._help[name] = help
            elif bound != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {bound}, "
                    f"requested {kind}"
                )
            out = self._series.get(key)
            if out is None:
                out = factory()
                self._series[key] = out
            return out

    def counter(
        self, name: str, help: str = "", labels: Optional[Mapping[str, str]] = None
    ) -> Counter:
        return self._get(name, "counter", help, labels, Counter)

    def gauge(
        self, name: str, help: str = "", labels: Optional[Mapping[str, str]] = None
    ) -> Gauge:
        return self._get(name, "gauge", help, labels, Gauge)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Optional[Mapping[str, str]] = None,
        reservoir: int = 16384,
    ) -> Histogram:
        return self._get(
            name, "histogram", help, labels, lambda: Histogram(reservoir)
        )

    def series(self, name: str) -> Dict[LabelItems, object]:
        """All label variants of one metric name."""
        return {k[1]: v for k, v in self._series.items() if k[0] == name}

    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self._kinds))

    def prometheus_text(self) -> str:
        """Prometheus text exposition of every registered series.

        Histograms are exported as summaries (``{quantile="0.5"|"0.99"}``
        plus ``_sum``/``_count``) — the paper's p50/p99 phrasing, and
        what a reservoir can answer without fixed buckets.
        """
        lines = []
        for name in self.names():
            kind = self._kinds[name]
            help = self._help.get(name, "")
            if help:
                lines.append(f"# HELP {name} {_escape_help(help)}")
            lines.append(
                f"# TYPE {name} {'summary' if kind == 'histogram' else kind}"
            )
            for labels, series in sorted(self.series(name).items()):
                if kind == "histogram":
                    p50, p99 = series.percentiles((50, 99))
                    for q, v in (("0.5", p50), ("0.99", p99)):
                        if v is None:
                            continue
                        lab = _fmt_labels(labels, (("quantile", q),))
                        lines.append(f"{name}{lab} {v:.9g}")
                    lab = _fmt_labels(labels)
                    lines.append(f"{name}_sum{lab} {series.sum:.9g}")
                    lines.append(f"{name}_count{lab} {series.count}")
                else:
                    lab = _fmt_labels(labels)
                    lines.append(f"{name}{lab} {series.value:.9g}")
        return "\n".join(lines) + "\n"
