"""Observability: the metrics registry (a copy of ``repro.obs.metrics``).

Spans and the trace recorder of ``repro.obs`` are not ported yet (see
ROADMAP.md); the serving engine counts into a per-server registry.
"""

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
