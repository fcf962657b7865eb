"""Observability: the metrics registry (a copy of ``repro.obs.metrics``),
the per-round channel order, and the per-rank flight recorder's analytics
(:mod:`repro_torch.obs.flight`, a copy of ``repro.obs.flight``).

Spans and the trace recorder of ``repro.obs`` are not ported yet (see
ROADMAP.md); the serving engine counts into a per-server registry.
"""

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry

# Channel order of every per-round telemetry row, shared by all fixpoint
# loops (voronoi dense/bucket/frontier, pallas, mesh1d, mesh2d).
ROUND_CHANNELS = ("frontier", "messages", "relaxations", "unreached")

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "ROUND_CHANNELS"]
