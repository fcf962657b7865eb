"""The spans a traced solve records inside itself (``repro_torch.obs``):
``solve:voronoi``, ``solve:tail`` (with ``lanes`` in a batch) and
``solve:mst``, and the ``host_reads`` arg of each ``solve`` span.

Their ``ts`` is Unix-epoch microseconds, the clock of the device trace's
nanoseconds, so a span's interval on that axis is ``ts * 1e3`` to
``(ts + dur) * 1e3``.  A program that records none of them gives every
reader here nothing to read (None).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def spans(rec, name: str, batch: Optional[bool] = None) -> List[dict]:
    """The complete spans named ``name``; with ``batch``, only those that
    carry ``lanes`` (True) or do not (False)."""
    out = [e for e in rec.spans if e.get("ph") == "X" and e["name"] == name]
    if batch is not None:
        out = [e for e in out if ("lanes" in e.get("args", {})) == batch]
    return out


def mean_ms(evs: Sequence[dict]) -> Optional[float]:
    return sum(e["dur"] for e in evs) / len(evs) / 1e3 if evs else None


def interval_ns(e: dict) -> Tuple[float, float]:
    """A span's interval on the device trace's nanosecond clock."""
    return e["ts"] * 1e3, (e["ts"] + e["dur"]) * 1e3


def union(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def idle_inside_ns(events, intervals) -> Optional[float]:
    """Nanoseconds in which the card ran no activity while inside one of
    ``intervals``, counted only between the first activity's start and the
    last's end (the traced window): the gaps between the union of the
    device ``events`` (name, start_ns, end_ns), intersected with the union
    of ``intervals``.  None where no interval meets the traced window."""
    busy = union((s, e) for _, s, e in events)
    if not busy:
        return None
    lo, hi = busy[0][0], busy[-1][1]
    spans_ = [(max(s, lo), min(e, hi)) for s, e in union(intervals) if e > lo and s < hi]
    if not spans_:
        return None
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    total, j = 0.0, 0
    for gs, ge in gaps:  # both lists sorted and disjoint: one sweep
        while j < len(spans_) and spans_[j][1] <= gs:
            j += 1
        k = j
        while k < len(spans_) and spans_[k][0] < ge:
            total += min(ge, spans_[k][1]) - max(gs, spans_[k][0])
            k += 1
    return total
