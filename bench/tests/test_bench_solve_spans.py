"""The readers of the spans a solve records inside itself
(perfkit/solvespans.py and the six metrics that read it), on synthetic
records: the program's spans on the Unix-epoch clock, beside a device
trace on the same nanosecond axis."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from perfkit import manifest, solvespans  # noqa: E402
from perfkit.devtrace import DeviceTrace  # noqa: E402
from perfkit.harness import RunRecord  # noqa: E402

MS = 1_000_000  # ns
T0 = 1_792_000_000 * 10**9  # a Unix-epoch instant, ns
# a float ts in µs near T0 holds 0.25 µs: 1 µs of 12 ms is 0.0083 %
PCT = dict(abs=0.01)

NEW = ("voronoi_ms.solve", "tail_ms.solve", "mst_ms.solve", "host_reads.solve",
       "tail_idle.solve", "tail_ms.serve")


def read(name, rec):
    return manifest.metric_reader(name)(rec)


def span(name, start_ms, dur_ms, **args):
    """A complete span as the program records it: ts and dur in µs, ts on
    the Unix epoch."""
    return {"name": name, "ph": "X", "ts": (T0 + start_ms * MS) / 1e3, "dur": dur_ms * 1e3,
            "pid": 0, "tid": 0, "args": args}


def test_every_new_metric_is_declared_with_its_reader():
    man = manifest.load_manifest()
    layer = {m["name"]: m for m in man["per_layer"]}
    for name in NEW:
        assert name in layer and callable(manifest.metric_reader(name))
    assert layer["tail_ms.serve"]["workloads"] == ["lvj1k-serve-backlog"]
    for name in NEW[:-1]:
        assert layer[name]["workloads"] == ["lvj1k-single-s1024", "lvj1k-single-s8"]


def test_span_readers_take_means_and_keep_single_and_batch_apart():
    spans = [
        span("solve", 0, 100, backend="single", req=0, host_reads=30),
        span("solve:voronoi", 1, 40, parent="solve", req=0),
        span("solve:tail", 41, 58, parent="solve", req=0),
        span("solve:mst", 50, 30, parent="solve:tail", req=0),
        span("solve", 100, 140, backend="single", req=1, host_reads=35),
        span("solve:voronoi", 101, 60, parent="solve", req=1),
        span("solve:tail", 161, 78, parent="solve", req=1),
        span("solve:mst", 170, 50, parent="solve:tail", req=1),
        span("solve:tail", 300, 500, parent="solve", req=2, lanes=8),
        span("solve:tail", 900, 300, parent="solve", req=3, lanes=8),
        {"name": "convergence[x]", "ph": "C", "ts": T0 / 1e3, "args": {}},
    ]
    rec = RunRecord(spans=spans)
    assert read("voronoi_ms.solve", rec) == pytest.approx(50.0)
    assert read("tail_ms.solve", rec) == pytest.approx(68.0)  # the batch tails left out
    assert read("tail_ms.serve", rec) == pytest.approx(400.0)
    assert read("mst_ms.solve", rec) == pytest.approx(40.0)
    assert read("host_reads.solve", rec) == pytest.approx(32.5)


def test_span_readers_read_nothing_where_the_program_records_nothing():
    """The parent program's trace: solve spans without the new args, no
    child spans.  Every new reader returns None, and none raises."""
    old = RunRecord(spans=[{"name": "solve", "ph": "X", "ts": 5.0, "dur": 9.0, "pid": 0,
                            "tid": 0, "args": {"backend": "single", "mode": "pallas"}},
                           {"name": "serve:solve", "ph": "X", "ts": 5.0, "dur": 9.0,
                            "pid": 0, "tid": 0}],
                    device=DeviceTrace(events=[("k", 0, MS)], window_s=0.01))
    for name in NEW:
        assert read(name, old) is None, name
        assert read(name, RunRecord()) is None, name


def device():
    """Busy 0-1, 3-4 and 6-10 ms of a 12-ms window: gaps 1-3 and 4-6 ms."""
    return DeviceTrace(events=[("a", T0, T0 + 1 * MS), ("b", T0 + 3 * MS, T0 + 4 * MS),
                               ("c", T0 + 6 * MS, T0 + 8 * MS),
                               ("d", T0 + 7 * MS, T0 + 10 * MS)], window_s=0.012)


def test_tail_idle_intersects_the_gaps_with_the_tail_spans():
    """A tail span over 2-3.5 ms holds half of the 1-3 ms gap (1 ms); one
    over 20-30 ms lies past the traced window and counts nothing; a batch
    tail inside the other gap is not a query's.  1 ms of 12 is 8.33 %."""
    spans = [span("solve:tail", 2, 1.5, parent="solve", req=0),
             span("solve:tail", 20, 10, parent="solve", req=1),
             span("solve:tail", 4, 2, parent="solve", req=2, lanes=8)]
    rec = RunRecord(spans=spans, device=device())
    assert read("tail_idle.solve", rec) == pytest.approx(100 / 12, **PCT)
    # a span over both gaps and the busy time between them holds both: 4 ms
    wide = RunRecord(spans=[span("solve:tail", 0.5, 6, parent="solve", req=0)],
                     device=device())
    assert read("tail_idle.solve", wide) == pytest.approx(100 * 4 / 12, **PCT)
    # overlapping spans count the idle time they share once
    twice = RunRecord(spans=[span("solve:tail", 2, 1.5, parent="solve", req=0),
                             span("solve:tail", 1.5, 1, parent="solve", req=1)],
                      device=device())
    assert read("tail_idle.solve", twice) == pytest.approx(100 * 1.5 / 12, **PCT)


def test_tail_idle_reads_nothing_without_a_tail_in_the_traced_window():
    outside = RunRecord(spans=[span("solve:tail", 20, 10, parent="solve", req=0)],
                        device=device())
    assert read("tail_idle.solve", outside) is None
    assert read("tail_idle.solve", RunRecord(spans=outside.spans)) is None  # no trace
    assert solvespans.idle_inside_ns([], [(0, 1)]) is None


def test_a_span_lies_on_the_device_clock():
    e = span("solve:tail", 2, 1.5)
    lo, hi = solvespans.interval_ns(e)
    assert lo == pytest.approx(T0 + 2 * MS, abs=512) and hi - lo == pytest.approx(1.5 * MS, abs=512)
