"""Every metric reader under bench/metrics/ on synthetic records: a
device trace, the program's spans and counters, a window's answers."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from perfkit import manifest, roofline  # noqa: E402
from perfkit.devtrace import DeviceTrace  # noqa: E402
from perfkit.harness import RunRecord  # noqa: E402

MS = 1_000_000  # ns


def read(name, rec):
    return manifest.metric_reader(name)(rec)


def kernel(name):
    return f"void (anonymous namespace)::{name}<float>(int const*, float const*, int2 const*)"


def solve_trace():
    """Two rounds: a record pack and the resident kernel each, with a copy
    that overlaps the first kernel; 10 ms of window."""
    return DeviceTrace(events=[
        (kernel("pack_records_kernel"), 0, 1 * MS),
        (kernel("minplus_resident_kernel"), 1 * MS, 3 * MS),
        ("Memcpy DtoH (Device -> Pinned)", 2 * MS, 4 * MS),
        (kernel("pack_records_kernel"), 6 * MS, 7 * MS),
        (kernel("minplus_resident_kernel"), 7 * MS, 9 * MS),
    ], window_s=0.010)


def test_device_trace_reductions():
    t = solve_trace()
    assert t.busy_s() == pytest.approx((4 + 3) * 1e-3)  # the union, overlap once
    assert t.idle_share() == pytest.approx(30.0)
    seen = t.by_kernel(["minplus_resident_kernel", "pack_records_kernel"])
    assert seen["minplus_resident_kernel"] == (2, pytest.approx(4e-3))  # not the lanes kernel
    assert seen["pack_records_kernel"] == (2, pytest.approx(2e-3))
    top = t.top_ops(2)
    assert top[0][0].startswith("void (anonymous namespace)::minplus_resident_kernel")
    assert top[0][1] == pytest.approx(4e-3)
    gaps = dict(t.idle_gaps())
    assert gaps == {"after Memcpy DtoH (Device -> Pinned)": pytest.approx(2e-3)}


def test_device_idle_readers():
    rec = RunRecord(device=solve_trace())
    for name in ("device_idle.solve", "device_idle.serve"):
        assert read(name, rec) == pytest.approx(30.0, abs=1e-4)
        assert read(name, RunRecord()) is None


def test_roofline_readers():
    E, N = 1000, 100
    rec = RunRecord(device=solve_trace(), graph_edges=E, graph_n=N, lanes=8)
    least = 2 * roofline.relax_bytes(E, N, 1) / 3.35e12
    assert read("minplus_roofline.solve", rec) == pytest.approx(100 * least / 6e-3)
    lanes = DeviceTrace(events=[(kernel("pack_records_kernel"), 0, MS),
                                (kernel("minplus_resident_lanes_kernel"), MS, 5 * MS)],
                        window_s=0.01)
    rec_l = RunRecord(device=lanes, graph_edges=E, graph_n=N, lanes=8)
    least = roofline.relax_bytes(E, N, 8) / 3.35e12
    assert read("minplus_roofline.serve", rec_l) == pytest.approx(100 * least / 5e-3)
    # a path that launches no such kernel reports nothing, never 0
    assert read("minplus_roofline.serve", rec) is None
    assert read("minplus_roofline.solve", rec_l) is None
    assert read("minplus_roofline.solve", RunRecord()) is None


def test_counter_and_span_readers():
    rec = RunRecord(rounds=[20, 22, 27])
    assert read("rounds.solve", rec) == pytest.approx(23.0)
    assert read("rounds.solve", RunRecord()) is None
    spans = [{"name": "serve:solve", "ph": "X", "ts": 0.0, "dur": 800_000.0},
             {"name": "serve:solve", "ph": "X", "ts": 1e6, "dur": 600_000.0},
             {"name": "serve:assemble", "ph": "X", "ts": 0.0, "dur": 5.0},
             {"name": "convergence[x]", "ph": "C", "ts": 0.0, "args": {}}]
    assert read("batch_ms.serve", RunRecord(spans=spans)) == pytest.approx(700.0)
    assert read("batch_ms.serve", RunRecord()) is None


def test_end_to_end_readers():
    rec = RunRecord(setup_s=14.5, window_s=51.2, attempted=110, completed=110)
    assert read("setup_s", rec) == 14.5
    assert read("solve_ms", rec) == pytest.approx(51200 / 110)
    assert read("served_qps", rec) == pytest.approx(110 / 51.2)
    assert read("solve_ms", RunRecord()) is None
