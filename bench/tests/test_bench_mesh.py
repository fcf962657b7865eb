"""The four-card cell's pieces that need no rank: its readers on synthetic
records, the check's reading of a mesh answer, and its control (the
reference in bfloat16 in the program's place), which has to fail."""

import signal
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from perfkit import check, manifest  # noqa: E402
from perfkit.devtrace import DeviceTrace  # noqa: E402
from perfkit.harness import RunRecord, run_control  # noqa: E402

MS = 1_000_000  # ns
CELL = "kg-mesh1d-4chip"


@pytest.fixture(autouse=True)
def time_limit():
    """Each test's own limit: an alarm that raises in the test."""

    def expire(*_):
        raise TimeoutError("the test passed its time limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def read(name, rec):
    return manifest.metric_reader(name)(rec)


def test_counter_readers():
    rec = RunRecord(rounds=[48, 52, 50], messages=[1000, 3000, 2000])
    assert read("rounds.mesh", rec) == pytest.approx(50.0)
    assert read("messages.mesh", rec) == pytest.approx(6000 / 150)
    for name in ("rounds.mesh", "messages.mesh"):
        assert read(name, RunRecord()) is None


def test_nccl_share_reader():
    """Two NCCL kernels that overlap count once; the union of all is the
    busy time; 10 ms of window."""
    trace = DeviceTrace(events=[
        ("void lex_segmin_kernel<float>", 0, 4 * MS),
        ("ncclDevKernel_AllGather_RING_LL(ncclDevComm*, unsigned long, ncclWork*)",
         4 * MS, 6 * MS),
        ("ncclKernel_AllReduce_RING_LL_Min_float", 5 * MS, 7 * MS),
        ("Memcpy DtoH (Device -> Pinned)", 8 * MS, 9 * MS),
    ], window_s=0.010)
    rec = RunRecord(device=trace)
    assert trace.busy_s() == pytest.approx(8e-3)
    assert read("nccl_share.mesh", rec) == pytest.approx(100 * 3 / 8)
    # a trace with no NCCL kernel, or none at all, reports nothing, never 0
    solo = RunRecord(device=DeviceTrace(events=[("k", 0, MS)], window_s=0.01))
    assert read("nccl_share.mesh", solo) is None
    assert read("nccl_share.mesh", RunRecord()) is None


def test_mesh_answer_is_read_by_name():
    """A mesh solve's host arrays map by name, ``marked`` to the tree's
    vertices; with no pair table and no parent, no graph_mismatch."""
    from repro_torch.core.dist_steiner import DistSteinerResult

    n, S = 6, 3
    raw = DistSteinerResult(
        dist=np.arange(n, dtype=np.float32), lab=np.zeros(n, np.int32),
        pred=np.arange(n, dtype=np.int32), marked=np.array([1, 1, 0, 0, 1, 0], bool),
        path_edge=np.zeros(n, bool), bridge_u=np.zeros(S, np.int32),
        bridge_v=np.ones(S, np.int32), bridge_w=np.full(S, 2.0, np.float32),
        bridge_valid=np.array([False, True, True]), total_distance=4.0, num_edges=2,
        iterations=5, relaxations=7.0, messages=9.0)
    got = check.solve_answer(raw)
    assert got["in_tree_vertex"] is raw.marked and "dmat" not in got
    assert got["total_distance"] == 4.0 and got["num_edges"] == 2
    ref = {k: v for k, v in got.items()}
    assert check.compare_solve(got, ref) == {"state_mismatch": 0, "tree_mismatch": 0,
                                             "total_gap": 0.0}
    ref["in_tree_vertex"] = np.array([1, 0, 0, 0, 1, 0], bool)
    assert check.compare_solve(got, ref)["tree_mismatch"] == 1


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_bfloat16_control_is_not_correct(seed):
    torch.set_num_threads(1)
    man = manifest.load_manifest()
    small = {"config": {"graph": {"scale": 12}},
             "traffic": {"sizes": {"dist": "fixed", "value": 64},
                         "check": {"sample": 4, "pool": 12}}}
    numbers, ok, lines = run_control(man, manifest.workload(man, CELL), seed, 0.5,
                                     device="cpu", overrides=small)
    assert not ok, lines
    assert numbers["compared"] == 5


def test_one_structure_for_every_seed():
    """With ``structure_seed`` every run's graph is the same graph in
    another vertex order; without it each seed draws a graph of its own."""
    from perfkit import graphgen

    cfg = manifest.config(manifest.load_manifest(), "kg-mesh1d")
    spec = dict(cfg["graph"], scale=10)

    def degrees(e):
        return torch.bincount(torch.cat([e.src, e.dst]).long(), minlength=e.n).sort().values

    a, b = graphgen.rmat(spec, 5, "cpu"), graphgen.rmat(spec, 3000000006, "cpu")
    assert torch.equal(degrees(a), degrees(b)) and torch.equal(a.w, b.w)
    assert not torch.equal(a.src, b.src)
    assert torch.equal(a.src, graphgen.rmat(spec, 5, "cpu").src)
    own = {k: v for k, v in spec.items() if k != "structure_seed"}
    c, d = graphgen.rmat(own, 5, "cpu"), graphgen.rmat(own, 3000000006, "cpu")
    assert not torch.equal(degrees(c), degrees(d))
