"""The port's own tracing inside a solve (``repro_torch.obs``): the request
of each ``solve`` span (``req``, ``host_reads``), its child spans
``solve:voronoi``, ``solve:tail`` and ``solve:mst``, the measured round
spans of the resident kernel schedule, and the Unix-epoch clock that puts
every span on ``torch.profiler``'s axis.  The reference records none of
these, so nothing here imports it; ``test_torch_obs.py`` holds the rest of
the trace to the reference's.

Tolerance: exact for counts, args and results; the clock within 300 µs of
a profiler event recorded inside the span, and round boundaries within
1 µs of each other (one float's rounding of two Unix-epoch stamps).
"""

import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import obs
from repro_torch.analysis import sanitize
from repro_torch.core.graph import from_edges
from repro_torch.data.graphs import rmat_edges
from repro_torch.solver import SolverConfig, SteinerSolver

torch.set_num_threads(1)

CHILDREN = ("solve:voronoi", "solve:tail", "solve:mst")


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset()
    yield
    obs.reset()


@pytest.fixture(scope="module")
def graph():
    src, dst, w, n = rmat_edges(8, 6, max_weight=20, seed=1)
    seeds = np.random.default_rng(0).choice(n, 6, replace=False).astype(np.int32)
    return from_edges(src, dst, w, n, pad_to=8, device="cpu"), seeds


def _handle(graph, **kw):
    g, seeds = graph
    cfg = SolverConfig(**kw)
    if cfg.backend == "batch":
        seeds = np.stack([seeds, np.roll(seeds, 1), seeds[::-1]])
    h = SteinerSolver(cfg, device="cpu").prepare(g)
    h.solve(seeds)  # warm: memos built, as in a served stream
    return h, seeds


def _spans(name=None):
    return [e for e in obs.tracer().events()
            if e["ph"] == "X" and (name is None or e["name"] == name)]


def _end(e):
    return e["ts"] + e["dur"]


def _inside(inner, outer, slack=1.0):
    return outer["ts"] - slack <= inner["ts"] and _end(inner) <= _end(outer) + slack


SPECS = [
    dict(backend="single", mode="dense"),
    dict(backend="single", mode="bucket"),
    dict(backend="single", mode="frontier"),
    dict(backend="single", mode="pallas"),
    dict(backend="single", mode="pallas", pallas_frontier=True),
    dict(backend="single", mode="pallas", mst_algo="boruvka"),
    dict(backend="batch", mode="dense"),
    dict(backend="batch", mode="bucket"),
    dict(backend="batch", mode="pallas"),
    dict(backend="batch", mode="pallas", pallas_frontier=True),
]
MESH_SPECS = [
    dict(backend="mesh1d", mode="bucket", mesh_shape=(1, 1)),
    dict(backend="mesh1d", mode="frontier", mesh_shape=(1, 1)),
    dict(backend="mesh1d", mode="dense", mesh_shape=(1, 1), mst_algo="boruvka"),
    dict(backend="mesh2d", mode="bucket", mesh_shape=(1, 1)),
]


def _id(kw):
    extra = "-frontier" if kw.get("pallas_frontier") else ""
    extra += "-boruvka" if kw.get("mst_algo") == "boruvka" else ""
    return f"{kw['backend']}-{kw['mode']}{extra}"


@pytest.mark.parametrize("kw", SPECS, ids=_id)
def test_child_spans_nest_once_per_solve(graph, kw):
    """Two traced solves: each ``solve`` span has its own ``req``, and each
    has one ``solve:voronoi`` then one ``solve:tail`` inside it, with that
    ``req`` and ``parent="solve"``; ``solve:mst`` lies inside the tail
    (one a lane in a batch, whose tail span carries ``lanes``)."""
    h, seeds = _handle(graph, **kw)
    obs.enable()
    h.solve(seeds)
    h.solve(seeds)
    solves = _spans("solve")
    assert [s["args"]["req"] for s in solves] == [0, 1]
    lanes = seeds.shape[0] if kw["backend"] == "batch" else None
    for s in solves:
        req = s["args"]["req"]
        mine = {c: [e for e in _spans(c) if e["args"]["req"] == req] for c in CHILDREN}
        (vor,), (tail,) = mine["solve:voronoi"], mine["solve:tail"]
        assert vor["args"] == {"parent": "solve", "req": req}
        want = {"parent": "solve", "req": req}
        if lanes is not None:
            want["lanes"] = lanes
        assert tail["args"] == want
        assert _inside(vor, s) and _inside(tail, s) and _end(vor) <= tail["ts"] + 1.0
        msts = mine["solve:mst"]
        assert len(msts) == (lanes or 1)
        for m in msts:
            assert m["args"] == {"parent": "solve:tail", "req": req} and _inside(m, tail)


@pytest.mark.parametrize("kw", SPECS + MESH_SPECS, ids=_id)
def test_host_reads_equal_the_sanitizer(graph, kw):
    """The ``host_reads`` arg of a traced solve, counted at the read sites,
    equals the runtime sanitizer's count of the same solve, on every
    backend and mode (the mesh backends record no child spans)."""
    h, seeds = _handle(graph, **kw)
    obs.enable()
    with sanitize.host_read_guard() as rep:
        h.solve(seeds)
    (s,) = _spans("solve")
    assert s["args"]["host_reads"] == rep.host_reads > 0
    names = {e["name"] for e in _spans()}
    assert set(CHILDREN) & names == (set() if kw["backend"].startswith("mesh")
                                     else set(CHILDREN))


class _Ops(TorchDispatchMode):
    """Records the name of every aten op dispatched: the device work."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func._schema.name)
        return func(*args, **(kwargs or {}))


def _same(a, b):
    ra, rb = a.raw, b.raw
    for f in ("dist", "lab", "pred"):
        assert torch.equal(getattr(ra.state, f), getattr(rb.state, f)), f
    assert torch.equal(ra.parent, rb.parent) and torch.equal(ra.dmat, rb.dmat)
    for f in ("in_tree_vertex", "path_edge", "bridge_u", "bridge_v", "bridge_w",
              "bridge_valid", "total_distance", "num_edges"):
        assert torch.equal(getattr(ra.tree, f), getattr(rb.tree, f)), f
    np.testing.assert_array_equal(np.asarray(a.total_distance), np.asarray(b.total_distance))
    ta, tb = a.telemetry, b.telemetry
    assert (ta.iterations, ta.relaxations, ta.messages) == (tb.iterations, tb.relaxations,
                                                           tb.messages)
    np.testing.assert_array_equal(ta.per_round, tb.per_round)


@pytest.mark.parametrize("kw", [k for k in SPECS if k["mode"] == "pallas"], ids=_id)
def test_obs_on_dispatches_the_same_ops(graph, kw):
    """A solve with obs on equals the same handle's solve with obs off bit
    for bit and dispatches the same aten ops in the same order: the spans,
    stamps and tally launch nothing and read nothing."""
    h, seeds = _handle(graph, **kw)
    runs = []
    for on in (False, True):
        if on:
            obs.enable()
        with _Ops() as mode:
            out = h.solve(seeds)
        runs.append((out, mode.ops))
    (off, ops_off), (on, ops_on) = runs
    _same(off, on)
    assert ops_off == ops_on and ops_on
    assert _spans("solve:voronoi")


def test_span_ts_lies_on_the_profiler_clock():
    """A span's ``ts`` (and a retroactive span's, from perf_counter stamps)
    is Unix-epoch microseconds: a ``torch.profiler`` CPU event recorded
    inside the span starts within it, give or take 300 µs."""
    from torch.profiler import ProfilerActivity, profile

    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("probe"):
            t0 = obs.now()
            torch.ones(64).add_(1)
            t1 = obs.now()
        obs.add_span("retro", t0, t1)
    events = prof.profiler.kineto_results.events()
    (ones,) = [e for e in events if e.name() == "aten::ones"]
    for name in ("probe", "retro"):
        (s,) = _spans(name)
        lo, hi = s["ts"] * 1e3, _end(s) * 1e3  # ns
        assert lo - 300_000 <= ones.start_ns() <= hi + 300_000, (name, lo, ones.start_ns(), hi)
    assert abs(_spans("probe")[0]["ts"] * 1e3 - time.time_ns()) < 60e9


def test_enable_rereads_the_clock_offset():
    """Each ``enable()`` re-reads the offset; a stamp maps to ``time.time()``
    within a millisecond either way."""
    obs.enable()
    tr = obs.tracer()
    tr._epoch_us += 5e6  # as if the realtime clock had stepped 5 s
    obs.enable()
    t = time.perf_counter()
    obs.add_span("x", t, t)
    (s,) = _spans("x")
    assert abs(s["ts"] / 1e6 - time.time()) < 1e-3


@pytest.mark.parametrize("backend", ["single", "batch"])
def test_pallas_round_spans_tile_the_voronoi_span(graph, backend):
    """The resident kernel schedule stamps each round at its host read: its
    round spans are measured (no ``synthetic_timing``), one a round, end to
    end, and lie inside ``solve:voronoi``; the top-K schedule's rounds stay
    an even, flagged split of the solve."""
    h, seeds = _handle(graph, backend=backend, mode="pallas")
    obs.enable()
    out = h.solve(seeds)
    (vor,) = _spans("solve:voronoi")
    rounds = sorted(_spans(f"round[{backend}/pallas]"), key=lambda e: e["args"]["round"])
    assert len(rounds) == out.telemetry.iterations > 1
    assert [r["args"]["round"] for r in rounds] == list(range(len(rounds)))
    assert not any("synthetic_timing" in r["args"] for r in rounds)
    for a, b in zip(rounds, rounds[1:]):
        assert _end(a) == pytest.approx(b["ts"], abs=1.0)
    assert all(_inside(r, vor) for r in rounds)
    conv = sorted(e["ts"] for e in obs.tracer().events()
                  if e["name"] == f"convergence[{backend}/pallas]")
    assert conv == pytest.approx([r["ts"] for r in rounds], abs=1e-6)

    obs.reset()
    h, seeds = _handle(graph, backend=backend, mode="pallas", pallas_frontier=True)
    obs.enable()
    h.solve(seeds)
    rounds = _spans(f"round[{backend}/pallas]")
    assert rounds and all(r["args"]["synthetic_timing"] is True for r in rounds)


def test_requests_children_and_tally_outside_a_request():
    """Outside a request a child span is the shared no-op and the tally and
    stamps count nothing; with obs off ``request`` yields None and records
    nothing."""
    with obs.request("solve") as req:
        assert req is None
        assert obs.child("solve:tail", "solve") is obs.span("x")  # the shared no-op
    obs.enable()
    assert obs.child("solve:tail", "solve") is obs.child("solve:mst", "solve:tail")
    obs.host_read(3)
    obs.round_boundary()
    with obs.request("solve", mode="m") as req:
        obs.host_read(2)
        obs.round_boundary(read=False)
        obs.round_boundary()
        with obs.child("solve:tail", "solve", lanes=2):
            pass
    assert req.host_reads == 3 and len(req.round_stamps) == 2
    assert {e["name"]: e["args"] for e in _spans()} == {
        "solve:tail": {"parent": "solve", "req": 0, "lanes": 2},
        "solve": {"mode": "m", "req": 0, "host_reads": 3},
    }
