"""The serving path of ``repro_torch`` against ``repro``: the planner, the
batch backend in mode="pallas" (lane by lane and aggregated), the batched
fixpoint against single solves, inert padding, the server on a Zipf stream,
its cache and its exception-safe flush.

The port runs on the CPU (its plain PyTorch path); the JAX package runs its
Pallas kernels in interpret mode, as its own tests do.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro.solver as jsolver
from repro.core import ref as jref
from repro.data.graphs import rmat_edges
from _torch_parity import assert_same, both_graphs, instance
from repro_torch.graphstore import StoreFormatError
from repro_torch.kernels.minplus import minplus as tmp
from repro_torch.kernels.minplus import ops as tops
from repro_torch.kernels.minplus.ref import minplus_torch
from repro_torch.serve import (
    ServeConfig,
    SteinerServer,
    canonical_key,
    choose_bucket,
    pad_seed_set,
    plan_query,
    steiner_tree_batch,
)
from repro_torch.serve import plan as tplan
from repro_torch.solver import SolverConfig, SteinerSolver
from _minplus_inputs import ell_inputs

TREE_FIELDS = ("in_tree_vertex", "path_edge", "bridge_u", "bridge_v", "bridge_w",
               "bridge_valid", "total_distance", "num_edges")
STAT_FIELDS = ("iterations", "relaxations", "messages", "history")
# stats() keys that are wall-clock times
TIMED_KEYS = ("qps", "latency_p50_ms", "latency_p99_ms", "fresh_p50_ms", "fresh_p99_ms",
              "cached_p50_ms", "cached_p99_ms")


@pytest.fixture(scope="module")
def rmat9():
    """RMAT scale 9 (n = 512) as a JAX and a port graph, and its edge list."""
    src, dst, w, n = rmat_edges(9, 8, max_weight=100, seed=0)
    jg, tg = both_graphs(src, dst, w, n, pad_to=8)
    return jg, tg, n, list(zip(src.tolist(), dst.tolist(), w.tolist()))


def _seed_batch(n, B, S, seed):
    """(B, S) seed rows; row 1 repeats its first seed (duplicate padding)."""
    rng = np.random.default_rng(seed)
    rows = np.stack([rng.choice(n, S, replace=False) for _ in range(B)]).astype(np.int32)
    rows[1, S // 2:] = rows[1, 0]
    return rows


def _assert_lane_equal(a, b, lane_b=None):
    """SteinerResult ``b`` (lane ``lane_b`` of a batch if given) equals ``a``
    bit for bit: state, pair table, MST, tree and counters."""
    pick = (lambda x: x) if lane_b is None else (lambda x: x[lane_b])
    for f in ("dist", "lab", "pred"):
        assert_same(getattr(a.state, f), pick(getattr(b.state, f)))
    assert_same(a.parent, pick(b.parent))
    assert_same(a.dmat, pick(b.dmat))
    for f in TREE_FIELDS:
        assert_same(getattr(a.tree, f), pick(getattr(b.tree, f)))
    for f in STAT_FIELDS:
        x, y = getattr(a.stats, f), getattr(b.stats, f)
        assert (x is None) == (y is None)
        if x is not None:
            assert_same(x, pick(y))


# ----------------------------------------------------------------------------
# plan.py
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("fn,args", [
    ("canonical_key", ([5, 3, 5, 9, 3],)),
    ("canonical_key", (np.array([7, 1, 7], np.int32),)),
    ("choose_bucket", (2, (8, 16))),
    ("choose_bucket", (9, (16, 8))),
    ("choose_bucket", (17, (8, 16))),
    ("pad_seed_set", ((3, 7, 11), 8)),
    ("pad_seed_set", ((), 8)),
    ("pad_seed_set", ((1, 2, 3), 2)),
    ("plan_query", ([9, 4, 4, 1],)),
    ("plan_query", ([4, 4, 4],)),
    ("plan_query", (list(range(70)),)),
])
def test_plan_matches_reference(fn, args):
    """Same values, or the same error, as ``repro.serve.plan``."""
    def run(mod):
        try:
            return getattr(mod, fn)(*args), None
        except ValueError as e:
            return None, str(e)

    (want, werr), (got, gerr) = run(jserve.plan), run(tplan)
    assert gerr == werr
    if isinstance(want, jserve.QueryPlan):
        assert dataclasses.asdict(got).keys() == dataclasses.asdict(want).keys()
        assert (got.key, got.bucket, got.num_unique) == (want.key, want.bucket, want.num_unique)
        assert_same(want.padded, got.padded)
    elif isinstance(want, np.ndarray):
        assert_same(want, got)
    else:
        assert got == want
    assert tplan.DEFAULT_BUCKETS == jserve.DEFAULT_BUCKETS


def test_plan_exports():
    assert canonical_key([2, 1]) == (1, 2) and choose_bucket(3) == 8
    assert pad_seed_set((4, 5), 4).tolist() == [4, 5, 4, 4]
    assert plan_query([6, 2]).padded.dtype == np.int32


# ----------------------------------------------------------------------------
# the batch backend: against the JAX batch backend, and lane by lane
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(),
    dict(telemetry_rounds=6),
    dict(src_block=64, telemetry_rounds=0),
    dict(max_iters=3),
])
def test_batch_backend_matches_jax(rmat9, kw):
    """Per lane bit for bit (state, pair table, MST, tree, counters) and
    the aggregated telemetry identical to ``repro``'s batch backend."""
    jg, tg, n, _ = rmat9
    seeds = _seed_batch(n, 4, 8, seed=3)
    cfg = dict(backend="batch", mode="pallas", **kw)
    jout = jsolver.SteinerSolver(jsolver.SolverConfig(**cfg)).prepare(jg).solve(seeds)
    out = SteinerSolver(SolverConfig(**cfg), device="cpu").prepare(tg).solve(seeds)
    for b in range(len(seeds)):
        for f in ("dist", "lab", "pred"):
            assert_same(getattr(jout.raw.state, f)[b], getattr(out.raw.state, f)[b])
        assert_same(jout.raw.parent[b], out.raw.parent[b])
        assert_same(jout.raw.dmat[b], out.raw.dmat[b])
        for f in TREE_FIELDS:
            assert_same(getattr(jout.raw.tree, f)[b], getattr(out.raw.tree, f)[b])
        for f in STAT_FIELDS[:3]:
            assert_same(getattr(jout.raw.stats, f)[b], getattr(out.raw.stats, f)[b])
    assert (jout.raw.stats.history is None) == (out.raw.stats.history is None)
    if out.raw.stats.history is not None:
        assert_same(jout.raw.stats.history, out.raw.stats.history)
    assert_same(jout.total_distance, out.total_distance)
    assert_same(jout.num_edges, out.num_edges)
    jt, t = jout.telemetry, out.telemetry
    assert (t.iterations, t.relaxations, t.messages) == (jt.iterations, jt.relaxations,
                                                         jt.messages)
    assert (jt.per_round is None) == (t.per_round is None)
    if t.per_round is not None:
        assert_same(jt.per_round, t.per_round)


@pytest.mark.parametrize("max_iters", [None, 4])
def test_lanes_equal_single_solves(rmat9, max_iters):
    """Every lane equals a single solve of its row, though the lanes
    converge in different numbers of rounds (and under a round cap)."""
    _, tg, n, _ = rmat9
    seeds = _seed_batch(n, 5, 6, seed=1)
    kw = dict(mode="pallas", max_iters=max_iters, telemetry_rounds=12)
    batch = SteinerSolver(SolverConfig(backend="batch", **kw), device="cpu").prepare(tg)
    single = SteinerSolver(SolverConfig(backend="single", **kw), device="cpu").prepare(tg)
    out = batch.solve(seeds)
    iters = out.raw.stats.iterations.tolist()
    if max_iters is None:
        assert len(set(iters)) > 1, "lanes should converge in different rounds"
    else:
        assert iters == [max_iters] * len(seeds)
    for b, row in enumerate(seeds):
        one = single.solve(row)
        _assert_lane_equal(one.raw, out.raw, b)
        assert float(out.total_distance[b]) == one.total_distance
        assert int(out.num_edges[b]) == one.num_edges
    assert out.telemetry.iterations == max(iters)


def test_relax_ell_lanes_equal_single_relaxations(rmat9):
    _, tg, n, _ = rmat9
    ell = SteinerSolver(SolverConfig(backend="batch", mode="pallas"),
                        device="cpu").prepare(tg).artifact("ell")
    seeds = torch.from_numpy(_seed_batch(n, 3, 5, seed=8))
    st = tops.init_states(n, seeds)
    for _ in range(3):
        new, upd = tops.relax_ell(ell, st)
        for b in range(3):
            lane = type(st)(dist=st.dist[b], lab=st.lab[b], pred=st.pred[b])
            one, one_upd = tops.relax_ell(ell, lane)
            assert_same(one_upd, upd[b])
            for f in ("dist", "lab", "pred"):
                assert_same(getattr(one, f), getattr(new, f)[b])
        st = new


def test_duplicate_seed_and_lane_padding_inert(rmat9):
    """A row padded with its first seed and a batch padded with copies of
    lane 0 change no real lane, and the padded totals equal the canonical
    unpadded solve's."""
    _, tg, n, _ = rmat9
    rng = np.random.default_rng(4)
    keys = [np.sort(rng.choice(n, k, replace=False)) for k in (3, 5)]
    rows = np.stack([pad_seed_set(k.tolist(), 8) for k in keys] + [pad_seed_set(
        keys[0].tolist(), 8)] * 2)
    cfg = SolverConfig(backend="batch", mode="pallas")
    out = SteinerSolver(cfg, device="cpu").prepare(tg).solve(rows)
    for b in (2, 3):
        for f in ("dist", "lab", "pred"):
            assert_same(getattr(out.raw.state, f)[0], getattr(out.raw.state, f)[b])
        assert out.total_distance[b] == out.total_distance[0]
    single = SteinerSolver(cfg.replace(backend="single"), device="cpu").prepare(tg)
    for b, k in enumerate(keys):
        base = single.solve(k.astype(np.int32))
        assert float(out.total_distance[b]) == base.total_distance
        assert int(out.num_edges[b]) == base.num_edges
        assert_same(base.raw.state.lab, out.raw.state.lab[b])
        assert_same(base.raw.state.dist, out.raw.state.dist[b])


def test_steiner_tree_batch_is_the_backend(rmat9):
    _, tg, n, _ = rmat9
    seeds = _seed_batch(n, 3, 4, seed=5)
    res = steiner_tree_batch(tg, seeds, mode="pallas")
    out = SteinerSolver(SolverConfig(backend="batch", mode="pallas"),
                        device="cpu").prepare(tg).solve(seeds)
    for f in ("dist", "lab", "pred"):
        assert_same(getattr(out.raw.state, f), getattr(res.state, f))
    for f in TREE_FIELDS:
        assert_same(getattr(out.raw.tree, f), getattr(res.tree, f))
    with pytest.raises(ValueError, match=r"\(B, S\)"):
        steiner_tree_batch(tg, np.arange(5, dtype=np.int32), mode="pallas")
    # mode="bucket", the reference's default: the batch backend in that mode
    res = steiner_tree_batch(tg, seeds)
    out = SteinerSolver(SolverConfig(backend="batch"), device="cpu").prepare(tg).solve(seeds)
    for f in ("dist", "lab", "pred"):
        assert_same(getattr(out.raw.state, f), getattr(res.state, f))
    for f in TREE_FIELDS:
        assert_same(getattr(out.raw.tree, f), getattr(res.tree, f))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_minplus_torch_lanes_equal_single_lane_calls(B, dtype):
    R, K, N = 300, 12, 500
    nbr, wgt, _, _ = ell_inputs(R, K, N, seed=B)
    lanes = [ell_inputs(R, K, N, seed=10 + b)[2:] for b in range(B)]
    dist = torch.from_numpy(np.stack([d for d, _ in lanes])).to(dtype)
    dist[B - 1] = float("inf")  # one lane entirely unreached
    lab = torch.from_numpy(np.stack([lb for _, lb in lanes]))
    nbr, wgt = torch.from_numpy(nbr), torch.from_numpy(wgt).to(dtype)
    got = minplus_torch(nbr, wgt, dist, lab)
    for b in range(B):
        for x, y in zip(minplus_torch(nbr, wgt, dist[b], lab[b]), got):
            assert_same(x, y[b])
    # the wrappers take the same plain path for CPU tensors
    for out in (tmp.minplus_call(nbr, wgt, dist, lab),
                tmp.minplus_blocked_call(nbr, wgt, dist, lab, src_block=100)):
        for x, y in zip(got, out):
            assert_same(x, y)
    with pytest.raises(ValueError, match=r"\(B, N\)"):
        tmp.minplus_call(nbr, wgt, dist[None], lab[None])


# ----------------------------------------------------------------------------
# the server
# ----------------------------------------------------------------------------


def _zipf_stream(n, seed, pool_size=14, num_queries=40, s=1.1, buckets=(8, 16, 32)):
    """The query stream of benchmarks/perf_serve.py at a small size, made
    by that benchmark's own helpers."""
    spec = importlib.util.spec_from_file_location(
        "perf_serve", Path(__file__).resolve().parent.parent / "benchmarks" / "perf_serve.py")
    perf_serve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(perf_serve)
    rng = np.random.default_rng(seed)
    pool = perf_serve.build_query_pool(n, rng, pool_size, buckets)
    return [pool[i] for i in perf_serve.zipf_stream(rng, pool_size, num_queries, s)]


def test_zipf_stream_matches_jax_server(rmat9):
    """The same stream through both servers: the same results, cache flags
    and edge sets, and the same non-latency stats() and Prometheus series."""
    jg, tg, n, edges = rmat9
    kw = dict(mode="pallas", buckets=(8, 16, 32), max_batch=4, materialize_edges=True)
    jsrv = jserve.SteinerServer(jg, jserve.ServeConfig(**kw))
    tsrv = SteinerServer(tg, ServeConfig(**kw), device="cpu")
    stream = _zipf_stream(n, seed=0)
    for srv in (jsrv, tsrv):
        srv.warmup()
    jres, tres = [], []
    for i in range(0, len(stream), 8):  # flush every 8, as perf_serve does
        tick = [(jsrv.submit(q), tsrv.submit(q)) for q in stream[i:i + 8]]
        jout, tout = jsrv.flush(), tsrv.flush()
        jres += [jout[a] for a, _ in tick]
        tres += [tout[b] for _, b in tick]
    assert any(r.from_cache for r in tres) and not all(r.from_cache for r in tres)
    for q, j, t in zip(stream, jres, tres):
        assert (t.key, t.bucket, t.from_cache) == (j.key, j.bucket, j.from_cache)
        assert (t.total_distance, t.num_edges, t.edges) == (j.total_distance, j.num_edges,
                                                            j.edges)
        assert jref.tree_is_valid(n, edges, list(t.key), t.edges)
    js, ts = jsrv.stats(), tsrv.stats()
    assert js.keys() == ts.keys()
    assert {k: v for k, v in ts.items() if k not in TIMED_KEYS} == {
        k: v for k, v in js.items() if k not in TIMED_KEYS}

    def untimed(text):
        return [ln for ln in text.splitlines() if "serve_latency_seconds" not in ln]

    assert untimed(tsrv.prometheus_text()) == untimed(jsrv.prometheus_text())


def _server(g, **kw):
    cfg = ServeConfig(
        mode="pallas",
        buckets=kw.pop("buckets", (8, 16)),
        max_batch=kw.pop("max_batch", 3),
        materialize_edges=kw.pop("materialize_edges", True),
        **kw,
    )
    return SteinerServer(g, cfg, device="cpu")


def _small():
    src, dst, w, n, _ = instance(2)
    return both_graphs(src, dst, w, n)[1]


def test_cache_returns_identical_tree_on_repeat():
    srv = _server(_small())
    q = [1, 9, 17, 25]
    r1 = srv.query(q)
    r2 = srv.query(list(reversed(q)))  # permuted repeat
    r3 = srv.query([1, 9, 9, 17, 25, 1])  # with duplicates
    assert not r1.from_cache and r2.from_cache and r3.from_cache
    assert r1.key == r2.key == r3.key
    assert r1.total_distance == r2.total_distance == r3.total_distance
    assert r1.edges == r2.edges == r3.edges
    st = srv.stats()
    assert st["completed"] == 3 and st["cache_hits"] == 2


def test_duplicate_keys_in_one_batch_share_a_lane():
    srv = _server(_small())
    res = srv.query_many([[2, 30, 7], [7, 2, 30], [2, 7, 30]])
    assert len({r.total_distance for r in res}) == 1
    assert srv.stats()["batches_per_bucket"][8] == 1  # one batch in all


def test_lru_eviction():
    srv = _server(_small(), cache_capacity=2)
    a, b, c = [1, 5], [2, 6], [3, 7]
    srv.query(a)
    srv.query(b)
    srv.query(c)  # evicts a
    assert len(srv.cache) == 2
    assert not srv.query(a).from_cache  # recomputed
    assert srv.query(a).from_cache


def test_cache_disabled():
    srv = _server(_small(), cache_capacity=0)
    q = [4, 12, 20]
    assert not srv.query(q).from_cache
    assert not srv.query(q).from_cache
    assert srv.stats()["cache_hits"] == 0


def test_stats_idle_and_split_latency():
    srv = _server(_small())
    st = srv.stats()
    assert st["completed"] == 0
    assert all(st[k] is None for k in TIMED_KEYS if k != "qps")
    srv.query([1, 9, 17, 25])  # fresh solve
    srv.query([1, 9, 17, 25])  # cache hit
    st = srv.stats()
    assert st["cached_p50_ms"] <= st["fresh_p50_ms"]
    assert st["latency_p99_ms"] >= st["latency_p50_ms"] >= 0.0
    assert st["qps"] > 0 and st["lanes_run"] % 3 == 0


def test_flush_requeues_pendings_on_solver_failure(monkeypatch):
    """A solver failure mid-flush drops no ticket: the batch's riders (fresh
    and cache-hit) go back on the queue and the exception propagates."""
    srv = _server(_small())
    q_cached, q_fresh = [1, 5, 9], [2, 6, 10]
    srv.query(q_cached)  # warm the cache
    t1 = srv.submit(q_cached)  # will ride as a cache hit
    t2 = srv.submit(q_fresh)  # needs a lane
    real_solve = srv._handle.solve

    def failing(seed_batch):
        raise RuntimeError("injected solver failure")

    monkeypatch.setattr(srv._handle, "solve", failing)
    with pytest.raises(RuntimeError, match="injected solver failure"):
        srv.flush()
    assert srv.pending() == 2, "failed batch's tickets must be re-queued"
    monkeypatch.setattr(srv._handle, "solve", real_solve)
    out = srv.flush()
    assert set(out) == {t1, t2}
    assert out[t1].from_cache and not out[t2].from_cache
    assert out[t2].total_distance > 0


def test_flush_failure_after_completed_batch_loses_no_tickets(monkeypatch):
    """When a later batch fails mid-flush, the tickets of batches already
    run in the same call are delivered by the retry flush."""
    src, dst, w, n, _ = instance(1)
    srv = _server(both_graphs(src, dst, w, n)[1], max_batch=2, cache_capacity=0)
    tickets = [srv.submit([2 + i, 30 + i, 7 + i]) for i in range(4)]
    real_solve = srv._handle.solve
    calls = {"n": 0}

    def fail_second(seed_batch):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected solver failure")
        return real_solve(seed_batch)

    monkeypatch.setattr(srv._handle, "solve", fail_second)
    with pytest.raises(RuntimeError, match="injected solver failure"):
        srv.flush()
    assert srv.pending() == 2
    monkeypatch.setattr(srv._handle, "solve", real_solve)
    out = srv.flush()
    assert set(out) == set(tickets), "completed batch's tickets were lost"
    assert all(out[t].total_distance > 0 for t in tickets)


def test_query_preserves_other_callers_results():
    src, dst, w, n, _ = instance(1)
    srv = _server(both_graphs(src, dst, w, n)[1], max_batch=2, cache_capacity=0)
    t_other = srv.submit([3, 11, 19])  # a flush()-level consumer's ticket
    r_mine = srv.query([4, 12, 20])  # drains t_other's batch too
    assert r_mine.total_distance > 0
    out = srv.flush()
    assert t_other in out, "query() discarded another caller's result"
    assert out[t_other].total_distance > 0


def test_server_rejects_what_is_not_ported():
    g = _small()
    # the default config (mode="bucket") serves: a query equals the single
    # bucket solve of its padded seed row
    q = SteinerServer(g, ServeConfig(), device="cpu").query([1, 9, 17, 25])
    one = SteinerSolver(SolverConfig(), device="cpu").prepare(g).solve(pad_seed_set(q.key, 8))
    assert (q.total_distance, q.num_edges) == (one.total_distance, one.num_edges)
    # graph_path= opens a store (tests/test_torch_store.py serves from
    # one): a path that holds none is refused by the store's reader
    with pytest.raises(StoreFormatError, match="not a .gstore directory"):
        SteinerServer(graph_path="some.gstore", device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        SteinerServer(device="cpu")
    srv = _server(g)
    for call in (lambda: srv.apply_deltas([]), lambda: srv.bump_epoch()):
        with pytest.raises(ValueError, match="store-backed server"):
            call()
    with pytest.raises(ValueError, match="seed ids"):
        srv.submit([0, g.n])
    assert ServeConfig() == ServeConfig(**{
        f.name: f.default for f in dataclasses.fields(jserve.ServeConfig)})
