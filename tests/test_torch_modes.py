"""Every (backend, mode, pallas_frontier) of the ``single`` and ``batch``
backends of ``repro_torch`` against ``repro.solver``, the scale-10 answers of
each schedule, warm starts through the solver, the ``steiner_tree`` and
``run_pipeline`` entry points, and the default-config server against the
JAX server on one stream.

The port runs on the CPU (its plain PyTorch path); the JAX package runs its
Pallas kernels in interpret mode, as its own tests do.  Exact everywhere,
``total_distance`` included (integer weights).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.steiner as jsteiner
import repro.serve as jserve
import repro.solver as jsolver
from repro.data.graphs import rmat_edges
from repro.delta.resolve import reset_affected
from _torch_parity import assert_same, both_graphs, instance
from repro_torch.core import steiner as tsteiner
from repro_torch.core import voronoi as tv
from repro_torch.data.graphs import select_seeds
from repro_torch.serve import ServeConfig, SteinerServer, steiner_tree_batch
from repro_torch.solver import SolverConfig, SteinerSolver

ROOT = Path(__file__).resolve().parents[1]
TREE_FIELDS = ("in_tree_vertex", "path_edge", "bridge_u", "bridge_v", "bridge_w",
               "bridge_valid", "total_distance", "num_edges")
STAT_FIELDS = ("iterations", "relaxations", "messages", "history")
SINGLE = [dict(mode="dense"), dict(mode="bucket"), dict(mode="bucket", delta=2.0),
          dict(mode="frontier", frontier_size=5), dict(mode="frontier"),
          dict(mode="pallas", pallas_frontier=True, frontier_size=5),
          dict(mode="pallas", pallas_frontier=True, frontier_size=5, src_block=16)]
BATCH = [dict(mode="dense"), dict(mode="bucket"), dict(mode="bucket", delta=2.0),
         dict(mode="pallas", pallas_frontier=True, frontier_size=5),
         dict(mode="pallas", pallas_frontier=True, frontier_size=5, src_block=16)]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_raw_equal(jraw, raw):
    """Two SteinerResults bit for bit: state, pair table, MST, tree, counters."""
    for f in ("dist", "lab", "pred"):
        assert_same(getattr(jraw.state, f), getattr(raw.state, f))
    assert_same(jraw.parent, raw.parent)
    assert_same(jraw.dmat, raw.dmat)
    for f in TREE_FIELDS:
        assert_same(getattr(jraw.tree, f), getattr(raw.tree, f))
    for f in STAT_FIELDS:
        a, b = getattr(jraw.stats, f), getattr(raw.stats, f)
        assert (a is None) == (b is None)
        if a is not None:
            assert_same(a, b)


def _assert_output_equal(jout, out):
    _assert_raw_equal(jout.raw, out.raw)
    assert_same(np.asarray(jout.total_distance), np.asarray(out.total_distance))
    assert_same(np.asarray(jout.num_edges), np.asarray(out.num_edges))
    jt, t = jout.telemetry, out.telemetry
    assert (t.iterations, t.relaxations, t.messages) == (jt.iterations, jt.relaxations,
                                                         jt.messages)
    assert (jt.per_round is None) == (t.per_round is None)
    if t.per_round is not None:
        assert_same(jt.per_round, t.per_round)


@pytest.mark.parametrize("trial", [0, 1, 2])
@pytest.mark.parametrize("kw", SINGLE, ids=lambda kw: "-".join(map(str, kw.values())))
def test_single_backend_matches_jax(trial, kw):
    src, dst, w, n, seeds = instance(trial, n_seeds=6)
    jg, tg = both_graphs(src, dst, w, n)
    cfg = dict(backend="single", ell_width=4, telemetry_rounds=12, **kw)
    jout = jsolver.SteinerSolver(jsolver.SolverConfig(**cfg)).prepare(jg).solve(seeds)
    out = SteinerSolver(SolverConfig(**cfg), device="cpu").prepare(tg).solve(seeds)
    _assert_output_equal(jout, out)


@pytest.mark.parametrize("kw", BATCH, ids=lambda kw: "-".join(map(str, kw.values())))
def test_batch_backend_matches_jax(kw):
    """Per lane bit for bit and the lane aggregation (slowest lane's rounds,
    summed counters and history rows) identical to ``repro``'s batch
    backend; a row padded with duplicates stays inert."""
    src, dst, w, n = rmat_edges(7, 6, max_weight=20, seed=3)
    jg, tg = both_graphs(src, dst, w, n)
    rng = np.random.default_rng(5)
    seeds = np.stack([rng.choice(n, 6, replace=False) for _ in range(4)]).astype(np.int32)
    seeds[2, 3:] = seeds[2, 0]
    cfg = dict(backend="batch", ell_width=8, telemetry_rounds=30, **kw)
    jout = jsolver.SteinerSolver(jsolver.SolverConfig(**cfg)).prepare(jg).solve(seeds)
    out = SteinerSolver(SolverConfig(**cfg), device="cpu").prepare(tg).solve(seeds)
    _assert_output_equal(jout, out)
    assert len(set(out.raw.stats.iterations.tolist())) > 1
    single = SteinerSolver(SolverConfig(**dict(cfg, backend="single")), device="cpu").prepare(tg)
    one = single.solve(seeds[1]).raw
    for f in ("dist", "lab", "pred"):
        assert_same(getattr(one.state, f), getattr(out.raw.state, f)[1])
    for f in STAT_FIELDS:
        assert_same(getattr(one.stats, f), getattr(out.raw.stats, f)[1])


def test_default_configs_solve():
    """SteinerSolver() and the batch backend with their defaults (mode
    "bucket") prepare without an ELL view and solve as the reference."""
    src, dst, w, n, seeds = instance(1, n_seeds=6)
    jg, tg = both_graphs(src, dst, w, n)
    h = SteinerSolver(device="cpu").prepare(tg)
    assert h.config.mode == "bucket" and h.artifact("ell") is None
    assert h.preprocessing == ("ell_view [mode=frontier|pallas]",)
    _assert_output_equal(jsolver.SteinerSolver().prepare(jg).solve(seeds), h.solve(seeds))
    hb = SteinerSolver(SolverConfig(backend="batch"), device="cpu").prepare(tg)
    assert hb.artifact("ell") is None and hb.preprocessing == ("ell_view [mode=pallas]",)
    rows = np.stack([seeds, seeds[::-1]])
    _assert_output_equal(
        jsolver.SteinerSolver(jsolver.SolverConfig(backend="batch")).prepare(jg).solve(rows),
        hb.solve(rows))


def test_scale10_answers_of_every_schedule():
    """The answers chip_smoke.py holds the card to: 547.0 (BENCH_steiner.json)
    and each schedule's counters, from both packages."""
    answers = _load("chip_smoke", ROOT / "chip_smoke.py").SCALE10_ANSWERS
    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    seeds = select_seeds(n, src, dst, 16, strategy="uniform", seed=1000)
    jg, tg = both_graphs(src, dst, w, n, pad_to=8)
    for name, want in answers.items():
        kw = (dict(mode="pallas", pallas_frontier=True) if name == "pallas_frontier"
              else dict(mode=name))
        for out in (SteinerSolver(SolverConfig(**kw), device="cpu").prepare(tg).solve(seeds),
                    jsolver.SteinerSolver(jsolver.SolverConfig(**kw)).prepare(jg).solve(seeds)):
            t = out.telemetry
            got = (out.total_distance, out.num_edges, t.iterations, t.relaxations, t.messages)
            assert got == want, name


@pytest.mark.parametrize("mode", ["dense", "bucket", "frontier"])
def test_warm_state_matches_jax(mode):
    """PreparedGraph.solve(seeds, warm_state=...): a converged state with one
    cell reset re-solves to the cold answer, with the reference's counters."""
    src, dst, w, n, seeds = instance(2, n_seeds=6)
    jg, tg = both_graphs(src, dst, w, n)
    cfg = dict(backend="single", mode=mode, ell_width=4, frontier_size=6)
    jh = jsolver.SteinerSolver(jsolver.SolverConfig(**cfg)).prepare(jg)
    h = SteinerSolver(SolverConfig(**cfg), device="cpu").prepare(tg)
    cold = jh.solve(seeds)
    changed = np.nonzero(np.asarray(cold.raw.state.lab) == 2)[0][:1]
    jwarm, _, n_reset = reset_affected(cold.raw.state, seeds, changed, len(seeds))
    assert n_reset > 0
    warm = tv.VoronoiState(*(torch.from_numpy(np.array(getattr(jwarm, f)))
                             for f in ("dist", "lab", "pred")))
    jout, out = jh.solve(seeds, warm_state=jwarm), h.solve(seeds, warm_state=warm)
    _assert_output_equal(jout, out)
    assert out.telemetry.relaxations < h.solve(seeds).telemetry.relaxations
    for f in ("dist", "lab", "pred"):
        assert_same(getattr(cold.raw.state, f), getattr(out.raw.state, f))


def test_warm_state_rejected_as_in_the_reference():
    src, dst, w, n, seeds = instance(0)
    jg, tg = both_graphs(src, dst, w, n)
    st = tv.init_state(n, torch.from_numpy(seeds))
    jst = jsteiner.vmod.init_state(n, jnp.asarray(seeds))
    for kw in (dict(backend="single", mode="pallas"),
               dict(backend="single", mode="pallas", pallas_frontier=True)):
        with pytest.raises(ValueError, match="warm-start init is only supported") as got:
            SteinerSolver(SolverConfig(**kw), device="cpu").prepare(tg).solve(
                seeds, warm_state=st)
        with pytest.raises(ValueError) as want:
            jsolver.SteinerSolver(jsolver.SolverConfig(**kw)).prepare(jg).solve(
                seeds, warm_state=jst)
        assert str(got.value) == str(want.value)
    for mode in ("bucket", "pallas"):
        rows = np.stack([seeds, seeds])
        with pytest.raises(ValueError, match="only supported by backend 'single'") as got:
            SteinerSolver(SolverConfig(backend="batch", mode=mode), device="cpu").prepare(
                tg).solve(rows, warm_state=st)
        with pytest.raises(ValueError) as want:
            jsolver.SteinerSolver(jsolver.SolverConfig(backend="batch", mode=mode)).prepare(
                jg).solve(rows, warm_state=jst)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", ["dense", "bucket", "frontier", "pallas"])
def test_steiner_tree_shim_matches_jax(mode):
    src, dst, w, n, seeds = instance(1, n_seeds=6)
    jg, tg = both_graphs(src, dst, w, n)
    kw = dict(mode=mode, ell_width=8, frontier_size=7)
    _assert_raw_equal(jsteiner.steiner_tree(jg, jnp.asarray(seeds), **kw),
                      tsteiner.steiner_tree(tg, seeds, **kw))


@pytest.mark.parametrize("kw", [dict(mode="dense"), dict(mode="bucket", delta=4.0),
                                dict(mode="bucket", telemetry_rounds=3, max_iters=7)])
def test_run_pipeline_matches_jax(kw):
    src, dst, w, n, seeds = instance(2, n_seeds=6)
    jg, tg = both_graphs(src, dst, w, n)
    _assert_raw_equal(jsteiner.run_pipeline(jg, jnp.asarray(seeds), **kw),
                      tsteiner.run_pipeline(tg, torch.from_numpy(seeds), **kw))


@pytest.mark.parametrize("mode", ["dense", "bucket"])
def test_steiner_tree_batch_modes_match_jax(mode):
    src, dst, w, n, _ = instance(1)
    jg, tg = both_graphs(src, dst, w, n)
    seeds = np.stack([np.arange(i, i + 5) for i in (0, 9, 30)]).astype(np.int32)
    _assert_raw_equal(jserve.steiner_tree_batch(jg, jnp.asarray(seeds), mode=mode),
                      steiner_tree_batch(tg, seeds, mode=mode))


def test_default_server_matches_jax_server():
    """SteinerServer(g) with ServeConfig() (mode "bucket") against the JAX
    server on perf_serve's stream at a small size: the same results, cache
    flags and edge sets, and the same non-latency stats."""
    perf_serve = _load("perf_serve", ROOT / "benchmarks" / "perf_serve.py")
    src, dst, w, n = rmat_edges(8, 8, max_weight=100, seed=0)
    jg, tg = both_graphs(src, dst, w, n, pad_to=8)
    rng = np.random.default_rng(0)
    pool = perf_serve.build_query_pool(n, rng, 10, (8, 16, 32))
    stream = [pool[i] for i in perf_serve.zipf_stream(rng, 10, 24, 1.1)]
    cfg = dict(materialize_edges=True)
    jsrv = jserve.SteinerServer(jg, jserve.ServeConfig(**cfg))
    tsrv = SteinerServer(tg, ServeConfig(**cfg), device="cpu")
    assert tsrv.config.mode == jsrv.config.mode == "bucket"
    jres, tres = [], []
    for i in range(0, len(stream), 8):
        tick = [(jsrv.submit(q), tsrv.submit(q)) for q in stream[i:i + 8]]
        jout, tout = jsrv.flush(), tsrv.flush()
        jres += [jout[a] for a, _ in tick]
        tres += [tout[b] for _, b in tick]
    assert any(r.from_cache for r in tres)
    for j, t in zip(jres, tres):
        assert (t.key, t.bucket, t.from_cache) == (j.key, j.bucket, j.from_cache)
        assert (t.total_distance, t.num_edges, t.edges) == (j.total_distance, j.num_edges,
                                                            j.edges)
    timed = ("qps", "latency_p50_ms", "latency_p99_ms", "fresh_p50_ms", "fresh_p99_ms",
             "cached_p50_ms", "cached_p99_ms")
    js, ts = jsrv.stats(), tsrv.stats()
    assert {k: v for k, v in ts.items() if k not in timed} == {
        k: v for k, v in js.items() if k not in timed}
