"""The dense, bucket and frontier Voronoi schedules of ``repro_torch`` against
``repro.core.voronoi``: one relaxation, the loops with and without Δ, their
caps, telemetry and warm starts, the exact Δ, and the top-K selection
against ``jax.lax.top_k``.

The port runs on the CPU (its plain PyTorch path).  Every comparison is
exact: state, counters and per-round telemetry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.graph as jgraph
import repro.core.voronoi as jv
from repro.delta.resolve import reset_affected
from _torch_parity import assert_same, both_graphs, instance
from repro_torch.core import graph as tgraph
from repro_torch.core import voronoi as tv

STAT_FIELDS = ("iterations", "relaxations", "messages", "history")


def _assert_voronoi_equal(jres, tres):
    (jst, jstat), (st, stat) = jres, tres
    for f in ("dist", "lab", "pred"):
        assert_same(getattr(jst, f), getattr(st, f))
    for f in STAT_FIELDS:
        a, b = getattr(jstat, f), getattr(stat, f)
        assert (a is None) == (b is None)
        if a is not None:
            assert_same(a, b)


def _port_state(jst):
    """A JAX VoronoiState as the port's (CPU tensors)."""
    return tv.VoronoiState(*(torch.from_numpy(np.array(getattr(jst, f)))
                             for f in ("dist", "lab", "pred")))


def _one_cell_reset(jst, seeds):
    """A converged state with the cell of seed 1 reset to its init rows
    (the reference's delta re-solve start), in both packages' types."""
    lab = np.asarray(jst.lab)
    changed = np.nonzero(lab == 1)[0][:1]
    warm, cells, n_reset = reset_affected(jst, seeds, changed, len(seeds))
    assert cells.tolist() == [1] and n_reset > 0
    return warm, _port_state(warm)


@pytest.mark.parametrize("trial", [0, 1, 2, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_relax_dense_matches_jax(trial, masked):
    src, dst, w, n, seeds = instance(trial)
    jg, tg = both_graphs(src, dst, w, n)
    jst, tst = jv.init_state(n, jnp.asarray(seeds)), tv.init_state(n, torch.from_numpy(seeds))
    for _ in range(3):
        jcand = tcand = None
        if masked:  # the bucket schedule's masking: sources under a threshold
            jd = jst.dist[jg.src]
            jcand = jnp.where(jd <= 4.0, jd + jg.w, jnp.inf)
            td = tst.dist[tg.src]
            tcand = torch.where(td <= 4.0, td + tg.w, float("inf"))
        jst, jupd = jv.relax_dense(jg, jst, jcand)
        tst, tupd = tv.relax_dense(tg, tst, tcand)
        assert_same(jupd, tupd)
        for f in ("dist", "lab", "pred"):
            assert_same(getattr(jst, f), getattr(tst, f))
        assert bool(jv._changed(jst, jst)) == bool(tv._changed(tst, tst)) is False


@pytest.mark.parametrize("trial", [0, 1, 2, 4, 5])
@pytest.mark.parametrize("mode,delta", [("dense", None), ("bucket", None), ("bucket", 3.0),
                                        ("bucket", 0.5), ("bucket", np.float32(40.0))])
def test_voronoi_cells_match_jax(trial, mode, delta):
    src, dst, w, n, seeds = instance(trial)
    jg, tg = both_graphs(src, dst, w, n)
    kw = dict(mode=mode, delta=delta, telemetry_rounds=9)
    _assert_voronoi_equal(jv.voronoi_cells(jg, jnp.asarray(seeds), **kw),
                          tv.voronoi_cells(tg, torch.from_numpy(seeds), **kw))


@pytest.mark.parametrize("mode", ["dense", "bucket"])
@pytest.mark.parametrize("kw", [dict(max_iters=3, telemetry_rounds=8),
                                dict(telemetry_rounds=2), dict(telemetry_rounds=0)])
def test_voronoi_cells_caps_and_telemetry_spill(mode, kw):
    """A round cap below the fixpoint, a history shorter than the rounds
    (its spill row takes the later rounds), and no history."""
    src, dst, w, n, seeds = instance(1)
    jg, tg = both_graphs(src, dst, w, n)
    j = jv.voronoi_cells(jg, jnp.asarray(seeds), mode=mode, **kw)
    t = tv.voronoi_cells(tg, torch.from_numpy(seeds), mode=mode, **kw)
    _assert_voronoi_equal(j, t)
    if "max_iters" in kw:
        assert int(t[1].iterations) == kw["max_iters"]
    elif kw["telemetry_rounds"]:
        assert int(t[1].iterations) > kw["telemetry_rounds"]


def test_delta_validation_matches_reference():
    src, dst, w, n, seeds = instance(0)
    jg, tg = both_graphs(src, dst, w, n)
    for bad, exc in ((torch.tensor(2.0), TypeError), (jnp.float32(2.0), TypeError),
                     (0.0, ValueError), (-1, ValueError)):
        with pytest.raises(exc) as got:
            tv.voronoi_cells(tg, torch.from_numpy(seeds), mode="bucket", delta=bad)
        if exc is ValueError:
            with pytest.raises(exc) as want:
                jv.voronoi_cells(jg, jnp.asarray(seeds), mode="bucket", delta=bad)
            assert str(got.value) == str(want.value)
        else:
            assert "delta must be a host scalar" in str(got.value)
    with pytest.raises(ValueError, match="telemetry_rounds"):
        tv.voronoi_cells(tg, torch.from_numpy(seeds), telemetry_rounds=-1)
    with pytest.raises(ValueError, match="unknown mode"):
        tv.voronoi_cells(tg, torch.from_numpy(seeds), mode="frontier")


@pytest.mark.parametrize("scale_w", [1.0, 1 / 7, 1e-3])
def test_bucket_delta_is_the_exact_mean(scale_w):
    """Δ: the exact sum of the finite weights rounded once to f32, over the
    count in f32; equal to the reference's f32 mean where that is exact."""
    src, dst, w, n, _ = instance(1)
    w = (w * np.float32(scale_w)).astype(np.float32)
    jg, tg = both_graphs(src, dst, w, n, pad_to=16)
    got = tv.bucket_delta(tg)
    finite = np.asarray(jg.w)[np.isfinite(np.asarray(jg.w))]
    exact = np.float32(np.sum(finite.astype(np.float64))) / np.float32(finite.size)
    assert got.dtype == np.float32 and got == max(exact, np.float32(1e-6))
    if scale_w == 1.0:  # integer weights: the reference's f32 sum is exact
        jw = jnp.where(jnp.isfinite(jg.w), jg.w, 0.0)
        want = jnp.maximum(jnp.sum(jw) / jnp.maximum(jnp.sum(jnp.isfinite(jg.w)), 1), 1e-6)
        assert got == np.float32(want)


def test_bucket_delta_rounds_once():
    """A sum past 2**24 that f32 accumulation would round many times: the
    exact sum is rounded once (ties to even), negative and subnormal
    weights included."""
    w = np.array([2.0**24, 1.0, 1.0, 1.0, -0.5, 1e-45, np.inf, 3.0], np.float32)
    g = tgraph.Graph(src=torch.zeros(8, dtype=torch.int32), dst=torch.zeros(8, dtype=torch.int32),
                     w=torch.from_numpy(w), n=1)
    total = 2.0**24 + 3 - 0.5 + float(np.float32(1e-45)) + 3.0
    assert tv.bucket_delta(g) == np.float32(np.float32(total) / np.float32(7))
    assert tv._round_f32(2**25 + 1, 0) == np.float32(2**25)  # tie: to even
    assert tv._round_f32(2**25 + 3, 0) == np.float32(2**25 + 4)
    assert tv._round_f32(-3, 1) == np.float32(-1.5)
    assert tv._round_f32(0, 149) == np.float32(0.0)


@pytest.mark.parametrize("mode", ["dense", "bucket"])
def test_warm_init_matches_jax(mode):
    """init=: a converged state with one cell reset converges to the cold
    fixpoint, with the reference's counters; a converged init exits after
    one quiet round (dense) or the bucket's quiet rounds."""
    src, dst, w, n, seeds = instance(2, n_seeds=6)
    jg, tg = both_graphs(src, dst, w, n)
    cold = jv.voronoi_cells(jg, jnp.asarray(seeds), mode=mode)
    jwarm, twarm = _one_cell_reset(cold[0], seeds)
    for jinit, tinit in ((jwarm, twarm), (cold[0], _port_state(cold[0]))):
        j = jv.voronoi_cells(jg, jnp.asarray(seeds), mode=mode, init=jinit, telemetry_rounds=6)
        t = tv.voronoi_cells(tg, torch.from_numpy(seeds), mode=mode, init=tinit,
                             telemetry_rounds=6)
        _assert_voronoi_equal(j, t)
        for f in ("dist", "lab", "pred"):
            assert_same(getattr(cold[0], f), getattr(t[0], f))


@pytest.mark.parametrize("trial", [0, 1, 2, 4])
@pytest.mark.parametrize("K", [1, 4, 48, 10**6])
def test_voronoi_cells_frontier_matches_jax(trial, K):
    src, dst, w, n, seeds = instance(trial)
    jg, tg = both_graphs(src, dst, w, n)
    je, te = jgraph.ell_view_cached(jg, 4), tgraph.ell_view_cached(tg, 4)
    kw = dict(frontier_size=K, telemetry_rounds=12)
    _assert_voronoi_equal(jv.voronoi_cells_frontier(je, jnp.asarray(seeds), **kw),
                          tv.voronoi_cells_frontier(te, torch.from_numpy(seeds), **kw))


@pytest.mark.parametrize("K", [4, 48])
def test_voronoi_cells_frontier_warm_matches_jax(K):
    """Warm starts: one cell reset (the violated-edge sweep marks its
    boundary), and a converged init, which exits after 0 rounds."""
    src, dst, w, n, seeds = instance(4, n_seeds=6)
    jg, tg = both_graphs(src, dst, w, n)
    je, te = jgraph.ell_view_cached(jg, 4), tgraph.ell_view_cached(tg, 4)
    cold = jv.voronoi_cells_frontier(je, jnp.asarray(seeds), frontier_size=K)
    jwarm, twarm = _one_cell_reset(cold[0], seeds)
    for jinit, tinit in ((jwarm, twarm), (cold[0], _port_state(cold[0]))):
        kw = dict(frontier_size=K, telemetry_rounds=5)
        j = jv.voronoi_cells_frontier(je, jnp.asarray(seeds), init=jinit, **kw)
        t = tv.voronoi_cells_frontier(te, torch.from_numpy(seeds), init=tinit, **kw)
        _assert_voronoi_equal(j, t)
        for f in ("dist", "lab", "pred"):
            assert_same(getattr(cold[0], f), getattr(t[0], f))
    assert int(t[1].iterations) == 0  # the converged init
    assert 0 < int(j[1].iterations) or jinit is cold[0]


def test_voronoi_cells_frontier_round_cap():
    src, dst, w, n, seeds = instance(1)
    jg, tg = both_graphs(src, dst, w, n)
    je, te = jgraph.ell_view_cached(jg, 4), tgraph.ell_view_cached(tg, 4)
    kw = dict(frontier_size=4, max_rounds=5, telemetry_rounds=3)
    j = jv.voronoi_cells_frontier(je, jnp.asarray(seeds), **kw)
    t = tv.voronoi_cells_frontier(te, torch.from_numpy(seeds), **kw)
    _assert_voronoi_equal(j, t)
    assert int(t[1].iterations) == 5


@pytest.mark.parametrize("shape", [(40,), (257,), (3, 100)])
@pytest.mark.parametrize("k", [1, 5, 17, 40])
@pytest.mark.parametrize("seed", [0, 1])
def test_smallest_k_selects_what_top_k_selects(shape, k, seed):
    """Tie-heavy priorities (a few integers, +inf, ±0.0): the same set of
    indices as ``jax.lax.top_k(-p, k)``, which takes the lower index first
    among equal values."""
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 3, shape).astype(np.float32)
    p[rng.random(shape) < 0.3] = np.inf
    p[rng.random(shape) < 0.1] = 0.0
    k = min(k, shape[-1])
    _, want = jax.lax.top_k(-jnp.asarray(p), k)
    got = tv.smallest_k(torch.from_numpy(p), k)
    assert got.dtype == torch.int64 and tuple(got.shape) == (*shape[:-1], k)
    assert_same(np.sort(np.asarray(want), axis=-1).astype(np.int64),
                np.sort(got.numpy(), axis=-1))


def test_smallest_k_breaks_ties_by_lower_index():
    p = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0, float("inf"), 1.0])
    assert sorted(tv.smallest_k(p, 3).tolist()) == [0, 1, 4]
    assert sorted(tv.smallest_k(p, 7).tolist()) == list(range(7))
    _, want = jax.lax.top_k(-jnp.asarray(p.numpy()), 3)
    assert sorted(np.asarray(want).tolist()) == [0, 1, 4]


def test_smallest_k_orders_signed_zero_and_negatives():
    p = torch.tensor([0.0, -0.0, -2.5, float("inf"), 1.0, -0.0, -1e-30])
    got = sorted(tv.smallest_k(p, 4).tolist())
    _, want = jax.lax.top_k(-jnp.asarray(p.numpy()), 4)
    assert got == sorted(np.asarray(want).tolist()) == [1, 2, 5, 6]
