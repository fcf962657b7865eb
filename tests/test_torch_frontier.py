"""The top-K kernel schedule of ``repro_torch`` (``pallas_frontier=True``)
against ``repro.kernels.minplus.ops.voronoi_cells_pallas_frontier``, the JAX
Pallas path in interpret mode: resident and source-blocked, its lane loop
against ``jax.vmap`` of it and against single loops, and solves whose
top-K selections cut through ties at the K-th priority.

The port runs on the CPU (its plain PyTorch path).  Every comparison is
exact: state, counters and per-round telemetry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.graph as jgraph
import repro.solver as jsolver
from repro.data.graphs import grid_edges
from repro.kernels.minplus import ops as jops
from _torch_parity import assert_same, both_graphs, instance
from repro_torch.core import graph as tgraph
from repro_torch.core import voronoi as tv
from repro_torch.kernels.minplus import ops as tops
from repro_torch.solver import SolverConfig, SteinerSolver

STAT_FIELDS = ("iterations", "relaxations", "messages", "history")


def _ells(trial, k=4):
    src, dst, w, n, seeds = instance(trial)
    jg, tg = both_graphs(src, dst, w, n)
    return jgraph.ell_view_cached(jg, k), tgraph.ell_view_cached(tg, k), n, seeds


def _assert_equal(jres, tres, lane=None):
    """(state, stats) ``jres`` equals ``tres`` (its lane ``lane`` if given)."""
    pick = (lambda x: x) if lane is None else (lambda x: x[lane])
    (jst, jstat), (st, stat) = jres, tres
    for f in ("dist", "lab", "pred"):
        assert_same(getattr(jst, f), pick(getattr(st, f)))
    for f in STAT_FIELDS:
        a, b = getattr(jstat, f), getattr(stat, f)
        assert (a is None) == (b is None)
        if a is not None:
            assert_same(a, pick(b))


@pytest.mark.parametrize("trial", [0, 1, 2])
@pytest.mark.parametrize("K", [1, 4, 48])
@pytest.mark.parametrize("src_block", [None, 64, 11])
def test_pallas_frontier_matches_jax(trial, K, src_block):
    """Resident and source-blocked (a block of 64, and 11, which divides no
    N here), against the Pallas path in interpret mode."""
    je, te, n, seeds = _ells(trial)
    assert src_block != 11 or n % src_block
    kw = dict(frontier_size=K, src_block=src_block, block_rows=8, telemetry_rounds=16)
    j = jops.voronoi_cells_pallas_frontier(je, jnp.asarray(seeds), interpret=True, **kw)
    t = tops.voronoi_cells_pallas_frontier(te, torch.from_numpy(seeds), **kw)
    _assert_equal(j, t)
    # the dense schedule's fixpoint, unless the round cap (16n + 64) cut the
    # loop short, as it does the reference's at K = 1
    if int(t[1].iterations) < 16 * n + 64:
        for f in ("dist", "lab", "pred"):
            assert_same(getattr(tops.voronoi_cells_pallas(te, torch.from_numpy(seeds))[0], f),
                        getattr(t[0], f))


def test_pallas_frontier_round_cap_and_spill():
    je, te, n, seeds = _ells(1)
    kw = dict(frontier_size=4, max_iters=9, telemetry_rounds=4)
    j = jops.voronoi_cells_pallas_frontier(je, jnp.asarray(seeds), interpret=True, **kw)
    t = tops.voronoi_cells_pallas_frontier(te, torch.from_numpy(seeds), **kw)
    _assert_equal(j, t)
    assert int(t[1].iterations) == 9


@pytest.mark.parametrize("K", [4, 48])
@pytest.mark.parametrize("src_block", [None, 11])
def test_pallas_frontier_lanes_match_vmap_and_single(K, src_block):
    """The lane loop (one launch a round for all active lanes) equals
    ``jax.vmap`` of the reference loop and each lane's single loop, though
    the lanes converge in different rounds; a lane of duplicate seeds stays
    inert."""
    je, te, n, _ = _ells(2)
    rng = np.random.default_rng(K)
    seeds = np.stack([rng.choice(n, 5, replace=False) for _ in range(4)]).astype(np.int32)
    seeds[3, 2:] = seeds[3, 0]
    kw = dict(frontier_size=K, src_block=src_block, telemetry_rounds=40)
    j = jax.vmap(lambda s: jops.voronoi_cells_pallas_frontier(
        je, s, interpret=True, block_rows=8, **kw))(jnp.asarray(seeds))
    t = tops.voronoi_cells_pallas_frontier_lanes(te, torch.from_numpy(seeds), **kw)
    _assert_equal(j, t)
    iters = t[1].iterations.tolist()
    assert len(set(iters)) > 1, "lanes should converge in different rounds"
    for b, row in enumerate(seeds):
        _assert_equal(tops.voronoi_cells_pallas_frontier(te, torch.from_numpy(row), **kw), t,
                      lane=b)


def test_pallas_frontier_lanes_round_cap():
    je, te, n, _ = _ells(0)
    seeds = np.stack([np.arange(3), np.arange(3, 6)]).astype(np.int32)
    kw = dict(frontier_size=2, max_iters=5, telemetry_rounds=3)
    j = jax.vmap(lambda s: jops.voronoi_cells_pallas_frontier(
        je, s, interpret=True, **kw))(jnp.asarray(seeds))
    t = tops.voronoi_cells_pallas_frontier_lanes(te, torch.from_numpy(seeds), **kw)
    _assert_equal(j, t)
    assert t[1].iterations.tolist() == [5, 5]


def _count_tie_cuts(monkeypatch, module):
    """Wraps ``module.smallest_k`` to count the selections that leave out a
    priority equal to the K-th smallest (finite) one: where the tie rule
    decides which rows go."""
    cuts, select = [], tv.smallest_k

    def counting(p, k):
        rows = select(p, k)
        kth = p.gather(-1, rows).max(dim=-1, keepdim=True).values
        left_out = (p == kth).sum(dim=-1) - (p.gather(-1, rows) == kth).sum(dim=-1)
        cuts.append(int(((left_out > 0) & torch.isfinite(kth.squeeze(-1))).sum()))
        return rows

    monkeypatch.setattr(module, "smallest_k", counting)
    return cuts


@pytest.mark.parametrize("kw", [
    dict(backend="single", mode="frontier", frontier_size=3),
    dict(backend="single", mode="pallas", pallas_frontier=True, frontier_size=3),
    dict(backend="batch", mode="pallas", pallas_frontier=True, frontier_size=3),
])
def test_ties_at_the_kth_priority_match_jax(monkeypatch, kw):
    """A unit-weight grid with more seeds than K: every round's priorities
    are small integers, so the top-K selections cut through ties; the
    counters and telemetry (which a wrong tie rule changes, though not the
    fixpoint) equal the reference's."""
    src, dst, _, n = grid_edges(7, 8, max_weight=1, seed=0)
    w = np.ones(src.shape[0], np.float32)
    rng = np.random.default_rng(7)
    seeds = rng.choice(n, 6, replace=False).astype(np.int32)
    jg, tg = both_graphs(src, dst, w, n)
    if kw["backend"] == "batch":
        seeds = np.stack([seeds, rng.choice(n, 6, replace=False).astype(np.int32)])
    cuts = _count_tie_cuts(monkeypatch, tv if kw["mode"] == "frontier" else tops)
    cfg = dict(ell_width=4, telemetry_rounds=64, **kw)
    out = SteinerSolver(SolverConfig(**cfg), device="cpu").prepare(tg).solve(seeds)
    jout = jsolver.SteinerSolver(jsolver.SolverConfig(**cfg)).prepare(jg).solve(seeds)
    assert sum(cuts) > 0, "no selection cut through a tie at the K-th priority"
    t, jt = out.telemetry, jout.telemetry
    assert (t.iterations, t.relaxations, t.messages) == (jt.iterations, jt.relaxations,
                                                         jt.messages)
    assert_same(jt.per_round, t.per_round)
    for f in ("dist", "lab", "pred"):
        assert_same(getattr(jout.raw.state, f), getattr(out.raw.state, f))
    assert_same(jout.total_distance, out.total_distance)
