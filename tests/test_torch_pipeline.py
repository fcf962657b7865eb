"""The pipeline after the Voronoi fixpoint (distance graph, Prim, bridge
pruning, pointer walk) of ``repro_torch`` against ``repro``, and the whole
tail against the Mehlhorn oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.distance_graph as jdg
import repro.core.mst as jmst
import repro.core.steiner as jsteiner
import repro.core.tree as jtree
import repro.kernels.minplus.ops as jops
from repro.core.graph import to_ell as jto_ell
from repro.core.ref import mehlhorn_ref
from _torch_parity import assert_same, both_graphs, host, instance
from repro_torch import convert
from repro_torch.core import distance_graph as tdg
from repro_torch.core import mst as tmst
from repro_torch.core import steiner as tsteiner
from repro_torch.core import tree as ttree
from repro_torch.core.graph import to_ell as tto_ell
from repro_torch.kernels.minplus import ops as tops


def _converged(trial, n_seeds=5):
    """Both packages' graphs and the JAX fixpoint, handed to the port as
    numpy so each stage is compared on identical inputs."""
    src, dst, w, n, seeds = instance(trial, n_seeds)
    jg, tg = both_graphs(src, dst, w, n)
    jst, jstats = jops.voronoi_cells_pallas(
        jto_ell(jg, 4), jnp.asarray(seeds), block_rows=16, interpret=True,
        telemetry_rounds=4,
    )
    tst = convert.state_from_numpy(host(jst.dist), host(jst.lab), host(jst.pred),
                                   device="cpu")
    return (src, dst, w, n, seeds), jg, tg, jst, jstats, tst


@pytest.mark.parametrize("trial", [0, 1, 2, 3])
def test_distance_graph_matches(trial):
    (_, _, _, _, seeds), jg, tg, jst, _, tst = _converged(trial)
    S = len(seeds)
    for a, b in zip(jdg.distance_graph(jg, jst, S), tdg.distance_graph(tg, tst, S)):
        assert_same(a, b)


def test_local_pair_tables_ignores_non_cross_edges():
    """Intra-cell, unreached and +inf-weight edges never reach a table."""
    S = 3
    lab_src = np.array([0, 1, 1, 3, 0, 2], np.int32)
    lab_dst = np.array([1, 1, 2, 0, 2, 0], np.int32)
    w = np.array([1, 2, 3, 4, np.inf, 5], np.float32)
    d_src = np.array([0, 1, 2, 3, 4, 5], np.float32)
    d_dst = np.array([1, 1, 1, 1, 1, 1], np.float32)
    src = np.arange(6, dtype=np.int32)
    dst = src + 10
    args = (src, dst, w, d_src, d_dst, lab_src, lab_dst)
    j = jdg.local_pair_tables(*map(jnp.asarray, args), S)
    t = tdg.local_pair_tables(*map(torch.from_numpy, args), S)
    for a, b in zip(j, t):
        assert_same(a, b)


def _random_wmat(S, seed):
    rng = np.random.default_rng(seed)
    m = rng.integers(1, 6, (S, S)).astype(np.float32)  # many ties
    m[rng.random((S, S)) < 0.5] = np.inf
    m = np.minimum(m, m.T)
    np.fill_diagonal(m, np.inf)
    return m


@pytest.mark.parametrize("S,seed", [(2, 0), (7, 1), (16, 2), (33, 3)])
def test_prim_dense_matches(S, seed):
    m = _random_wmat(S, seed)
    assert_same(jmst.prim_dense(jnp.asarray(m)), tmst.prim_dense(torch.from_numpy(m)))


def test_prim_dense_disconnected_keeps_self_parents():
    m = np.full((4, 4), np.inf, np.float32)
    m[0, 1] = m[1, 0] = 2.0
    out = tmst.prim_dense(torch.from_numpy(m))
    assert_same(jmst.prim_dense(jnp.asarray(m)), out)
    assert host(out).tolist() == [0, 0, 2, 3]


def test_mst_pairs_matches():
    parent = np.array([0, 0, 1, 1, 3, 5], np.int32)
    assert_same(jmst.mst_pairs(jnp.asarray(parent), 6),
                tmst.mst_pairs(torch.from_numpy(parent), 6))


@pytest.mark.parametrize("trial", [0, 1, 2, 4])
def test_extract_tree_matches(trial):
    (_, _, _, n, seeds), jg, tg, jst, _, tst = _converged(trial)
    S = len(seeds)
    jd, ju, jv = jdg.distance_graph(jg, jst, S)
    jparent = jmst.prim_dense(jnp.minimum(jd.reshape(S, S), jd.reshape(S, S).T)
                              + jnp.where(jnp.eye(S, dtype=bool), jnp.inf, 0.0))
    t_args = [torch.tensor(host(x)) for x in (jd, ju, jv, jparent)]
    jt = jtree.extract_tree(n, jst, jd, ju, jv, jparent, S)
    tt = ttree.extract_tree(n, tst, *t_args, S)
    for f in ("in_tree_vertex", "path_edge", "bridge_u", "bridge_v", "bridge_w",
              "bridge_valid", "total_distance", "num_edges"):
        assert_same(getattr(jt, f), getattr(tt, f))


def test_mark_paths_matches():
    pred = np.array([0, 0, 1, 2, 3, 5, 5, 6, 7, 8], np.int32)
    dist = np.arange(10, dtype=np.float32)
    endpoints = np.zeros(10, bool)
    endpoints[[4, 8]] = True
    jst = jsteiner.vmod.VoronoiState(jnp.asarray(dist), jnp.zeros(10, jnp.int32),
                                     jnp.asarray(pred))
    tst = convert.state_from_numpy(dist, np.zeros(10, np.int32), pred, device="cpu")
    out = ttree.mark_paths(tst, torch.from_numpy(endpoints))
    assert_same(jtree.mark_paths(jst, jnp.asarray(endpoints)), out)
    assert host(out).tolist() == [True] * 9 + [False]


@pytest.mark.parametrize("trial", [0, 1, 2, 3, 5])
def test_finish_pipeline_matches_jax_and_mehlhorn(trial):
    (src, dst, w, n, seeds), jg, tg, jst, jstats, tst = _converged(trial)
    S = len(seeds)
    jr = jsteiner.finish_pipeline(jg, jst, jstats, S)
    tr = tsteiner.finish_pipeline(tg, tst, None, S)
    assert_same(jr.parent, tr.parent)
    assert_same(jr.dmat, tr.dmat)
    for f in ("in_tree_vertex", "path_edge", "bridge_u", "bridge_v", "bridge_w",
              "bridge_valid", "total_distance", "num_edges"):
        assert_same(getattr(jr.tree, f), getattr(tr.tree, f))
    edges = ttree.tree_edge_sets(tr.state, tr.tree)[0]
    assert edges == jtree.tree_edge_sets(jr.state, jr.tree)[0]
    ref_edges, ref_total = mehlhorn_ref(n, list(zip(src.tolist(), dst.tolist(),
                                                    w.tolist())), seeds.tolist())
    assert float(tr.tree.total_distance) >= ref_total - 1e-6
    assert ref_edges <= edges


def test_whole_tail_from_port_fixpoint():
    """The port's own fixpoint feeds its own tail to the JAX answer."""
    (src, dst, w, n, seeds), jg, tg, jst, jstats, _ = _converged(1, n_seeds=8)
    tst, tstats = tops.voronoi_cells_pallas(tto_ell(tg, 4), torch.from_numpy(seeds))
    tr = tsteiner.finish_pipeline(tg, tst, tstats, len(seeds))
    jr = jsteiner.finish_pipeline(jg, jst, jstats, len(seeds))
    assert_same(jr.tree.total_distance, tr.tree.total_distance)
    assert ttree.tree_edge_sets(tr.state, tr.tree) == jtree.tree_edge_sets(jr.state, jr.tree)


def test_boruvka_not_ported():
    """Borůvka is ported: the whole tail with it equals the reference's
    (MST parent and tree), and an unknown algorithm still raises."""
    (_, _, _, _, seeds), jg, tg, jst, jstats, tst = _converged(0)
    tr = tsteiner.finish_pipeline(tg, tst, None, len(seeds), mst_algo="boruvka")
    jr = jsteiner.finish_pipeline(jg, jst, jstats, len(seeds), mst_algo="boruvka")
    assert_same(jr.parent, tr.parent)
    assert_same(jr.tree.total_distance, tr.tree.total_distance)
    assert_same(jr.tree.num_edges, tr.tree.num_edges)
    with pytest.raises(ValueError, match="unknown mst_algo"):
        tsteiner.finish_pipeline(tg, tst, None, len(seeds), mst_algo="kruskal")


def _pair_table(kind, S, rng):
    """A symmetric (S, S) pair weight table with +inf diagonal: real-valued,
    tie-heavy (integer weights in 1..3) or disconnected (most entries +inf)."""
    if kind == "random":
        W = rng.random((S, S)).astype(np.float32)
    else:
        W = rng.integers(1, 4, (S, S)).astype(np.float32)
        if kind == "disconnected":
            W[rng.random((S, S)) < 0.7] = np.inf
    W = np.minimum(W, W.T)
    np.fill_diagonal(W, np.inf)
    return W


@pytest.mark.parametrize("kind", ["random", "ties", "disconnected"])
@pytest.mark.parametrize("S", [1, 2, 7, 24])
def test_boruvka_dense_matches_reference(kind, S):
    rng = np.random.default_rng(S * 7 + len(kind))
    for _ in range(3):
        W = _pair_table(kind, S, rng)
        want = jmst.boruvka_dense(jnp.asarray(W))
        got = tmst.boruvka_dense(torch.from_numpy(W))
        assert_same(want, got)
        # a spanning tree of the same weight as Prim's (ties may differ)
        if np.isfinite(W[~np.eye(S, dtype=bool)]).all() and S > 1:
            p = tmst.prim_dense(torch.from_numpy(W)).numpy()
            b = got.numpy()
            kids = np.arange(1, S)
            assert W[kids, p[kids]].sum() == W[kids, b[kids]].sum()


@pytest.mark.parametrize("S", [1, 5, 16])
def test_root_parents_matches_reference(S):
    rng = np.random.default_rng(S)
    for density in (0.1, 0.4):
        adj = rng.random((S, S)) < density
        adj = adj | adj.T
        assert_same(jmst._root_parents(jnp.asarray(adj)), tmst._root_parents(torch.from_numpy(adj)))


@pytest.mark.parametrize("kw", [dict(backend="single", mode="pallas"),
                                dict(backend="single", mode="bucket"),
                                dict(backend="batch", mode="pallas")],
                         ids=["single-pallas", "single-bucket", "batch-pallas"])
def test_solver_boruvka_matches_reference(kw):
    import repro.solver as jsolver
    from repro_torch.solver import SolverConfig, SteinerSolver

    src, dst, w, n, seeds = instance(4, n_seeds=9)
    jg, tg = both_graphs(src, dst, w, n)
    q = seeds if kw["backend"] == "single" else np.stack([seeds, seeds[::-1]])
    cfg = dict(mst_algo="boruvka", batch_size=2, **kw)
    jo = jsolver.SteinerSolver(jsolver.SolverConfig(**cfg)).prepare(jg).solve(q)
    to = SteinerSolver(SolverConfig(**cfg), device="cpu").prepare(tg).solve(q)
    assert_same(jo.raw.parent, to.raw.parent)
    assert np.array_equal(np.asarray(jo.total_distance), np.asarray(to.total_distance))
    assert np.array_equal(np.asarray(jo.num_edges), np.asarray(to.num_edges))
