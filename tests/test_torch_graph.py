"""Graph containers, data generators and conversion of ``repro_torch``
against ``repro`` (bit-equal)."""

import gc

import numpy as np
import pytest
import torch

import repro.core.graph as jgraph
import repro.data.graphs as jdata
from _torch_parity import assert_same, both_graphs, host, instance
from repro_torch import convert
from repro_torch.core import graph as tgraph
from repro_torch.data import graphs as tdata


@pytest.mark.parametrize("scale,ef,seed", [(6, 4, 0), (10, 8, 0), (9, 16, 3)])
def test_rmat_edges_identical(scale, ef, seed):
    a = jdata.rmat_edges(scale, ef, max_weight=100, seed=seed)
    b = tdata.rmat_edges(scale, ef, max_weight=100, seed=seed)
    assert a[3] == b[3]
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n,k,seed", [(1024, 16, 1000), (64, 64, 7), (4096, 1024, 1)])
def test_uniform_seeds_identical(n, k, seed):
    src = dst = np.zeros(1, np.int32)
    a = jdata.select_seeds(n, src, dst, k, strategy="uniform", seed=seed)
    b = tdata.select_seeds(n, src, dst, k, strategy="uniform", seed=seed)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_other_seed_strategies_not_ported():
    """Every strategy is ported now: each draws the reference's seeds, and
    an unknown strategy raises as there."""
    src, dst, _, n = jdata.rmat_edges(7, 4, seed=5)
    for strategy in ("bfs_level", "eccentric", "proximate"):
        a = jdata.select_seeds(n, src, dst, 9, strategy=strategy, seed=2)
        b = tdata.select_seeds(n, src, dst, 9, strategy=strategy, seed=2)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown strategy"):
        tdata.select_seeds(16, np.zeros(1), np.zeros(1), 4, strategy="central")


def test_rmat_source_regroup_invariant():
    """The graph is a function of the block stream, not of the chunking."""
    a = list(tdata.RmatEdgeSource(7, 4, seed=2, chunk_edges=97))
    b = list(tdata.RmatEdgeSource(7, 4, seed=2))
    for i in range(3):
        np.testing.assert_array_equal(
            np.concatenate([c[i] for c in a]), np.concatenate([c[i] for c in b])
        )


@pytest.mark.parametrize("pad_to", [1, 8, 13])
@pytest.mark.parametrize("symmetrize", [True, False])
def test_from_edges_matches(pad_to, symmetrize):
    src, dst, w, n, _ = instance(1)
    jg = jgraph.from_edges(src, dst, w, n, pad_to=pad_to, symmetrize=symmetrize)
    tg = tgraph.from_edges(src, dst, w, n, pad_to=pad_to, symmetrize=symmetrize,
                           device="cpu")
    assert tg.n == jg.n and tg.num_edges == jg.num_edges
    for f in ("src", "dst", "w"):
        assert_same(getattr(jg, f), getattr(tg, f))


@pytest.mark.parametrize("pad_to", [1, 8, 13])
def test_degree_and_pad_weight_match(pad_to):
    """Out-degrees with the padding edges (+inf, at vertex 0) left out, and
    the padding weight itself."""
    src, dst, w, n, _ = instance(1)
    jg, tg = both_graphs(src, dst, w, n, pad_to=pad_to)
    want = jg.degree()
    got = tg.degree()
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert_same(want, got)
    assert tgraph.PAD_WEIGHT == float(jgraph.PAD_WEIGHT) == float("inf")
    pad = np.isinf(host(tg.w))
    assert pad.sum() == (-len(src) * 2) % pad_to and np.all(host(tg.w)[pad] == tgraph.PAD_WEIGHT)


def _star_plus_rmat():
    """An RMAT graph plus a hub of degree 300, so k=4 splits hubs into many
    rows and k=32 still splits the hub."""
    src, dst, w, n = jdata.rmat_edges(8, 8, max_weight=50, seed=5)
    hub = np.full(300, 3, np.int32)
    leaves = np.arange(10, 310, dtype=np.int32) % n
    keep = leaves != 3
    return (
        np.concatenate([src, hub[keep]]),
        np.concatenate([dst, leaves[keep]]),
        np.concatenate([w, np.arange(1, 301, dtype=np.float32)[keep] / 7]),
        n,
    )


_GRAPHS = {
    "rmat10": lambda: jdata.rmat_edges(10, 8, max_weight=100, seed=0)[:4],
    "hub": _star_plus_rmat,
    "er": lambda: instance(0)[:4],
    "grid": lambda: instance(2)[:4],
}


@pytest.mark.parametrize("pad_rows_to", [1, 7, 256])
@pytest.mark.parametrize("k", [4, 8, 32])
@pytest.mark.parametrize("name", sorted(_GRAPHS))
def test_to_ell_bit_equal(name, k, pad_rows_to):
    src, dst, w, n = _GRAPHS[name]()
    jg, tg = both_graphs(src, dst, w, n, pad_to=8)
    je = jgraph.to_ell(jg, k, pad_rows_to=pad_rows_to)
    te = tgraph.to_ell(tg, k, pad_rows_to=pad_rows_to)
    assert te.n == je.n
    for f in ("nbr", "wgt", "row2v"):
        assert_same(getattr(je, f), getattr(te, f))


def test_to_ell_isolated_vertices():
    """Vertices with no edges still own one (all-padding) row."""
    src = np.array([0, 5], np.int32)
    dst = np.array([1, 6], np.int32)
    w = np.array([2.0, 3.0], np.float32)
    jg, tg = both_graphs(src, dst, w, 9, pad_to=4)
    je, te = jgraph.to_ell(jg, 2), tgraph.to_ell(tg, 2)
    for f in ("nbr", "wgt", "row2v"):
        assert_same(getattr(je, f), getattr(te, f))


def test_ell_view_cached_keys_on_version_token():
    src, dst, w, n, _ = instance(1)
    g = tgraph.from_edges(src, dst, w, n, device="cpu")
    e1 = tgraph.ell_view_cached(g, 8)
    assert tgraph.ell_view_cached(g, 8) is e1
    assert tgraph.ell_view_cached(g, 4) is not e1
    tgraph.bump_graph_version(g)
    e2 = tgraph.ell_view_cached(g, 8)
    assert e2 is not e1
    assert_same(e1.nbr, e2.nbr)
    # a new graph never hits a dead graph's entry
    tok = tgraph.graph_token(g)
    del g
    gc.collect()
    g2 = tgraph.from_edges(src, dst, w, n, device="cpu")
    assert tgraph.graph_token(g2) != tok
    assert all(key[0] != tok for key in tgraph._ell_memo)


def test_graph_to_same_device_is_identity():
    src, dst, w, n, _ = instance(0)
    g = tgraph.from_edges(src, dst, w, n, device="cpu")
    assert g.to("cpu") is g
    assert g.device == torch.device("cpu")


def test_convert_from_jax_arrays():
    src, dst, w, n, _ = instance(2)
    jg = jgraph.from_edges(src, dst, w, n, pad_to=8)
    je = jgraph.to_ell(jg, 4)
    tg = convert.graph_from_numpy(host(jg.src), host(jg.dst), host(jg.w), jg.n,
                                  device="cpu")
    te = convert.ell_from_numpy(host(je.nbr), host(je.wgt), host(je.row2v), je.n,
                                device="cpu")
    for f in ("src", "dst", "w"):
        assert_same(getattr(jg, f), getattr(tg, f))
    for f in ("nbr", "wgt", "row2v"):
        assert_same(getattr(je, f), getattr(te, f))
    assert_same(getattr(tgraph.to_ell(tg, 4), "nbr"), te.nbr)
    dist = np.where(np.arange(n) % 3 == 0, np.inf, np.arange(n) / 3).astype(np.float32)
    lab = (np.arange(n) % 5).astype(np.int32)
    st = convert.state_from_numpy(dist, lab, np.arange(n, dtype=np.int32), device="cpu")
    assert_same(dist, st.dist)
    assert_same(lab, st.lab)
    assert st.pred.dtype == torch.int32
