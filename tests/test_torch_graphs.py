"""The numpy graph utilities of ``repro_torch.data.graphs`` against
``repro.data.graphs``: Erdős–Rényi and grid graphs, BFS levels, the four
seed-selection strategies and the CSR builder, array for array."""

import numpy as np
import pytest

import repro.data.graphs as jdata
from repro_torch.data import graphs as tdata


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,p,connect,seed", [(30, 0.12, True, 0), (64, 0.05, False, 3),
                                              (2, 1.0, True, 9)])
def test_er_edges_identical(n, p, connect, seed):
    a = jdata.er_edges(n, p, max_weight=9, seed=seed, connect=connect)
    b = tdata.er_edges(n, p, max_weight=9, seed=seed, connect=connect)
    assert a[3] == b[3]
    for x, y in zip(a[:3], b[:3]):
        _same(x, y)


@pytest.mark.parametrize("rows,cols,seed", [(6, 7, 0), (1, 5, 2), (5, 1, 3), (1, 1, 0)])
def test_grid_edges_identical(rows, cols, seed):
    a = jdata.grid_edges(rows, cols, max_weight=8, seed=seed)
    b = tdata.grid_edges(rows, cols, max_weight=8, seed=seed)
    assert a[3] == b[3]
    for x, y in zip(a[:3], b[:3]):
        _same(x, y)


def _graph(kind):
    if kind == "rmat":
        return jdata.rmat_edges(8, 4, seed=2)
    if kind == "er":  # two components: unreached vertices at every BFS
        return jdata.er_edges(50, 0.03, seed=1, connect=False)
    return jdata.grid_edges(7, 9, seed=4)


@pytest.mark.parametrize("kind", ["rmat", "er", "grid"])
def test_bfs_levels_identical(kind):
    src, dst, _, n = _graph(kind)
    for root in (0, n // 2, n - 1):
        _same(jdata._bfs_levels(n, src, dst, root), tdata._bfs_levels(n, src, dst, root))


@pytest.mark.parametrize("strategy", ["bfs_level", "uniform", "eccentric", "proximate"])
@pytest.mark.parametrize("kind", ["rmat", "grid"])
def test_select_seeds_identical(strategy, kind):
    src, dst, _, n = _graph(kind)
    for k, seed in ((1, 0), (12, 5), (40, 11)):
        _same(jdata.select_seeds(n, src, dst, k, strategy=strategy, seed=seed),
              tdata.select_seeds(n, src, dst, k, strategy=strategy, seed=seed))


def test_select_seeds_default_is_bfs_level():
    src, dst, _, n = _graph("rmat")
    _same(tdata.select_seeds(n, src, dst, 16, seed=3),
          jdata.select_seeds(n, src, dst, 16, strategy="bfs_level", seed=3))


@pytest.mark.parametrize("kind", ["rmat", "er", "grid"])
def test_build_csr_identical(kind):
    src, dst, _, n = _graph(kind)
    for x, y in zip(jdata.build_csr(n, src, dst), tdata.build_csr(n, src, dst)):
        _same(x, y)


@pytest.mark.parametrize("n,m,seed", [(1, 5, 0), (7, 1000, 1), (1 << 18, 50_000, 2),
                                      (1 << 40, 3000, 3), (5, 0, 4)])
def test_stable_order_is_the_stable_argsort(n, m, seed):
    """The CSR builder's sort: one sort of (key << b | position), or the
    stable argsort where key and position do not fit 63 bits (n = 2^40
    with 12 position bits)."""
    from repro_torch.graphstore.ingest import _stable_order

    keys = np.random.default_rng(seed).integers(0, min(n, 1 << 30) if n > 6 else n, m)
    keys = keys.astype(np.int64 if n > 1 << 31 else np.int32)
    order, sorted_keys = _stable_order(keys, n)
    want = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(order, want)
    _same(sorted_keys, keys[want])
