"""The port's numpy oracles (``repro_torch.core.ref``) against the
reference's (``repro.core.ref``), exactly, on seeded graphs: Dijkstra's
Voronoi cells, the distance graph, Prim, Mehlhorn, leaf pruning, KMB (whose
networkx MST the port writes out), Dreyfus-Wagner and tree validity; and
``tree_edge_list`` of one solve in each package."""

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest

import repro.core.ref as jref
from repro.core import tree_edge_list as j_tree_edge_list
from repro.core.steiner import steiner_tree as j_steiner_tree
from _torch_parity import both_graphs, instance
from repro_torch.core import ref as tref
from repro_torch.core import tree_edge_list as t_tree_edge_list
from repro_torch.core.steiner import steiner_tree as t_steiner_tree

TRIALS = [0, 1, 2, 3, 4, 5]


def _edges(trial, n_seeds=5):
    src, dst, w, n, seeds = instance(trial, n_seeds)
    return n, list(zip(src.tolist(), dst.tolist(), w.tolist())), seeds.tolist()


def _tied(seed: int, n: int = 24, m: int = 70):
    """A multigraph with many equal weights (1 or 2), so that every
    tie-break (Dijkstra's, Prim's, Kruskal's) decides."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, m)
    v = rng.integers(0, n, m)
    w = rng.integers(1, 3, m).astype(float)
    edges = [(int(a), int(b), float(c)) for a, b, c in zip(u, v, w) if a != b]
    edges += [(i, i + 1, 2.0) for i in range(n - 1)]  # connected
    seeds = rng.choice(n, 5, replace=False).tolist()
    return n, edges, seeds


CASES = [("instance", t) for t in TRIALS] + [("tied", s) for s in range(4)]


def _case(kind, k):
    return _edges(k) if kind == "instance" else _tied(k)


@pytest.mark.parametrize("kind,k", CASES)
def test_voronoi_and_distance_graph_match(kind, k):
    n, edges, seeds = _case(kind, k)
    j, t = jref.voronoi_ref(n, edges, seeds), tref.voronoi_ref(n, edges, seeds)
    for a, b in zip(j, t):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    dist, lab, _ = j
    assert jref.distance_graph_ref(n, edges, seeds, dist, lab) == \
        tref.distance_graph_ref(n, edges, seeds, dist, lab)


@pytest.mark.parametrize("kind,k", CASES)
def test_trees_match(kind, k):
    n, edges, seeds = _case(kind, k)
    for name in ("mehlhorn_ref", "kmb_ref"):
        jt, jd = getattr(jref, name)(n, edges, seeds)
        tt, td = getattr(tref, name)(n, edges, seeds)
        assert jt == tt, name
        assert jd == td, name
        assert tref.tree_is_valid(n, edges, seeds, tt)
    assert jref.dreyfus_wagner(n, edges, seeds[:4]) == tref.dreyfus_wagner(n, edges, seeds[:4])


@pytest.mark.parametrize("seed", range(4))
def test_prim_and_pruning_match(seed):
    rng = np.random.default_rng(seed)
    S = 7
    wmat = rng.integers(1, 4, (S, S)).astype(float)
    wmat = np.minimum(wmat, wmat.T)
    wmat[rng.random((S, S)) < 0.3] = np.inf
    wmat = np.minimum(wmat, wmat.T)
    np.fill_diagonal(wmat, np.inf)
    assert jref.prim_ref(S, wmat) == tref.prim_ref(S, wmat)
    n, edges, seeds = _tied(seed)
    tree, _ = jref.mehlhorn_ref(n, edges, seeds)
    ewt = {}
    for u, v, w in edges:
        key = (min(u, v), max(u, v))
        ewt[key] = min(w, ewt.get(key, np.inf))
    extra = set(tree) | {e for e in list(ewt)[:6]}  # adds leaves and maybe cycles
    assert jref.prune_non_seed_leaves(extra, ewt, set(seeds[:2])) == \
        tref.prune_non_seed_leaves(extra, ewt, set(seeds[:2]))


@pytest.mark.parametrize("seed", range(6))
def test_kruskal_is_networkx_minimum_spanning_tree(seed):
    """The MST that ``kmb_ref`` takes of G3, written out: the same edges as
    networkx's, ties included (weights 1 or 2, many cycles)."""
    rng = np.random.default_rng(seed)
    pairs = {(int(min(a, b)), int(max(a, b))) for a, b in rng.integers(0, 20, (60, 2)) if a != b}
    edges = [(u, v, float(rng.integers(1, 3))) for u, v in sorted(pairs, key=lambda _: rng.random())]
    gx = nx.Graph()
    for u, v, w in edges:
        gx.add_edge(u, v, weight=w)
    want = {(min(u, v), max(u, v)) for u, v in nx.minimum_spanning_tree(gx).edges}
    assert tref._kruskal(edges) == want


@pytest.mark.parametrize("kind,k", CASES)
def test_tree_validity_matches(kind, k):
    """Valid trees, a cycle, a missing seed, a foreign edge and a
    non-normalized edge give the same verdict in both packages."""
    n, edges, seeds = _case(kind, k)
    tree, _ = jref.mehlhorn_ref(n, edges, seeds)
    eset = sorted({(min(u, v), max(u, v)) for u, v, _ in edges if u != v})
    variants = [tree, set(tree) | set(eset[:8]), set(list(tree)[1:]), set(tree) | {(0, n)},
                {(b, a) for a, b in tree}, set()]
    for t in variants:
        assert jref.tree_is_valid(n, edges, seeds, t) == tref.tree_is_valid(n, edges, seeds, t)
    assert tref.tree_is_valid(n, edges, seeds, tree)


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_tree_edge_list_matches_reference_solve(trial):
    src, dst, w, n, seeds = instance(trial, 6)
    jg, tg = both_graphs(src, dst, w, n)
    jr = j_steiner_tree(jg, jnp.asarray(seeds), mode="bucket")
    tr = t_steiner_tree(tg, seeds, mode="bucket")
    je, te = j_tree_edge_list(jr.state, jr.tree), t_tree_edge_list(tr.state, tr.tree)
    assert je == te
    edges = list(zip(src.tolist(), dst.tolist(), w.tolist()))
    assert te == tref.mehlhorn_ref(n, edges, seeds.tolist())[0]
