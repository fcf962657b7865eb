"""The plain reference (bench/reference/mehlhorn.py) against networkx's
shortest paths and a brute-force Steiner tree on tiny graphs."""

import itertools
import sys
from pathlib import Path

import networkx as nx
import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from perfkit import graphgen, manifest  # noqa: E402

torch.set_num_threads(1)
ref = manifest.load_module(BENCH / "reference" / "mehlhorn.py", "mehlhorn")


def tiny_graph(seed, n=9, p=0.45, max_w=9):
    rng = np.random.default_rng(seed)
    edges = [(u, v, int(rng.integers(1, max_w + 1)))
             for u, v in itertools.combinations(range(n), 2) if rng.random() < p]
    edges += [(i, i + 1, int(rng.integers(1, max_w + 1))) for i in range(n - 1)]  # connected
    return n, edges


def sym(edges):
    src = [u for u, v, _ in edges] + [v for u, v, _ in edges]
    dst = [v for u, v, _ in edges] + [u for u, v, _ in edges]
    w = [float(x) for _, _, x in edges] * 2
    return torch.tensor(src), torch.tensor(dst), torch.tensor(w)


def nx_graph(n, edges):
    g = nx.Graph()
    g.add_nodes_from(range(n))
    for u, v, w in edges:
        if not g.has_edge(u, v) or g[u][v]["weight"] > w:
            g.add_edge(u, v, weight=w)
    return g


def brute_steiner(g, seeds):
    """The least weight of a tree spanning ``seeds``: the least MST over
    every set of extra vertices that keeps the induced graph connected."""
    others = [v for v in g if v not in seeds]
    best = np.inf
    for k in range(len(others) + 1):
        for extra in itertools.combinations(others, k):
            h = g.subgraph(list(seeds) + list(extra))
            if nx.is_connected(h):
                best = min(best, nx.minimum_spanning_tree(h).size(weight="weight"))
    return best


@pytest.mark.parametrize("seed", range(6))
def test_voronoi_matches_networkx(seed):
    n, edges = tiny_graph(seed)
    g = nx_graph(n, edges)
    rng = np.random.default_rng(100 + seed)
    seeds = rng.choice(n, size=3, replace=False)
    out = ref.solve(*sym(edges), n, seeds)
    d = [nx.single_source_dijkstra_path_length(g, int(s)) for s in seeds]
    for v in range(n):
        dist = min(di[v] for di in d)
        assert out["dist"][v] == dist
        # the least seed index among the nearest
        assert out["lab"][v] == min(i for i, di in enumerate(d) if di[v] == dist)
        p = out["pred"][v]
        if v in seeds:
            assert p == v
        else:  # the least neighbour on a shortest path from that seed
            cands = [u for u in g[v] if out["dist"][u] + g[u][v]["weight"] == dist
                     and out["lab"][u] == out["lab"][v]]
            assert p == min(cands)


@pytest.mark.parametrize("seed", range(6))
def test_tree_is_a_two_approximation(seed):
    n, edges = tiny_graph(seed)
    g = nx_graph(n, edges)
    seeds = np.random.default_rng(200 + seed).choice(n, size=4, replace=False)
    out = ref.solve(*sym(edges), n, seeds)
    tree = nx.Graph()
    for v in np.nonzero(out["path_edge"])[0]:
        tree.add_edge(int(out["pred"][v]), int(v))
    for i in np.nonzero(out["bridge_valid"])[0]:
        tree.add_edge(int(out["bridge_u"][i]), int(out["bridge_v"][i]))
    assert nx.is_tree(tree) and set(int(s) for s in seeds) <= set(tree)
    assert tree.number_of_edges() == out["num_edges"]
    total = sum(g[u][v]["weight"] for u, v in tree.edges)
    assert total == out["total_distance"]
    opt = brute_steiner(g, [int(s) for s in seeds])
    assert opt <= total <= 2 * (1 - 1 / len(seeds)) * opt + 1e-9


def test_bfloat16_breaks_exactness():
    """The control's precision: distance-graph sums and totals past 256 no
    longer fit bfloat16's 8 significant bits, so answers drift."""
    edges = graphgen.rmat({"generator": "rmat", "scale": 11, "edge_factor": 8, "a": 0.57,
                           "b": 0.19, "c": 0.19, "max_weight": 100}, 7, "cpu")
    drift = 0
    for s in range(4):
        seeds = np.random.default_rng(s).choice(edges.n, size=64, replace=False)
        f32 = ref.solve(*edges.symmetric(), edges.n, seeds)
        bf16 = ref.solve(*edges.symmetric(), edges.n, seeds, precision="bfloat16")
        assert f32["total_distance"] > 256
        drift += int(f32["total_distance"] != bf16["total_distance"])
        drift += int((f32["dmat"] != bf16["dmat"]).sum())
    assert drift > 0


def test_graph_generator_is_seeded():
    spec = {"generator": "rmat", "scale": 8, "edge_factor": 8, "a": 0.57, "b": 0.19,
            "c": 0.19, "max_weight": 100}
    a, b, c = (graphgen.rmat(spec, s, "cpu") for s in (5, 5, 6))
    assert torch.equal(a.src, b.src) and torch.equal(a.w, b.w)
    assert not torch.equal(a.src, c.src)
    assert a.n == 256 and bool((a.src != a.dst).all())
    assert bool(((a.w >= 1) & (a.w <= 100) & (a.w == a.w.round())).all())
    # the connecting path makes one component
    g = nx.Graph()
    g.add_edges_from(zip(a.src.tolist(), a.dst.tolist()))
    assert nx.is_connected(g) and g.number_of_nodes() == 256
