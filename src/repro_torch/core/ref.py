"""Pure numpy / scipy oracles for the Steiner core.

A copy of ``repro.core.ref``: the sequential reference algorithms the paper
compares against, so that users of this package can check a tree without
the JAX package.

* :func:`voronoi_ref`        — Dijkstra-based Voronoi cells (exact distances)
* :func:`mehlhorn_ref`       — Mehlhorn's 2-approximation [17] end-to-end
* :func:`kmb_ref`            — Kou-Markowsky-Berman [14] via APSP
* :func:`dreyfus_wagner`     — exact Steiner minimal tree (tiny instances)

They are deliberately simple and slow; the solver's schedules are
validated against them edge-for-edge (tree validity + total distance).
The reference's two networkx calls are written out here (Kruskal in
networkx's edge order, a union-find for validity), so the answers are the
same and the module needs numpy and scipy only.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

INF = float("inf")

Edge = Tuple[int, int]


def _adj(n: int, edges: Sequence[Tuple[int, int, float]]) -> List[List[Tuple[int, float]]]:
    adj: List[List[Tuple[int, float]]] = [[] for _ in range(n)]
    for u, v, w in edges:
        adj[u].append((v, w))
        adj[v].append((u, w))
    return adj


def _min_csr(n: int, edges: Sequence[Tuple[int, int, float]]):
    """Symmetric CSR with parallel edges deduped to their min weight.

    (scipy's coo_matrix SUMS duplicates — wrong for multigraphs like RMAT.)
    """
    import scipy.sparse as sp

    best: Dict[Edge, float] = {}
    for u, v, w in edges:
        key = (min(u, v), max(u, v))
        if key[0] != key[1]:
            best[key] = min(w, best.get(key, INF))
    rows = [u for u, v in best] + [v for u, v in best]
    cols = [v for u, v in best] + [u for u, v in best]
    dat = list(best.values()) * 2
    return sp.coo_matrix((dat, (rows, cols)), shape=(n, n)).tocsr()


def voronoi_ref(
    n: int, edges: Sequence[Tuple[int, int, float]], seeds: Sequence[int]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Multi-source Dijkstra: returns (dist, lab, pred).

    ``lab[v]`` is the index into ``seeds`` of the owning cell (``len(seeds)``
    if unreachable). Ties between cells are broken toward the smaller seed
    index, then smaller predecessor id — the same deterministic tie-break the
    JAX implementation uses.
    """
    adj = _adj(n, edges)
    S = len(seeds)
    dist = np.full(n, INF)
    lab = np.full(n, S, np.int64)
    pred = np.arange(n, dtype=np.int64)
    pq: List[Tuple[float, int, int, int]] = []
    for i, s in enumerate(seeds):
        dist[s] = 0.0
        lab[s] = i
        pred[s] = s
        heapq.heappush(pq, (0.0, i, s, s))
    while pq:
        d, li, p, v = heapq.heappop(pq)
        if d > dist[v] or (d == dist[v] and (li, p) > (lab[v], pred[v])):
            continue
        for u, w in adj[v]:
            nd = d + w
            cand = (nd, li, v)
            cur = (dist[u], lab[u], pred[u])
            if cand < cur:
                dist[u], lab[u], pred[u] = nd, li, v
                heapq.heappush(pq, (nd, li, v, u))
    return dist, lab, pred


def distance_graph_ref(
    n: int,
    edges: Sequence[Tuple[int, int, float]],
    seeds: Sequence[int],
    dist: np.ndarray,
    lab: np.ndarray,
) -> Dict[Edge, Tuple[float, Edge]]:
    """Mehlhorn's distance graph G'1: min cross-cell bridge per seed pair.

    Returns ``{(si, sj): (d', (u, v))}`` with ``si < sj`` seed *indices* and
    (u, v) the bridging data-graph edge realizing d'.
    """
    S = len(seeds)
    out: Dict[Edge, Tuple[float, Edge]] = {}
    for u, v, w in edges:
        s, t = int(lab[u]), int(lab[v])
        if s == t or s >= S or t >= S:
            continue
        d = dist[u] + w + dist[v]
        a, b = (s, t) if s < t else (t, s)
        uu, vv = (u, v) if s < t else (v, u)
        key = (a, b)
        cand = (d, (uu, vv))
        if key not in out or cand < out[key]:
            out[key] = cand
    return out


def prim_ref(S: int, wmat: np.ndarray) -> List[Edge]:
    """Prim's MST on a dense (S, S) matrix with INF for non-edges."""
    in_tree = np.zeros(S, bool)
    best = wmat[0].copy()
    best_from = np.zeros(S, np.int64)
    in_tree[0] = True
    best[0] = INF
    out: List[Edge] = []
    for _ in range(S - 1):
        v = int(np.argmin(np.where(in_tree, INF, best)))
        if not np.isfinite(best[v]):
            break  # disconnected
        out.append((int(best_from[v]), v))
        in_tree[v] = True
        better = wmat[v] < best
        best = np.where(better, wmat[v], best)
        best_from = np.where(better, v, best_from)
        best[in_tree] = INF
    return out


def mehlhorn_ref(
    n: int, edges: Sequence[Tuple[int, int, float]], seeds: Sequence[int]
) -> Tuple[Set[Edge], float]:
    """End-to-end Mehlhorn 2-approximation. Returns (tree edge set, D)."""
    seeds = list(seeds)
    S = len(seeds)
    if S == 1:
        return set(), 0.0
    dist, lab, pred = voronoi_ref(n, edges, seeds)
    dg = distance_graph_ref(n, edges, seeds, dist, lab)
    wmat = np.full((S, S), INF)
    bridge: Dict[Edge, Edge] = {}
    for (a, b), (d, uv) in dg.items():
        wmat[a, b] = wmat[b, a] = d
        bridge[(a, b)] = uv
    mst = prim_ref(S, wmat)
    tree: Set[Edge] = set()
    total = 0.0
    ewt = {}
    for u, v, w in edges:
        key = (min(u, v), max(u, v))
        ewt[key] = min(w, ewt.get(key, INF))

    def walk(x: int) -> None:
        nonlocal total
        while pred[x] != x:
            e = (min(x, int(pred[x])), max(x, int(pred[x])))
            if e in tree:
                return
            tree.add(e)
            total += dist[x] - dist[int(pred[x])]
            x = int(pred[x])

    for a, b in mst:
        key = (min(a, b), max(a, b))
        u, v = bridge[key]
        e = (min(u, v), max(u, v))
        if e not in tree:
            tree.add(e)
            total += ewt[e]
        walk(u)
        walk(v)
    # Post-prune: repeatedly drop non-seed leaves (KMB step 5).
    tree, total = prune_non_seed_leaves(tree, ewt, set(seeds))
    return tree, total


def prune_non_seed_leaves(
    tree: Set[Edge], ewt: Dict[Edge, float], seeds: Set[int]
) -> Tuple[Set[Edge], float]:
    """Deletes degree-1 non-seed vertices until none remain."""
    tree = set(tree)
    changed = True
    while changed:
        changed = False
        deg: Dict[int, int] = {}
        for u, v in tree:
            deg[u] = deg.get(u, 0) + 1
            deg[v] = deg.get(v, 0) + 1
        for u, v in list(tree):
            for x in (u, v):
                if deg.get(x, 0) == 1 and x not in seeds:
                    tree.discard((u, v))
                    changed = True
                    break
    total = sum(ewt[e] for e in tree)
    return tree, total


def kmb_ref(
    n: int, edges: Sequence[Tuple[int, int, float]], seeds: Sequence[int]
) -> Tuple[Set[Edge], float]:
    """Kou-Markowsky-Berman via full APSP among seeds (scipy)."""
    import scipy.sparse.csgraph as csg

    seeds = list(seeds)
    S = len(seeds)
    if S == 1:
        return set(), 0.0
    m = _min_csr(n, edges)
    dmat, predm = csg.dijkstra(m, indices=seeds, return_predecessors=True)
    # G1: complete distance graph among seeds; MST of it.
    wmat = dmat[:, seeds]
    np.fill_diagonal(wmat, INF)
    mst = prim_ref(S, wmat)
    ewt = {}
    for u, v, w in edges:
        key = (min(u, v), max(u, v))
        ewt[key] = min(w, ewt.get(key, INF))
    # G3: union of shortest paths for MST edges.
    g3: Set[Edge] = set()
    for a, b in mst:
        x = seeds[b]
        while x != seeds[a] and predm[a, x] >= 0:
            p = int(predm[a, x])
            g3.add((min(x, p), max(x, p)))
            x = p
    # G4/G5: MST of G3, prune non-seed leaves.
    tree = _kruskal([(u, v, ewt[(u, v)]) for u, v in g3])
    return prune_non_seed_leaves(tree, ewt, set(seeds))


class _UnionFind:
    def __init__(self):
        self.parent: Dict[int, int] = {}

    def find(self, x: int) -> int:
        self.parent.setdefault(x, x)
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:  # path compression
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        self.parent[self.find(a)] = self.find(b)


def _kruskal(edges: Sequence[Tuple[int, int, float]]) -> Set[Edge]:
    """``networkx.minimum_spanning_tree`` of the graph built by adding
    ``edges`` in order: Kruskal over networkx's edge order (nodes in
    insertion order, each node's new neighbours in insertion order), sorted
    stably by weight, so ties pick the same edges."""
    adj: Dict[int, Dict[int, float]] = {}
    for u, v, w in edges:
        adj.setdefault(u, {})
        adj.setdefault(v, {})
        adj[u][v] = adj[v][u] = w
    order, seen = [], set()
    for u, nbrs in adj.items():
        for v, w in nbrs.items():
            if v not in seen:
                order.append((u, v, w))
        seen.add(u)
    uf = _UnionFind()
    tree: Set[Edge] = set()
    for u, v, _ in sorted(order, key=lambda t: t[2]):
        if uf.find(u) != uf.find(v):
            tree.add((min(u, v), max(u, v)))
            uf.union(u, v)
    return tree


def dreyfus_wagner(
    n: int, edges: Sequence[Tuple[int, int, float]], seeds: Sequence[int]
) -> float:
    """Exact Steiner minimal tree total distance (Dreyfus-Wagner DP).

    O(3^|S| n + 2^|S| n^2) — tests only (|S| <= 8, n <= ~64).
    """
    import scipy.sparse.csgraph as csg

    seeds = list(seeds)
    S = len(seeds)
    if S <= 1:
        return 0.0
    d = csg.dijkstra(_min_csr(n, edges))  # (n, n) APSP
    full = (1 << S) - 1
    # dp[mask][v] = min cost tree spanning seeds(mask) ∪ {v}
    dp = np.full((1 << S, n), INF)
    for i, s in enumerate(seeds):
        dp[1 << i] = d[s]
    for mask in range(1, full + 1):
        if mask & (mask - 1) == 0:
            continue
        # merge sub-masks at a common vertex
        sub = (mask - 1) & mask
        while sub:
            other = mask ^ sub
            if sub < other:  # each unordered pair once
                np.minimum(dp[mask], dp[sub] + dp[other], out=dp[mask])
            sub = (sub - 1) & mask
        # then relax through the graph (one Dijkstra-like closure via APSP)
        dp[mask] = np.min(dp[mask][None, :] + d, axis=1)
    return float(np.min(dp[full]))


def tree_is_valid(
    n: int,
    edges: Sequence[Tuple[int, int, float]],
    seeds: Sequence[int],
    tree: Set[Edge],
) -> bool:
    """Checks the output is a tree (acyclic, connected) containing all seeds."""
    eset = {(min(u, v), max(u, v)) for u, v, _ in edges}
    if not all(e in eset for e in tree):
        return False
    und = {(min(u, v), max(u, v)) for u, v in tree}
    nodes = {x for e in und for x in e} | set(seeds)
    uf = _UnionFind()
    for u, v in und:
        uf.union(u, v)
    n_comps = len({uf.find(x) for x in nodes})
    if len(und) != len(nodes) - n_comps:
        return False  # cycle
    root = uf.find(seeds[0])
    return all(uf.find(s) == root for s in seeds)
