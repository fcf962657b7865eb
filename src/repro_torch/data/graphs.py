"""Host-side graph generators, seed selection and neighbour sampling,
numpy-identical to ``repro``.

A copy of ``repro.data.graphs``: ``rmat_edges(s, f, seed=x)`` here and
there are the same graph, edge for edge (the chunked generator lives in
:mod:`repro_torch.graphstore.ingest`), and so are the Erdős–Rényi and grid
graphs, the paper's four seed-selection strategies (§V, §V-E):
BFS-level, uniform-random, eccentric (k-BFS) and proximate, and
GraphSAGE's fanout sampling over the symmetrized CSR.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.graphstore.ingest import (
    ArraySource,
    RmatEdgeSource,
    csr_from_chunks,
)


def rmat_edges(
    scale: int,
    edge_factor: int,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    max_weight: int = 100,
    seed: int = 0,
    connect: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """RMAT scale-free weighted graph, fully materialized on the host.

    Returns (src, dst, w, n) with n = 2**scale, ~edge_factor * n undirected
    edges (one direction each) and integer weights uniform in
    [1, max_weight]: the concatenation of :class:`RmatEdgeSource`'s chunks.
    """
    source = RmatEdgeSource(
        scale, edge_factor, a=a, b=b, c=c, max_weight=max_weight,
        seed=seed, connect=connect,
    )
    chunks = list(source)
    src = np.concatenate([ch[0] for ch in chunks])
    dst = np.concatenate([ch[1] for ch in chunks])
    w = np.concatenate([ch[2] for ch in chunks])
    return src, dst, w, source.n


def er_edges(
    n: int, p: float, *, max_weight: int = 100, seed: int = 0, connect: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Erdős–Rényi G(n, p) with integer weights (test-scale)."""
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, k=1)
    keep = rng.random(iu[0].shape[0]) < p
    src, dst = iu[0][keep].astype(np.int32), iu[1][keep].astype(np.int32)
    if connect:
        path = rng.permutation(n).astype(np.int32)
        src = np.concatenate([src, path[:-1]])
        dst = np.concatenate([dst, path[1:]])
    w = rng.integers(1, max_weight + 1, size=src.shape[0]).astype(np.float32)
    return src, dst, w, n


def grid_edges(
    rows: int, cols: int, *, max_weight: int = 10, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """2D grid graph (deterministic structure, random weights)."""
    rng = np.random.default_rng(seed)
    n = rows * cols
    src, dst = [], []
    for r in range(rows):
        for c in range(cols):
            v = r * cols + c
            if c + 1 < cols:
                src.append(v)
                dst.append(v + 1)
            if r + 1 < rows:
                src.append(v)
                dst.append(v + cols)
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    w = rng.integers(1, max_weight + 1, size=src.shape[0]).astype(np.float32)
    return src, dst, w, n


# ----------------------------------------------------------------------------
# Seed selection (paper §V "Seed Vertex Selection" and §V-E alternatives)
# ----------------------------------------------------------------------------


def _bfs_levels(n: int, src: np.ndarray, dst: np.ndarray, root: int) -> np.ndarray:
    """(n,) f64 hop distance of every vertex from ``root`` (+inf when
    unreached) over the symmetrized edge list."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg

    m = sp.coo_matrix(
        (np.ones(2 * src.shape[0]), (np.r_[src, dst], np.r_[dst, src])), shape=(n, n)
    ).tocsr()
    return csg.shortest_path(m, unweighted=True, indices=root)


def select_seeds(
    n: int,
    src: np.ndarray,
    dst: np.ndarray,
    k: int,
    *,
    strategy: str = "bfs_level",
    seed: int = 0,
) -> np.ndarray:
    """The paper's seed selection strategies (the reference's draws).

    bfs_level: random vertices stratified by BFS level frequency (the
      paper's default: avoids directly connected seeds dominating).
    uniform:   uniform random.
    eccentric: k-BFS heuristic, each pick the vertex maximizing the sum of
      BFS distances to the previous picks.
    proximate: the same, minimizing (seeds close together).
    """
    rng = np.random.default_rng(seed)
    if strategy == "uniform":
        return rng.choice(n, size=k, replace=False).astype(np.int32)
    if strategy == "bfs_level":
        root = int(rng.integers(n))
        d = _bfs_levels(n, src, dst, root)
        d = np.where(np.isfinite(d), d, -1).astype(np.int64)
        picks = []
        levels, counts = np.unique(d[d >= 0], return_counts=True)
        # sample per level proportionally to its population
        quota = np.maximum(1, (counts / counts.sum() * k)).astype(np.int64)
        for lvl, q in zip(levels, quota):
            pool = np.nonzero(d == lvl)[0]
            take = min(len(pool), int(q))
            picks.append(rng.choice(pool, size=take, replace=False))
        flat = np.concatenate(picks)
        rng.shuffle(flat)
        if len(flat) < k:  # top up uniformly
            extra = np.setdiff1d(np.nonzero(d >= 0)[0], flat)
            flat = np.concatenate([flat, rng.choice(extra, k - len(flat), replace=False)])
        return flat[:k].astype(np.int32)
    if strategy in ("eccentric", "proximate"):
        root = int(rng.integers(n))
        picks = [root]
        total = _bfs_levels(n, src, dst, root)
        total = np.where(np.isfinite(total), total, 0.0)
        for _ in range(k - 1):
            masked = total.copy()
            masked[picks] = -np.inf if strategy == "eccentric" else np.inf
            nxt = int(np.argmax(masked) if strategy == "eccentric" else np.argmin(masked))
            picks.append(nxt)
            d = _bfs_levels(n, src, dst, nxt)
            total = total + np.where(np.isfinite(d), d, 0.0)
        return np.asarray(picks, np.int32)
    raise ValueError(f"unknown strategy {strategy!r}")


def build_csr(n: int, src: np.ndarray, dst: np.ndarray):
    """(indptr, indices) of the symmetrized adjacency, through the one CSR
    builder (:func:`repro_torch.graphstore.ingest.csr_from_chunks`) with the
    whole edge list as one chunk: within a row, all forward edges in input
    order, then all reverse edges."""
    source = ArraySource(src, dst, None, n, chunk_edges=max(1, len(src)))
    indptr, indices, _ = csr_from_chunks(n, source, symmetrize=True)
    return indptr, indices


def sample_neighbors(
    indptr: np.ndarray,
    indices: np.ndarray,
    frontier: np.ndarray,
    fanout: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Uniform with-replacement fanout sampling → (len(frontier), fanout).

    Vertices with zero degree sample themselves (self-loop), matching the
    padded fixed-shape contract of the GNN step.  Row i's offsets are drawn
    in [0, deg(frontier[i])), row after row from ``rng``.

    The reference's copy passes the (F,) degrees as the bound of an
    (F, fanout) draw, which numpy broadcasts along the last axis: it raises
    unless F == 1 (or F == fanout, where column j takes vertex j's degree),
    and a zero-degree vertex at the end of the CSR indexes past it.  Here
    each row takes its own degree (``[:, None]``) and the gather stays in
    bounds; on one-vertex frontiers the two agree bit for bit, and a
    frontier of F vertices equals F one-vertex calls in turn.
    """
    frontier = np.asarray(frontier)
    deg = (indptr[frontier + 1] - indptr[frontier]).astype(np.int64)
    offs = rng.integers(0, np.maximum(deg, 1)[:, None], size=(len(frontier), fanout))
    if len(indices) == 0:
        return np.repeat(frontier[:, None], fanout, 1).astype(np.int32)
    base = indptr[frontier][:, None]
    pos = np.minimum(base + offs, base + np.maximum(deg[:, None] - 1, 0))
    out = indices[np.minimum(pos, len(indices) - 1)]
    out = np.where(deg[:, None] == 0, frontier[:, None], out)
    return out.astype(np.int32)
