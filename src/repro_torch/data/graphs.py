"""Host-side RMAT graphs and seed selection, numpy-identical to ``repro``.

This package keeps its own copy of the generator: ``rmat_edges(s, f,
seed=x)`` here and in ``repro.data.graphs`` are the same graph, edge for
edge, so both packages compute on the same inputs.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

Chunk = Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]

# Fixed logical generation block: RMAT content is invariant to how chunks
# are regrouped because randomness is keyed per block, not per chunk.
DEFAULT_BLOCK_EDGES = 1 << 16
DEFAULT_CHUNK_EDGES = 1 << 16


class RmatEdgeSource:
    """Chunked RMAT (Graph500-style) scale-free weighted edge stream.

    n = 2**scale vertices, ~edge_factor*n undirected edges, a global id
    permutation breaking the id-degree correlation, self-loops dropped,
    integer weights uniform in [1, max_weight], and (``connect=True``) a
    random path threaded through all vertices so the graph is one component.

    Randomness is drawn from per-purpose :class:`numpy.random.SeedSequence`
    streams: ``(seed, 0)`` for the id permutation, ``(seed, 1)`` for the
    connect path, ``(seed, 2 + i)`` for edge block i.
    """

    def __init__(
        self,
        scale: int,
        edge_factor: int,
        *,
        a: float = 0.57,
        b: float = 0.19,
        c: float = 0.19,
        max_weight: int = 100,
        seed: int = 0,
        connect: bool = True,
        chunk_edges: int = DEFAULT_CHUNK_EDGES,
        block_edges: int = DEFAULT_BLOCK_EDGES,
    ):
        if not (0 < a and 0 <= b and 0 <= c and a + b + c < 1):
            raise ValueError(f"bad RMAT probabilities a={a} b={b} c={c}")
        self.scale = int(scale)
        self.edge_factor = int(edge_factor)
        self.a, self.b, self.c = a, b, c
        self.max_weight = int(max_weight)
        self.seed = int(seed)
        self.connect = bool(connect)
        self.chunk_edges = int(chunk_edges)
        self.block_edges = int(block_edges)
        self.n = 1 << self.scale
        self.m_target = self.edge_factor * self.n

    def _perm(self) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence((self.seed, 0)))
        return rng.permutation(self.n)

    def _block(self, i: int, lo: int, hi: int, perm: np.ndarray) -> Chunk:
        """Edges [lo, hi) of the logical stream (one RMAT block)."""
        rng = np.random.default_rng(np.random.SeedSequence((self.seed, 2 + i)))
        m = hi - lo
        src = np.zeros(m, np.int64)
        dst = np.zeros(m, np.int64)
        a, b, c = self.a, self.b, self.c
        for lvl in range(self.scale):
            r = rng.random(m)
            go_right_src = ((r >= a + b) & (r < a + b + c)) | (r >= a + b + c)
            go_right_dst = ((r >= a) & (r < a + b)) | (r >= a + b + c)
            src += go_right_src.astype(np.int64) << lvl
            dst += go_right_dst.astype(np.int64) << lvl
        src, dst = perm[src], perm[dst]
        keep = src != dst
        src, dst = src[keep], dst[keep]
        w = rng.integers(1, self.max_weight + 1, size=src.shape[0])
        return src.astype(np.int32), dst.astype(np.int32), w.astype(np.float32)

    def _path_chunks(self) -> Iterator[Chunk]:
        rng = np.random.default_rng(np.random.SeedSequence((self.seed, 1)))
        path = rng.permutation(self.n)
        for lo in range(0, self.n - 1, self.block_edges):
            hi = min(lo + self.block_edges, self.n - 1)
            w = rng.integers(1, self.max_weight + 1, size=hi - lo)
            yield (
                path[lo:hi].astype(np.int32),
                path[lo + 1 : hi + 1].astype(np.int32),
                w.astype(np.float32),
            )

    def _blocks(self) -> Iterator[Chunk]:
        perm = self._perm()
        for i, lo in enumerate(range(0, self.m_target, self.block_edges)):
            yield self._block(i, lo, min(lo + self.block_edges, self.m_target), perm)
        if self.connect:
            yield from self._path_chunks()

    def __iter__(self) -> Iterator[Chunk]:
        yield from _regroup(self._blocks(), self.chunk_edges)


def _regroup(blocks: Iterator[Chunk], chunk_edges: int) -> Iterator[Chunk]:
    """Re-slices a chunk stream to ~chunk_edges per yield (the edge sequence
    is unchanged, only the cut points move)."""
    for s, d, w in blocks:
        for lo in range(0, s.shape[0], chunk_edges):
            hi = min(lo + chunk_edges, s.shape[0])
            yield s[lo:hi], d[lo:hi], None if w is None else w[lo:hi]


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


def select_seeds(
    n: int,
    src: np.ndarray,
    dst: np.ndarray,
    k: int,
    *,
    strategy: str = "bfs_level",
    seed: int = 0,
) -> np.ndarray:
    """``k`` distinct seed vertices drawn uniformly at random.

    Only ``strategy="uniform"`` is ported; the other strategies of
    ``repro.data.graphs`` (whose default, ``"bfs_level"``, this signature
    keeps) raise.  ``src``/``dst`` are accepted for signature parity.
    """
    if strategy != "uniform":
        raise NotImplementedError(
            f"seed strategy {strategy!r} is not ported yet (only 'uniform')"
        )
    rng = np.random.default_rng(seed)
    return rng.choice(n, size=k, replace=False).astype(np.int32)
