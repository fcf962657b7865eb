"""Streaming two-pass CSR ingestion: bounded peak memory, any edge source.

A numpy-only copy of ``repro.graphstore.ingest`` (edge sources, the
two-pass CSR builder and ``build_store``): a store written here and one
written by the reference from the same source hold the same arrays, byte
for byte.

An *edge source* is any re-iterable object with an ``n`` attribute that
yields ``(src, dst, w)`` numpy chunks (one direction per undirected edge).
:func:`build_store` folds it into an on-disk CSR with two passes:

    pass 1  count degrees per vertex        O(n) host memory
    pass 2  scatter edges into memmapped    O(n) cursors + one chunk of
            ``indices``/``weights``         transient sort scratch

Nothing holds all M edges at once: the per-chunk transient is a small
multiple of the chunk's own bytes, and :class:`IngestStats.peak_chunk_bytes`
reports the measured maximum.

Sources provided here: :class:`RmatEdgeSource` (chunked Graph500-style
RMAT; the graph is a function of ``(scale, edge_factor, seed,
block_edges)`` only), :class:`TsvEdgeSource` (SNAP-style ``u v [w]`` edge
lists) and :class:`ArraySource` (in-memory arrays sliced into chunks).

With :mod:`repro_torch.obs` enabled, an ingest records the spans
``ingest:build_store``, ``ingest:pass1_degrees``, ``ingest:pass2_scatter``
and one ``ingest:chunk`` a chunk and pass, the
``graphstore_ingest_edges_total`` counter and two gauges, as the
reference's does.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Iterator, Optional, Tuple, Union

import numpy as np

from repro_torch import obs
from repro_torch.graphstore.format import StoreWriter

Chunk = Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]

# Fixed logical generation block: RMAT content is invariant to how chunks
# are regrouped because randomness is keyed per block, not per chunk.
DEFAULT_BLOCK_EDGES = 1 << 16
DEFAULT_CHUNK_EDGES = 1 << 16


# ----------------------------------------------------------------------------
# Edge sources
# ----------------------------------------------------------------------------


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
        self.describe = f"rmat(scale={scale}, edge_factor={edge_factor}, seed={seed})"

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


class TsvEdgeSource:
    """SNAP-style whitespace-separated edge list: ``u v [w]`` per line.

    Lines starting with ``#`` (SNAP headers) are skipped; a missing
    weight column gets ``default_weight``.  ``n`` is taken from the
    constructor or discovered with one extra streaming pass.
    """

    def __init__(
        self,
        path: Union[str, Path],
        *,
        n: Optional[int] = None,
        default_weight: float = 1.0,
        chunk_edges: int = DEFAULT_CHUNK_EDGES,
    ):
        self.path = Path(path)
        self.default_weight = float(default_weight)
        self.chunk_edges = int(chunk_edges)
        self._n = n
        self.describe = f"tsv({self.path.name})"

    @property
    def n(self) -> int:
        if self._n is None:
            hi = -1
            for s, d, _ in self:
                if s.size:
                    hi = max(hi, int(s.max()), int(d.max()))
            self._n = hi + 1
        return self._n

    def __iter__(self) -> Iterator[Chunk]:
        src: list = []
        dst: list = []
        w: list = []
        with open(self.path, "r") as f:
            for line in f:
                stripped = line.strip()
                if not stripped or stripped.startswith("#"):
                    continue
                parts = stripped.split()
                src.append(int(parts[0]))
                dst.append(int(parts[1]))
                w.append(float(parts[2]) if len(parts) > 2 else self.default_weight)
                if len(src) >= self.chunk_edges:
                    yield (
                        np.asarray(src, np.int32),
                        np.asarray(dst, np.int32),
                        np.asarray(w, np.float32),
                    )
                    src, dst, w = [], [], []
        if src:
            yield (
                np.asarray(src, np.int32),
                np.asarray(dst, np.int32),
                np.asarray(w, np.float32),
            )


class ArraySource:
    """Chunks over already-materialized edge arrays (one direction)."""

    def __init__(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        w: Optional[np.ndarray],
        n: int,
        *,
        chunk_edges: int = DEFAULT_CHUNK_EDGES,
    ):
        self.src = np.asarray(src)
        self.dst = np.asarray(dst)
        self.w = None if w is None else np.asarray(w, np.float32)
        self.n = int(n)
        self.chunk_edges = int(chunk_edges)
        self.describe = f"arrays({self.src.shape[0]} edges)"

    def __iter__(self) -> Iterator[Chunk]:
        m = self.src.shape[0]
        for lo in range(0, max(m, 1), self.chunk_edges):
            hi = min(lo + self.chunk_edges, m)
            if hi <= lo:
                return
            yield (
                self.src[lo:hi],
                self.dst[lo:hi],
                None if self.w is None else self.w[lo:hi],
            )


def _regroup(blocks: Iterator[Chunk], chunk_edges: int) -> Iterator[Chunk]:
    """Re-slices a chunk stream to ~chunk_edges per yield (the edge sequence
    is unchanged, only the cut points move)."""
    for s, d, w in blocks:
        for lo in range(0, s.shape[0], chunk_edges):
            hi = min(lo + chunk_edges, s.shape[0])
            yield s[lo:hi], d[lo:hi], None if w is None else w[lo:hi]


# ----------------------------------------------------------------------------
# Two-pass CSR construction
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IngestStats:
    """What one ingest did and what it cost.

    ``peak_chunk_bytes`` is the measured maximum, over chunks, of the
    transient host arrays alive while folding that chunk in;
    ``fixed_bytes`` the O(n) resident state (degree counts and cursors).
    """

    n: int
    m_directed: int
    edges_in: int
    chunks: int
    seconds: float
    edges_per_sec: float
    peak_chunk_bytes: int
    fixed_bytes: int
    weight_min: float
    weight_max: float


def _chunk_pairs(chunk: Chunk, symmetrize: bool):
    """Directed (s, d, w, transient_bytes) view of one chunk."""
    s, d, w = chunk
    s = np.asarray(s)
    d = np.asarray(d)
    if w is None:
        w = np.ones(s.shape[0], np.float32)
    else:
        w = np.asarray(w, np.float32)
    nbytes = s.nbytes + d.nbytes + w.nbytes
    if symmetrize:
        s, d = np.concatenate([s, d]), np.concatenate([d, s])
        w = np.concatenate([w, w])
        nbytes += s.nbytes + d.nbytes + w.nbytes
    return s, d, w, nbytes


def _check_ids(s: np.ndarray, d: np.ndarray, n: int) -> None:
    if s.size and (
        int(s.min()) < 0 or int(d.min()) < 0
        or int(s.max()) >= n or int(d.max()) >= n
    ):
        raise ValueError(
            f"edge endpoint out of range [0, {n}): "
            f"src in [{s.min()}, {s.max()}], dst in [{d.min()}, {d.max()}]"
        )


def _stable_order(keys: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """``np.argsort(keys, kind="stable")`` for keys in ``[0, n)``, and the
    sorted keys.  Where key and position fit 63 bits, one sort of the
    distinct int64 values ``key << b | position`` (several times faster
    than numpy's stable argsort of a large chunk); else the stable argsort.
    """
    m = keys.shape[0]
    ib = max(int(m - 1).bit_length(), 1)
    if max(int(n - 1).bit_length(), 1) + ib > 63:
        o = np.argsort(keys, kind="stable")
        return o, keys[o]
    comp = keys.astype(np.int64) << ib
    comp |= np.arange(m, dtype=np.int64)
    comp.sort()
    return comp & ((1 << ib) - 1), (comp >> ib).astype(keys.dtype)


def csr_two_pass(
    n: int,
    source,
    alloc: Callable[[int], Tuple[np.ndarray, np.ndarray]],
    *,
    symmetrize: bool = True,
):
    """Degree-count pass + scatter pass over a re-iterable edge source.

    ``alloc(m)`` supplies the (indices, weights) destinations (memmaps for
    on-disk stores, ``np.empty`` for in-memory callers) once pass 1 fixes
    the directed edge count ``m``.  Within a row, edges keep stream order.
    Returns ``(indptr, indices, weights, stats_dict)``.
    """
    n = int(n)
    deg = np.zeros(n, np.int64)
    edges_in = 0
    chunks = 0
    peak = 0
    wmin, wmax = np.inf, -np.inf
    trace = obs.tracing()
    with obs.span("ingest:pass1_degrees", n=n):
        for chunk in source:
            t_c = time.perf_counter()
            s, d, w, nbytes = _chunk_pairs(chunk, symmetrize)
            _check_ids(s, d, n)
            edges_in += chunk[0].shape[0]
            chunks += 1
            counts = np.bincount(s, minlength=n)
            deg += counts
            if w.size:
                wmin = min(wmin, float(w.min()))
                wmax = max(wmax, float(w.max()))
            peak = max(peak, nbytes + counts.nbytes)
            if trace:
                obs.add_span(
                    "ingest:chunk",
                    t_c,
                    time.perf_counter(),
                    phase="pass1",
                    chunk=chunks - 1,
                    edges=int(chunk[0].shape[0]),
                )

    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    m = int(indptr[-1])
    indices, weights = alloc(m)

    cursor = indptr[:-1].copy()
    with obs.span("ingest:pass2_scatter", n=n, m=m):
        for ci, chunk in enumerate(source):
            t_c = time.perf_counter()
            s, d, w, nbytes = _chunk_pairs(chunk, symmetrize)
            if s.size == 0:  # sources may legally yield empty chunks
                continue
            o, ss = _stable_order(s, n)
            dd, ww = d[o], w[o]
            # within-run offsets: position of each edge inside its vertex run
            run_start = np.r_[0, np.flatnonzero(ss[1:] != ss[:-1]) + 1]
            run_len = np.diff(np.r_[run_start, ss.shape[0]])
            within = np.arange(ss.shape[0]) - np.repeat(run_start, run_len)
            tgt = cursor[ss] + within
            indices[tgt] = dd
            weights[tgt] = ww
            cursor[ss[run_start]] += run_len
            nbytes += o.nbytes + ss.nbytes + dd.nbytes + ww.nbytes
            nbytes += run_start.nbytes + run_len.nbytes + within.nbytes + tgt.nbytes
            peak = max(peak, nbytes)
            if trace:
                obs.add_span(
                    "ingest:chunk",
                    t_c,
                    time.perf_counter(),
                    phase="pass2",
                    chunk=ci,
                    edges=int(chunk[0].shape[0]),
                )

    if not np.array_equal(cursor, indptr[1:]):
        raise RuntimeError(
            "edge source yielded different chunks on the second pass "
            "(sources must be re-iterable and deterministic)"
        )
    stats = dict(
        n=n,
        m_directed=m,
        edges_in=edges_in,
        chunks=chunks,
        peak_chunk_bytes=int(peak),
        fixed_bytes=int(deg.nbytes + cursor.nbytes + indptr.nbytes),
        weight_min=float(wmin) if m else 0.0,
        weight_max=float(wmax) if m else 0.0,
    )
    return indptr, indices, weights, stats


def _alloc_in_memory(m: int):
    return np.empty(m, np.int32), np.empty(m, np.float32)


def csr_from_chunks(
    n: int, source, *, symmetrize: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """In-memory CSR (indptr, indices, weights) from an edge source."""
    indptr, indices, weights, _ = csr_two_pass(
        n, source, _alloc_in_memory, symmetrize=symmetrize
    )
    return indptr, indices, weights


def build_store(
    source,
    out_path: Union[str, Path],
    *,
    symmetrize: bool = True,
) -> Tuple[Path, IngestStats]:
    """Streams an edge source into a ``.gstore`` directory.

    Two passes over ``source`` (it must be re-iterable); peak host memory
    is O(n) fixed state plus a bounded per-chunk transient, never O(M).
    Returns the store's path and its :class:`IngestStats`.
    """
    t0 = time.perf_counter()
    n = int(source.n)
    writer = StoreWriter(out_path)
    indptr_mm = writer.create_array("indptr", np.int64, (n + 1,))

    def alloc(m: int):
        return (
            writer.create_array("indices", np.int32, (m,)),
            writer.create_array("weights", np.float32, (m,)),
        )

    with obs.span(
        "ingest:build_store",
        out=str(out_path),
        source=getattr(source, "describe", type(source).__name__),
    ):
        indptr, _, _, raw = csr_two_pass(n, source, alloc, symmetrize=symmetrize)
        indptr_mm[...] = indptr
    dt = time.perf_counter() - t0
    stats = IngestStats(
        seconds=dt,
        edges_per_sec=raw["edges_in"] / dt if dt > 0 else 0.0,
        **raw,
    )
    for name, help, value in (
        ("graphstore_ingest_edges_per_sec", "last build_store throughput",
         stats.edges_per_sec),
        ("graphstore_ingest_peak_chunk_bytes",
         "measured per-chunk transient peak of the last ingest",
         stats.peak_chunk_bytes),
    ):
        gauge = obs.gauge(name, help)
        if gauge is not None:
            gauge.set(value)
    ctr = obs.counter("graphstore_ingest_edges_total", "input edges streamed into stores")
    if ctr is not None:
        ctr.inc(stats.edges_in)
    writer.set_meta(
        n=n,
        m=stats.m_directed,
        symmetric=bool(symmetrize),
        weight_range=[stats.weight_min, stats.weight_max],
        partition=None,
        source=getattr(source, "describe", type(source).__name__),
        ingest={
            "edges_in": stats.edges_in,
            "chunks": stats.chunks,
            "seconds": round(stats.seconds, 3),
            "edges_per_sec": round(stats.edges_per_sec, 1),
            "peak_chunk_bytes": stats.peak_chunk_bytes,
            "fixed_bytes": stats.fixed_bytes,
        },
    )
    return writer.close(), stats
