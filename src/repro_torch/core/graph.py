"""Graph containers: padded symmetric COO and the split-row ELL view.

Conventions follow ``repro.core.graph``: vertex ids are int32 in ``[0, n)``,
the COO edge list stores both directions of every edge, padding edges are
self-loops ``(0, 0, +inf)``, and weights are float32.  Containers are frozen
dataclasses of tensors that all live on one device; ``n`` is a plain int.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from repro_torch.knobs import count_build


@dataclasses.dataclass(frozen=True)
class Graph:
    """Symmetric weighted graph in COO form (padded).

    Attributes:
      src: (E,) int32 source vertex per directed edge.
      dst: (E,) int32 destination vertex per directed edge.
      w:   (E,) float32 edge weight; ``+inf`` marks padding.
      n:   number of vertices.
    """

    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    n: int

    @property
    def num_edges(self) -> int:
        """Padded directed edge count."""
        return self.src.shape[0]

    @property
    def device(self) -> torch.device:
        return self.src.device

    def to(self, device) -> "Graph":
        """A copy on ``device`` (self when already there)."""
        device = torch.device(device)
        if self.src.device == device:
            return self
        return Graph(
            src=self.src.to(device), dst=self.dst.to(device), w=self.w.to(device),
            n=self.n,
        )


def from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    n: int,
    *,
    symmetrize: bool = True,
    pad_to: int = 1,
    device="cuda",
) -> Graph:
    """Builds a padded :class:`Graph` on ``device`` from host numpy arrays.

    Args:
      src, dst, w: directed edges (one direction if ``symmetrize``).
      n: vertex count.
      symmetrize: store both directions of every edge.
      pad_to: pad edge count up to a multiple of this.
      device: where the tensors live.
    """
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    w = np.asarray(w, np.float32)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    pad = (-src.shape[0]) % pad_to
    if pad:
        src = np.concatenate([src, np.zeros(pad, np.int32)])
        dst = np.concatenate([dst, np.zeros(pad, np.int32)])
        w = np.concatenate([w, np.full(pad, np.inf, np.float32)])
    return Graph(
        src=torch.from_numpy(src).to(device),
        dst=torch.from_numpy(dst).to(device),
        w=torch.from_numpy(w).to(device),
        n=int(n),
    )


def to_networkx(g: Graph):
    """Materializes an undirected networkx graph (tests / small graphs only):
    padding edges dropped, the min weight kept on parallel edges."""
    import networkx as nx

    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    w = g.w.cpu().numpy()
    gx = nx.Graph()
    gx.add_nodes_from(range(g.n))
    real = np.isfinite(w)
    for u, v, d in zip(src[real], dst[real], w[real]):
        uu, vv = int(u), int(v)
        if gx.has_edge(uu, vv):
            gx[uu][vv]["weight"] = min(gx[uu][vv]["weight"], float(d))
        else:
            gx.add_edge(uu, vv, weight=float(d))
    return gx


def segment_min(values: torch.Tensor, index: torch.Tensor, n: int, fill) -> torch.Tensor:
    """``jax.ops.segment_min``: the min of ``values`` per ``index`` segment;
    empty segments hold ``fill`` (the identity: +inf or INT32_MAX)."""
    out = torch.full((n,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, index, values, "amin", include_self=True)


@dataclasses.dataclass(frozen=True)
class EllGraph:
    """Padded row-major adjacency (ELLPACK) with high-degree row splitting.

    Rows of a vertex whose degree exceeds ``k`` are split into several ELL
    rows mapped back to the vertex through ``row2v``.

    Attributes:
      nbr: (R, K) int32 neighbor ids; padding points at vertex 0.
      wgt: (R, K) float32 weights; padding is ``+inf``.
      row2v: (R,) int32 owning vertex of each ELL row.
      n: vertex count.
    """

    nbr: torch.Tensor
    wgt: torch.Tensor
    row2v: torch.Tensor
    n: int


def to_ell(g: Graph, k: int, *, pad_rows_to: int = 1) -> EllGraph:
    """COO -> split-row ELL with row width ``k``, on the graph's device.

    Vectorised: after a stable sort by source, the j-th edge of vertex v
    lands at flat slot ``row_off[v] * k + j`` (the rows of one vertex are
    contiguous).  Bit-equal to the per-vertex loop of ``repro.core.graph``.
    """
    dev = g.device
    real = torch.isfinite(g.w)
    src, dst, w = g.src[real], g.dst[real], g.w[real]
    src, order = torch.sort(src, stable=True)
    dst, w = dst[order], w[order]
    del order
    counts = torch.bincount(src, minlength=g.n)
    rows_per_v = torch.clamp((counts + k - 1) // k, min=1)
    row_off = torch.cumsum(rows_per_v, 0) - rows_per_v
    starts = torch.cumsum(counts, 0) - counts
    n_rows = int(rows_per_v.sum())
    padded_rows = -(-n_rows // pad_rows_to) * pad_rows_to
    flat = row_off[src] * k
    flat += torch.arange(src.shape[0], device=dev)
    flat -= starts[src]
    nbr = torch.zeros(padded_rows * k, dtype=torch.int32, device=dev)
    wgt = torch.full((padded_rows * k,), float("inf"), dtype=torch.float32, device=dev)
    nbr[flat] = dst
    wgt[flat] = w
    row2v = torch.zeros(padded_rows, dtype=torch.int32, device=dev)
    row2v[:n_rows] = torch.repeat_interleave(
        torch.arange(g.n, dtype=torch.int32, device=dev), rows_per_v,
        output_size=n_rows,
    )
    return EllGraph(
        nbr=nbr.view(padded_rows, k), wgt=wgt.view(padded_rows, k), row2v=row2v, n=g.n
    )


_ELL_MEMO_CAP = 16
_ell_memo: "dict[tuple, tuple[weakref.ref, object]]" = {}

# Per-Graph version tokens: a process-unique, never-reused integer per graph
# object.  ``id(g)`` is not a safe cache key: a collected Graph's id can be
# handed to a new Graph, and a memo keyed on it would serve the dead graph's
# view for the new one.
_token_counter = 0


def graph_token(g: Graph) -> int:
    """The graph's version token (assigned lazily, never reused)."""
    tok = getattr(g, "_version_token", None)
    if tok is None:
        tok = bump_graph_version(g)
    return tok


def bump_graph_version(g: Graph) -> int:
    """Assigns a fresh token, invalidating every memoized view of ``g``.

    Code that mutates a graph's tensors in place must bump; a new Graph
    object gets a fresh token by itself.
    """
    global _token_counter
    _token_counter += 1
    object.__setattr__(g, "_version_token", _token_counter)
    return _token_counter


def graph_cached(g, key: tuple, build):
    """Memoized ``build()`` of a view of ``g`` (a :class:`Graph`, or an
    :class:`EllGraph` whose blocked layout is memoized), keyed on
    ``(graph_token(g), *key)``.

    The memo holds a weak reference to ``g``, so retiring a graph frees its
    views; it keeps at most ``_ELL_MEMO_CAP`` entries (FIFO eviction).
    """
    key = (graph_token(g), *key)
    hit = _ell_memo.get(key)
    if hit is not None and hit[0]() is g:
        return hit[1]
    view = build()
    count_build("view")
    while len(_ell_memo) >= _ELL_MEMO_CAP:
        _ell_memo.pop(next(iter(_ell_memo)))

    def _drop(ref, key=key):
        cur = _ell_memo.get(key)
        if cur is not None and cur[0] is ref:
            del _ell_memo[key]

    _ell_memo[key] = (weakref.ref(g, _drop), view)
    return view


def ell_view_cached(g: Graph, k: int) -> EllGraph:
    """Memoized :func:`to_ell` keyed on ``(graph_token(g), k)``
    (:func:`graph_cached`)."""
    return graph_cached(g, (int(k),), lambda: to_ell(g, k))


def sort_by_dst(g: Graph):
    """Returns a copy with edges stably sorted by destination, and the perm."""
    order = torch.argsort(g.dst, stable=True)
    return Graph(src=g.src[order], dst=g.dst[order], w=g.w[order], n=g.n), order
