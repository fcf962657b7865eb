"""Distance graph G'1 construction (paper Alg. 2 Step 2 / Alg. 5).

For every pair of Voronoi cells (s, t) bridged by a cross-cell edge (u, v),
``d'1(s, t) = min d1(s, u) + d(u, v) + d1(v, t)`` with the bridge (u, v)
that realizes it, oriented so that u lies in the lower-indexed seed's
cell.  Ties break lexicographically on (d', u, v), as in
``repro.core.distance_graph``.  The pair tables are dense, S*S entries
with flat key ``min*S + max``.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.graph import Graph, segment_min
from repro_torch.core.voronoi import VoronoiState

INF = float("inf")
IMAX = torch.iinfo(torch.int32).max


def pair_key(a: torch.Tensor, b: torch.Tensor, S: int) -> torch.Tensor:
    """Canonical flat key for an unordered seed-index pair (a != b)."""
    return torch.minimum(a, b) * S + torch.maximum(a, b)


def local_pair_tables(
    src: torch.Tensor,
    dst: torch.Tensor,
    w: torch.Tensor,
    dist_src: torch.Tensor,
    dist_dst: torch.Tensor,
    lab_src: torch.Tensor,
    lab_dst: torch.Tensor,
    S: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pair tables over an edge slice; all inputs are (e,) tensors.

    Returns (dmat, umat, vmat), each (S*S,): the least bridge distance per
    pair (+inf if none), and the bridge's endpoint in the lower and in the
    higher seed's cell (IMAX if none).

    The reference sends every non-cross edge to a sentinel bin ``S*S`` that
    it then drops; here only the cross edges are scattered, which gives the
    same tables without piling every other edge onto one address.
    """
    cross = (lab_src != lab_dst) & (lab_src < S) & (lab_dst < S) & torch.isfinite(w)
    idx = torch.nonzero(cross).squeeze(1)
    obs.host_read()
    src, dst, w = src[idx], dst[idx], w[idx]
    dist_src, dist_dst = dist_src[idx], dist_dst[idx]
    lab_src, lab_dst = lab_src[idx], lab_dst[idx]
    del idx, cross
    d = dist_src + w + dist_dst
    key = pair_key(lab_src, lab_dst, S)
    lower_first = lab_src < lab_dst
    cu = torch.where(lower_first, src, dst)
    cv = torch.where(lower_first, dst, src)
    dmat = segment_min(d, key, S * S, INF)
    e1 = d == dmat[key]
    umat = segment_min(torch.where(e1, cu, IMAX), key, S * S, IMAX)
    e2 = e1 & (cu == umat[key])
    vmat = segment_min(torch.where(e2, cv, IMAX), key, S * S, IMAX)
    return dmat, umat, vmat


def edge_pair_tables(
    src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, dist: torch.Tensor,
    lab: torch.Tensor, S: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pair tables of an edge list (global ids into ``dist``/``lab``): finds
    the cross-cell edges, then reduces them.

    The cross test needs only the labels and weights, so the distances and
    endpoints are gathered for the cross edges alone.
    """
    lab_src, lab_dst = lab[src], lab[dst]
    cross = (lab_src != lab_dst) & (lab_src < S) & (lab_dst < S) & torch.isfinite(w)
    idx = torch.nonzero(cross).squeeze(1)
    obs.host_read()
    del cross
    src, dst = src[idx], dst[idx]
    lab_src, lab_dst = lab_src[idx], lab_dst[idx]
    return local_pair_tables(
        src, dst, w[idx], dist[src], dist[dst], lab_src, lab_dst, S
    )


def distance_graph(
    g: Graph, st: VoronoiState, S: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-device G'1 over the graph's edges (:func:`edge_pair_tables`)."""
    return edge_pair_tables(g.src, g.dst, g.w, st.dist, st.lab, S)
