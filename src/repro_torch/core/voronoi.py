"""Voronoi cells (paper Alg. 2 Step 1): state, telemetry and the schedules.

Per-vertex state (paper Table II): ``dist[v]`` is the distance to the owning
seed, ``lab[v]`` the owning seed's index (``S`` when unreached), ``pred[v]``
the predecessor on the shortest path (``v`` for seeds and unreached).
Updates follow the strict lexicographic order on ``(dist, lab, pred)`` of
``repro.core.voronoi``, so every schedule reaches the same fixpoint.

The schedules of ``repro.core.voronoi``, each a JAX ``while_loop`` turned
into a Python loop with one host sync a round (its condition):

* ``mode="dense"``: every edge relaxes every round (:func:`relax_dense`);
* ``mode="bucket"``: only edges whose source distance is below a threshold
  that grows by Δ on quiet rounds;
* :func:`voronoi_cells_frontier`: the K lowest-distance dirty ELL rows a
  round (:func:`smallest_k`, the ``jax.lax.top_k`` tie rule).

The min-plus kernel schedules live in :mod:`repro_torch.kernels.minplus.ops`.

Counters ride the loops as f32 like the reference's, but each round's
counts are summed exactly (int64) and rounded once, so they do not depend
on a device's summation order.  The bucket width Δ defaults to the mean
finite weight: its sum is taken exactly (:func:`bucket_delta`) and rounded
once to f32, then divided in f32 as the reference divides.  That equals the
reference's Δ wherever its f32 sum is exact (integer weights below 2**24 in
all, as in the tests) and is the same on the card and the CPU everywhere.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.graph import EllGraph, Graph, segment_min

INF = float("inf")
IMAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class VoronoiState:
    """Per-vertex Voronoi state: (dist, lab, pred)."""

    dist: torch.Tensor  # (N,) f32
    lab: torch.Tensor  # (N,) i32; == S for unreached
    pred: torch.Tensor  # (N,) i32; == v for seeds / unreached


@dataclasses.dataclass(frozen=True)
class VoronoiStats:
    """Convergence statistics (the paper's Fig. 5/6 message metrics).

    ``relaxations`` and ``messages`` are f32 like the reference's loop
    carries, so they are exact only below 2**24.
    """

    iterations: torch.Tensor  # i32 scalar: number of global rounds
    relaxations: torch.Tensor  # f32 scalar: vertex-state improvements
    messages: torch.Tensor  # f32 scalar: candidate transmissions attempted
    # (H+1, 4) f32 per-round telemetry ring: rows 0..H-1 hold rounds 0..H-1
    # in (frontier, messages, relaxations, unreached) order; row H absorbs
    # rounds >= H.  None when the loop ran with telemetry_rounds=0.
    history: Optional[torch.Tensor] = None


def _round_row(
    frontier: torch.Tensor,
    messages: torch.Tensor,
    relaxations: torch.Tensor,
    dist: torch.Tensor,
) -> torch.Tensor:
    """One telemetry row: (frontier, messages, relaxations, unreached), f32.

    With a leading lane axis (counts (B,), ``dist`` (B, N)) it gives one row
    a lane, (B, 4).
    """
    unreached = (~torch.isfinite(dist)).sum(dim=-1)
    return torch.stack([frontier, messages, relaxations, unreached], dim=-1).to(torch.float32)


def _hist_write(hist: torch.Tensor, it: int, row: torch.Tensor) -> torch.Tensor:
    """Writes ``row`` at round ``it`` in place, clamped into the spill slot H."""
    hist[min(it, hist.shape[0] - 1)] = row
    return hist


def init_state(n: int, seeds: torch.Tensor) -> VoronoiState:
    """Paper Alg. 3 INITIALIZATION: seeds at distance 0 owning themselves.

    Duplicate seed entries are inert: the label scatter is a ``min``, so a
    vertex listed at several seed indices is owned by the lowest index and
    the higher duplicates label empty cells.
    """
    dev = seeds.device
    S = seeds.shape[0]
    dist = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    dist[seeds] = 0.0
    lab = torch.full((n,), S, dtype=torch.int32, device=dev)
    lab.scatter_reduce_(
        0, seeds.long(), torch.arange(S, dtype=torch.int32, device=dev), "amin",
        include_self=True,
    )
    pred = torch.arange(n, dtype=torch.int32, device=dev)
    return VoronoiState(dist=dist, lab=lab, pred=pred)


def init_states(n: int, seeds: torch.Tensor) -> VoronoiState:
    """:func:`init_state` of every row of a (B, S) seed batch, stacked into
    (B, N) tensors (a lane of duplicate seeds stays inert, as in one)."""
    lanes = [init_state(n, row) for row in seeds]
    return VoronoiState(
        dist=torch.stack([st.dist for st in lanes]),
        lab=torch.stack([st.lab for st in lanes]),
        pred=torch.stack([st.pred for st in lanes]),
    )


def smallest_k(p: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` smallest f32 ``p`` along the last axis, lower
    index first among equal values: the set ``jax.lax.top_k(-p, k)``
    selects (its order is not kept; every caller uses only the set).

    ``torch.topk`` makes no promise about ties, so each value is made
    unique first: its order-preserving int32 key (-0.0 below +0.0, +inf
    last) times 2**32 plus its index, one int64 ``topk``.  Returns int64
    indices, (k,) or (B, k).
    """
    bits = p.contiguous().view(torch.int32)
    bits = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # negative floats count down
    idx = torch.arange(p.shape[-1], dtype=torch.int64, device=p.device)
    key = bits.to(torch.int64) * (1 << 32) + idx
    return torch.topk(key, k, dim=-1, largest=False, sorted=False).indices


def _out_degree(g: Graph) -> torch.Tensor:
    """(N,) int64 count of each vertex's real (finite-weight) out-edges."""
    return torch.zeros(g.n, dtype=torch.int64, device=g.device).index_add_(
        0, g.src, torch.isfinite(g.w).to(torch.int64)
    )


def _round_f32(num: int, scale: int) -> np.float32:
    """``num * 2**-scale`` (exact integers) rounded once to f32, ties to even."""
    a = abs(num)
    drop = max(a.bit_length() - 24, 0)
    q, r = a >> drop, a & ((1 << drop) - 1)
    if drop and (r > 1 << (drop - 1) or (r == 1 << (drop - 1) and q & 1)):
        q += 1
    return np.float32(math.copysign(math.ldexp(q, drop - scale), num))


def weight_sums(w: torch.Tensor) -> torch.Tensor:
    """(257,) int64 exact sums of the finite f32 weights ``w``: their
    significands summed per exponent (0..255), then their count.  Sums of
    several shards add element-wise (:func:`delta_from_sums`)."""
    fin = torch.isfinite(w)
    bits = torch.where(fin, w, 0.0).view(torch.int32).to(torch.int64)
    exp = (bits >> 23) & 0xFF
    sig = (bits & 0x7FFFFF) | ((exp > 0).to(torch.int64) << 23)
    sig = torch.where(bits < 0, -sig, sig)
    per_exp = torch.zeros(257, dtype=torch.int64, device=w.device)
    per_exp.index_add_(0, exp, sig)
    per_exp[256] = fin.sum()
    return per_exp


def delta_from_sums(per_exp: torch.Tensor) -> np.float32:
    """Δ from :func:`weight_sums`: the exact sum rounded once to f32,
    divided in f32 by the count, at least 1e-6.  One host sync."""
    sums = per_exp.tolist()
    obs.host_read()
    # a significand at exponent e weighs 2**(max(e, 1) - 150)
    total = sum(s << (max(e, 1) - 1) for e, s in enumerate(sums[:256]) if s)
    mean = _round_f32(total, 149) / np.float32(max(sums[256], 1))
    return np.maximum(mean, np.float32(1e-6))


def bucket_delta(g: Graph) -> np.float32:
    """Default Δ of the bucket schedule: the mean finite weight.

    The reference takes ``max(sum(finite w) / max(count, 1), 1e-6)`` in
    f32.  Here the sum is exact: the f32 weights' significands are summed
    in int64 per exponent, combined as one integer, and rounded once to
    f32; the count is exact too, and the division is f32's.  One host sync.
    """
    return delta_from_sums(weight_sums(g.w))


def lex_segmin(cand, lab, src, seg, nseg: int):
    """The lexicographic minimum of the candidates ``(cand, lab, src)`` per
    segment ``seg`` in three segment-min passes: (m, ml, ms), each
    (nseg,), +inf / INT32_MAX where a segment has no finite candidate."""
    cand, lab, src = cand.reshape(-1), lab.reshape(-1), src.reshape(-1)
    m = segment_min(cand, seg, nseg, INF)
    e1 = cand == m[seg]
    ml = segment_min(torch.where(e1, lab, IMAX), seg, nseg, IMAX)
    e2 = e1 & (lab == ml[seg])
    ms = segment_min(torch.where(e2, src, IMAX), seg, nseg, IMAX)
    return m, ml, ms


def lex_update(cand, lab, src, seg, st: VoronoiState, active=None):
    """The strict lexicographic update every schedule applies.

    Candidates ``(cand, lab, src)`` reduce to their lexicographic minimum
    per vertex ``seg`` (three segment-min passes), and a vertex takes it
    where it strictly improves ``(dist, lab, pred)``.  Returns
    ``(new_state, upd)``, ``upd`` the improved-vertex mask.  With a lane
    axis (state (B, N)), ``seg`` holds flat ids ``lane * N + v`` and
    ``active`` (B,) keeps the state of the lanes it marks False.
    """
    shape = st.dist.shape
    m, ml, ms = (x.view(shape) for x in lex_segmin(cand, lab, src, seg, st.dist.numel()))
    same = m == st.dist
    upd = torch.isfinite(m) & (
        (m < st.dist)
        | (same & (ml < st.lab))
        | (same & (ml == st.lab) & (ms < st.pred))
    )
    if active is not None:
        upd &= active[:, None]
    new = VoronoiState(
        dist=torch.where(upd, m, st.dist),
        lab=torch.where(upd, ml, st.lab),
        pred=torch.where(upd, ms, st.pred),
    )
    return new, upd


def relax_dense(
    g: Graph,
    st: VoronoiState,
    active_cand: Optional[torch.Tensor] = None,
) -> tuple[VoronoiState, torch.Tensor]:
    """One synchronous relaxation over the (masked) edge list.

    Args:
      g: COO graph (padded edges carry +inf weight).
      st: current state.
      active_cand: optional (E,) f32 candidate override; default
        ``dist[src] + w``.  Callers mask inactive edges with +inf.

    Returns:
      (new_state, upd): ``upd`` is the (N,) bool mask of vertices whose
      (dist, lab, pred) strictly improved this round.
    """
    cand = st.dist[g.src] + g.w if active_cand is None else active_cand
    return lex_update(cand, st.lab[g.src], g.src, g.dst, st)


def _changed(a: VoronoiState, b: VoronoiState) -> torch.Tensor:
    return (a.dist != b.dist).any() | (a.lab != b.lab).any() | (a.pred != b.pred).any()


def _cap(max_iters: Optional[int], default: int) -> int:
    # clamp to int32 range like the reference: 4n + 64 overflows int32 for
    # n >= 2**29
    return min(max_iters if max_iters is not None else default, 2**31 - 2)


def _stats(it: int, rlx, msg, hist, telemetry_rounds: int) -> VoronoiStats:
    return VoronoiStats(
        iterations=torch.tensor(it, dtype=torch.int32, device=rlx.device),
        relaxations=rlx,
        messages=msg,
        history=hist if telemetry_rounds > 0 else None,
    )


def voronoi_cells(
    g: Graph,
    seeds: torch.Tensor,
    *,
    mode: str = "bucket",
    delta: Optional[float] = None,
    max_iters: Optional[int] = None,
    telemetry_rounds: int = 0,
    init: Optional[VoronoiState] = None,
) -> tuple[VoronoiState, VoronoiStats]:
    """Computes all Voronoi cells (paper Alg. 2 Step 1) on the graph's device.

    Args:
      g: symmetric weighted graph.
      seeds: (S,) int32 seed vertex ids.
      mode: "dense" (FIFO analogue) or "bucket" (priority analogue).
      delta: bucket width of mode="bucket", a host scalar > 0 (a tensor
        raises TypeError, a width <= 0 ValueError, as in the reference);
        default :func:`bucket_delta`.
      max_iters: cap on rounds (default 4n + 64).
      telemetry_rounds: H of the (H+1, 4) per-round telemetry buffer
        returned as ``stats.history`` (0: None).
      init: optional warm-start state in place of ``init_state(n, seeds)``;
        sound when every vertex is at the new fixpoint or reset to its
        initialization row (see ``repro.core.voronoi.voronoi_cells``).

    Returns:
      (VoronoiState, VoronoiStats)
    """
    if mode == "bucket" and delta is not None:
        if not isinstance(delta, (int, float, np.integer, np.floating)):
            raise TypeError(
                f"delta must be a host scalar (it is a static knob of the "
                f"bucket schedule), got {type(delta).__name__} — traced "
                f"delta values are not supported"
            )
        if not delta > 0:
            raise ValueError(f"delta must be positive, got {delta}")
    if telemetry_rounds < 0:
        raise ValueError(f"telemetry_rounds must be >= 0, got {telemetry_rounds}")
    return _voronoi_cells(
        g, seeds, mode=mode, delta=delta, max_iters=max_iters,
        telemetry_rounds=telemetry_rounds, init=init,
    )


def _voronoi_cells(
    g: Graph,
    seeds: torch.Tensor,
    *,
    mode: str,
    delta: Optional[float],
    max_iters: Optional[int],
    telemetry_rounds: int = 0,
    init: Optional[VoronoiState] = None,
) -> tuple[VoronoiState, VoronoiStats]:
    if mode not in ("dense", "bucket"):
        raise ValueError(
            f"unknown mode: {mode!r} — this entry point runs 'dense' | 'bucket'; "
            f"mode='frontier' runs via voronoi_cells_frontier over the ELL "
            f"view, and mode='pallas' via "
            f"repro_torch.kernels.minplus.ops.voronoi_cells_pallas"
        )
    n, dev = g.n, g.device
    cap = _cap(max_iters, 4 * n + 64)
    st = init_state(n, seeds) if init is None else init
    hist = torch.zeros((telemetry_rounds + 1, 4), dtype=torch.float32, device=dev)
    rlx = torch.zeros((), dtype=torch.float32, device=dev)
    msg = torch.zeros((), dtype=torch.float32, device=dev)
    # out-degree: an improved vertex "sends a message" to every neighbor
    deg = _out_degree(g)
    if mode == "bucket":
        d = np.float32(delta) if delta is not None else bucket_delta(g)
        theta = np.float32(0.0)
    it, work = 0, True
    while work and it < cap:
        if mode == "dense":
            new, upd = relax_dense(g, st)
        else:
            ds = st.dist[g.src]
            cand = torch.where(ds <= float(theta), ds + g.w, INF)
            del ds
            new, upd = relax_dense(g, st, active_cand=cand)
            del cand
        imp = upd.sum()
        dmsg = torch.where(upd, deg, 0).sum()
        if mode == "dense":
            # dense has no explicit frontier: its active set IS the
            # improved-vertex set
            _hist_write(hist, it, _round_row(imp, dmsg, imp, new.dist))
            work = bool(_changed(st, new))  # the round's one host sync
            obs.host_read()
        else:
            # frontier = vertices under the bucket threshold
            fin = torch.isfinite(new.dist)
            front = (fin & (new.dist <= float(theta))).sum()
            _hist_write(hist, it, _round_row(front, dmsg, imp, new.dist))
            max_fin = torch.where(fin, new.dist, -INF).max()
            changed, max_fin = torch.stack(  # the round's one host sync
                [_changed(st, new).to(torch.float32), max_fin]).tolist()
            obs.host_read()
            # Stop only after a quiet round with every source active (a
            # dense fixpoint check); a quiet round otherwise raises the
            # threshold by Δ.  The stall guard (d <= 0) is the reference's
            # defense in depth: a validated Δ never trips it.
            work = bool(changed) or not (theta >= max_fin or d <= 0)
            if not changed:
                theta = np.float32(theta + d)
        rlx += imp.to(torch.float32)
        msg += dmsg.to(torch.float32)
        st = new
        it += 1
    return st, _stats(it, rlx, msg, hist, telemetry_rounds)


def voronoi_cells_frontier(
    ell: EllGraph,
    seeds: torch.Tensor,
    *,
    frontier_size: int = 1024,
    max_rounds: Optional[int] = None,
    telemetry_rounds: int = 0,
    init: Optional[VoronoiState] = None,
) -> tuple[VoronoiState, VoronoiStats]:
    """Top-K compacted-frontier Voronoi cells over the ELL adjacency.

    Each round selects the (up to) K ELL rows whose vertex changed since it
    was last expanded and has the smallest tentative distance
    (:func:`smallest_k`), and pushes only those rows' edges through the
    lexicographic segment minimum: O(K·k) work a round.

    ``init`` warm-starts the loop: one violated-edge sweep marks dirty
    exactly the rows whose expansion would improve a neighbor, so a fully
    converged init exits after 0 rounds.  Default cap 16n + 64 rounds.
    """
    n = ell.n
    R, k = ell.nbr.shape
    dev = ell.nbr.device
    K = min(frontier_size, R)  # top-K cap on small graphs
    cap = _cap(max_rounds, 16 * n + 64)
    row2v = ell.row2v
    if init is None:
        st = init_state(n, seeds)
        dirty = torch.isin(row2v, seeds)  # rows of seed vertices start dirty
    else:
        st = init
        # padding slots carry +inf weight and never mark a row; the
        # tie-breaks mirror the loop's own update predicate
        cand = st.dist[row2v][:, None] + ell.wgt  # (R, k)
        nd = st.dist[ell.nbr]
        lab_u = st.lab[row2v][:, None]
        nl = st.lab[ell.nbr]
        better = torch.isfinite(cand) & (
            (cand < nd)
            | ((cand == nd) & (lab_u < nl))
            | ((cand == nd) & (lab_u == nl) & (row2v[:, None] < st.pred[ell.nbr]))
        )
        dirty = better.any(dim=1)
        del cand, nd, lab_u, nl, better
    hist = torch.zeros((telemetry_rounds + 1, 4), dtype=torch.float32, device=dev)
    rlx = torch.zeros((), dtype=torch.float32, device=dev)
    msg = torch.zeros((), dtype=torch.float32, device=dev)
    it = 0
    while it < cap:
        obs.host_read()
        if not bool(dirty.any()):  # the round's one host sync
            break
        # --- the K lowest-distance dirty rows (the "priority queue")
        rowdist = torch.where(dirty, st.dist[row2v], INF)
        rows = smallest_k(rowdist, K)
        sel = torch.isfinite(rowdist[rows])
        dirty[rows] &= ~sel  # selected rows are clean
        # --- push the selected rows' edges
        v_of = row2v[rows]
        cand = st.dist[v_of][:, None] + torch.where(sel[:, None], ell.wgt[rows], INF)
        st, upd = lex_update(
            cand, torch.where(sel, st.lab[v_of], IMAX)[:, None].expand(K, k),
            torch.where(sel, v_of, IMAX)[:, None].expand(K, k), ell.nbr[rows].reshape(-1), st)
        # rows of updated vertices become dirty again
        dirty |= upd[row2v]
        imp = upd.sum()
        dmsg = torch.isfinite(cand).sum()
        # frontier = ELL rows actually expanded this round (the top-K pop)
        _hist_write(hist, it, _round_row(sel.sum(), dmsg, imp, st.dist))
        rlx += imp.to(torch.float32)
        msg += dmsg.to(torch.float32)
        it += 1
    return st, _stats(it, rlx, msg, hist, telemetry_rounds)
