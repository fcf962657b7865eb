"""The min-plus kernel applied to Voronoi state, and its fixpoint loop.

Counterpart of ``repro.kernels.minplus.ops``: :func:`relax_ell` applies one
kernel relaxation to a :class:`VoronoiState`, and :func:`voronoi_cells_pallas`
iterates it to the fixpoint (the execution engine behind
``SolverConfig(mode="pallas")``).  The JAX ``while_loop`` becomes a Python
loop with one host sync a round (the "did anything improve" test).

:func:`voronoi_cells_pallas_lanes` is the batch backend's loop: what
``jax.vmap(voronoi_cells_pallas)`` computes for a (B, S) seed batch, with
one kernel launch a round for all B lanes (with ``src_block``, one a lane
group and source slice) and per-lane convergence masks.

:func:`voronoi_cells_pallas_frontier` is the work-compacted schedule
(``pallas_frontier=True``): each round the K highest-priority dirty ELL
rows (:func:`~repro_torch.core.voronoi.smallest_k`) are gathered into a
(K, k) tile that the kernel relaxes.  Its batch counterpart,
:func:`voronoi_cells_pallas_frontier_lanes`, gathers every active lane's K
rows into one tile and launches the kernel once a round.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core.graph import EllGraph, segment_min
from repro_torch.core.voronoi import (
    VoronoiState,
    VoronoiStats,
    _cap,
    _hist_write,
    _round_row,
    _stats,
    init_state,
    init_states,
    lex_update,
    smallest_k,
)
from repro_torch.kernels.minplus.minplus import (
    blocked_layout,
    minplus_blocked_call,
    minplus_call,
)

IMAX = torch.iinfo(torch.int32).max
INF = float("inf")


def lane_segments(row2v: torch.Tensor, n: int, lanes: int) -> torch.Tensor:
    """Flat vertex ids ``row2v + lane * n`` of the (lanes, R) kernel output,
    in int64 (lanes * n passes 2**31 on large graphs)."""
    offs = torch.arange(lanes, dtype=torch.int64, device=row2v.device)[:, None] * n
    return (row2v.to(torch.int64) + offs).reshape(-1)


def _call_kernel(nbr, wgt, dist, lab, *, block_rows, src_block, layout):
    """Dispatch one (rows, k) tile to the resident or source-blocked kernel.

    The reference pads dist/lab to a ``src_block`` multiple first; the
    blocked kernel takes any N, so the port skips that (B, N) copy.
    dist/lab may be (N,) or (B, N).
    """
    if src_block is None:
        return minplus_call(nbr, wgt, dist, lab, block_rows=block_rows)
    return minplus_blocked_call(
        nbr, wgt, dist, lab, block_rows=block_rows, src_block=src_block, layout=layout
    )


def ell_layout(ell: EllGraph, src_block: Optional[int], lanes: int = 1):
    """The :class:`BlockedLayout` of ``ell`` for ``lanes`` query lanes; None
    without ``src_block`` or on the CPU, whose plain path reads the ELL."""
    if src_block is None or ell.nbr.device.type == "cpu":
        return None
    return blocked_layout(ell.nbr, ell.wgt, ell.n, src_block, lanes > 1)


def relax_ell(
    ell: EllGraph,
    st: VoronoiState,
    *,
    block_rows: int = 256,
    src_block: Optional[int] = None,
    interpret: Optional[bool] = None,
    seg: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
    layout=None,
) -> tuple[VoronoiState, torch.Tensor]:
    """One min-plus relaxation of the full ELL adjacency via the kernel.

    The reference pads the rows to a ``block_rows`` multiple first; the
    kernels mask the ragged last block themselves, and padding rows are
    inert (+inf weights), so the port skips that copy of the adjacency.
    ``interpret`` is ignored.

    A state with a leading (B,) lane axis relaxes every lane in one kernel
    launch; ``seg`` then holds its :func:`lane_segments` (computed here if
    not given) and ``active`` (B,) the lanes whose state may change.
    ``layout`` is the blocked kernel's :func:`ell_layout` (with
    ``src_block``; built by the kernel's wrapper if not given).

    Returns:
      (new_state, upd): ``upd`` is the (N,) or (B, N) bool mask of vertices
      whose (dist, lab, pred) strictly improved.
    """
    m, ml, ms = _call_kernel(
        ell.nbr, ell.wgt, st.dist, st.lab, block_rows=block_rows, src_block=src_block,
        layout=layout,
    )
    if seg is None:
        seg = ell.row2v if st.dist.dim() == 1 else lane_segments(
            ell.row2v, ell.n, st.dist.shape[0])
    return lex_update(m, ml, ms, seg, st, active)


def _out_degree(ell: EllGraph) -> torch.Tensor:
    """(N,) int64 out-degree: the ELL rows of a vertex sum their real lanes."""
    return torch.zeros(ell.n, dtype=torch.int64, device=ell.nbr.device).index_add_(
        0, ell.row2v, torch.isfinite(ell.wgt).sum(dim=1)
    )


def voronoi_cells_pallas(
    ell: EllGraph,
    seeds: torch.Tensor,
    *,
    block_rows: int = 256,
    src_block: Optional[int] = None,
    interpret: Optional[bool] = None,
    max_iters: Optional[int] = None,
    telemetry_rounds: int = 0,
    layout=None,
) -> tuple[VoronoiState, VoronoiStats]:
    """Bellman-Ford Voronoi cells with the min-plus relaxation kernel.

    ``relaxations`` counts vertices whose state strictly improved;
    ``messages`` charges each improved vertex one message per neighbor.
    Counters and history are f32 like the reference's, so history rows
    match it bit for bit; the per-round sums are taken exactly in int64 and
    rounded once, so they do not depend on the device's summation order.
    With ``src_block``, the blocked kernel's ``layout`` (:func:`ell_layout`)
    is built once here if not given (on the card).  ``interpret`` is ignored.
    """
    n = ell.n
    dev = ell.nbr.device
    cap = _cap(max_iters, 4 * n + 64)
    st = init_state(n, seeds)
    deg = _out_degree(ell)
    if layout is None:
        layout = ell_layout(ell, src_block)
    hist = torch.zeros((telemetry_rounds + 1, 4), dtype=torch.float32, device=dev)
    rlx = torch.zeros((), dtype=torch.float32, device=dev)
    msg = torch.zeros((), dtype=torch.float32, device=dev)
    it = 0
    changed = True
    obs.round_boundary(read=False)
    while changed and it < cap:
        st, upd = relax_ell(
            ell, st, block_rows=block_rows, src_block=src_block, layout=layout
        )
        imp = upd.sum()
        dmsg = torch.where(upd, deg, 0).sum()
        _hist_write(hist, it, _round_row(imp, dmsg, imp, st.dist))
        rlx += imp.to(torch.float32)
        msg += dmsg.to(torch.float32)
        it += 1
        changed = bool(imp)  # the round's one host sync
        obs.round_boundary()
    return st, _stats(it, rlx, msg, hist, telemetry_rounds)


def voronoi_cells_pallas_lanes(
    ell: EllGraph,
    seeds: torch.Tensor,
    *,
    block_rows: int = 256,
    src_block: Optional[int] = None,
    interpret: Optional[bool] = None,
    max_iters: Optional[int] = None,
    telemetry_rounds: int = 0,
    layout=None,
) -> tuple[VoronoiState, VoronoiStats]:
    """:func:`voronoi_cells_pallas` of every row of a (B, S) seed batch.

    What ``jax.vmap`` of the reference computes: the batched ``while_loop``
    runs its body while any lane's condition holds and keeps the old carry
    of the lanes whose condition failed.  Here every round relaxes all B
    lanes in one kernel launch (the ELL is read once, not B times) and an
    ``active`` (B,) mask stands for the per-lane condition: a lane whose
    round improved nothing keeps its state, counters and history from then
    on and stops counting rounds.  Lanes start together, so the round cap
    is the same for each.  One host sync a round (is any lane active).
    Per-lane counters are rounded to f32 exactly as the single loop rounds
    them, so a lane equals :func:`voronoi_cells_pallas` of its row bit for
    bit.  ``layout`` as in :func:`voronoi_cells_pallas` (for B lanes).
    ``interpret`` is ignored.

    Returns:
      (state, stats) with a leading (B,) axis on every array: (B, N) state,
      (B,) counters, (B, H+1, 4) history.
    """
    n = ell.n
    dev = ell.nbr.device
    B = seeds.shape[0]
    cap = _cap(max_iters, 4 * n + 64)
    st = init_states(n, seeds)
    deg = _out_degree(ell)
    seg = lane_segments(ell.row2v, n, B)
    if layout is None:
        layout = ell_layout(ell, src_block, B)
    hist = torch.zeros((B, telemetry_rounds + 1, 4), dtype=torch.float32, device=dev)
    rlx = torch.zeros(B, dtype=torch.float32, device=dev)
    msg = torch.zeros(B, dtype=torch.float32, device=dev)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    rounds = 0
    obs.round_boundary(read=False)
    while rounds < cap:
        st, upd = relax_ell(
            ell, st, block_rows=block_rows, src_block=src_block, seg=seg, active=active,
            layout=layout,
        )
        imp = upd.sum(dim=1)  # 0 in the lanes that were done
        dmsg = torch.where(upd, deg, 0).sum(dim=1)
        # every active lane is at round `rounds`; the others keep their rows
        k = min(rounds, telemetry_rounds)
        row = _round_row(imp, dmsg, imp, st.dist)
        hist[:, k] = torch.where(active[:, None], row, hist[:, k])
        rlx += imp.to(torch.float32)
        msg += dmsg.to(torch.float32)
        it += active.to(torch.int32)
        active &= imp > 0
        rounds += 1
        busy = bool(active.any())  # the round's one host sync
        obs.round_boundary()
        if not busy:
            break
    return st, VoronoiStats(
        iterations=it,
        relaxations=rlx,
        messages=msg,
        history=hist if telemetry_rounds > 0 else None,
    )


def voronoi_cells_pallas_frontier(
    ell: EllGraph,
    seeds: torch.Tensor,
    *,
    frontier_size: int = 1024,
    block_rows: int = 256,
    src_block: Optional[int] = None,
    interpret: Optional[bool] = None,
    max_iters: Optional[int] = None,
    telemetry_rounds: int = 0,
) -> tuple[VoronoiState, VoronoiStats]:
    """Top-K compacted Voronoi cells over gathered kernel tiles.

    Each round touches only the K highest-priority dirty ELL rows, pulled
    through the min-plus kernel as one (K, k) tile.  Two per-row flags
    drive the schedule, as in the reference:

    * ``pull``: a neighbor of the row's vertex improved, so the row's
      minimum must be recomputed; priority is that neighbor's distance;
    * ``expand``: the row's vertex improved since the row was last
      expanded, so its listed neighbors' rows must be marked ``pull``;
      priority is the vertex's own distance.

    A selected row does both with one tile.  The reference pads the tile
    to ``block_rows``; the kernels mask a ragged tile themselves (and
    padding rows would be inert), so the port skips that copy.  With
    ``src_block`` the blocked kernel relaxes the tile, its wrapper building
    the tile's layout every round (the reference's ``_call_kernel`` path).
    Counters as in :func:`voronoi_cells_pallas`; default cap 16n + 64
    rounds; one host sync a round (is any row dirty).  ``interpret`` is
    ignored.
    """
    n = ell.n
    R, k = ell.nbr.shape
    dev = ell.nbr.device
    K = min(frontier_size, R)
    cap = _cap(max_iters, 16 * n + 64)
    row2v = ell.row2v
    st = init_state(n, seeds)
    exp = torch.isin(row2v, seeds)  # seeds "improved" at init: expand-dirty
    pull = torch.zeros(R, dtype=torch.bool, device=dev)
    prio = torch.full((R,), INF, dtype=torch.float32, device=dev)
    hist = torch.zeros((telemetry_rounds + 1, 4), dtype=torch.float32, device=dev)
    rlx = torch.zeros((), dtype=torch.float32, device=dev)
    msg = torch.zeros((), dtype=torch.float32, device=dev)
    it = 0
    while it < cap:
        obs.host_read()
        if not bool(pull.any() | exp.any()):  # the round's one host sync
            break
        # --- priority: pull at the marker's distance, expand at its own
        p = torch.minimum(torch.where(pull, prio, INF),
                          torch.where(exp, st.dist[row2v], INF))
        rows = smallest_k(p, K)
        sel = torch.isfinite(p[rows])  # rows actually dirty
        do_expand = exp[rows] & sel
        # clear the selected rows (re-marked below if their vertex improves)
        pull[rows] &= ~sel
        prio[rows] = torch.where(sel, INF, prio[rows])
        exp[rows] &= ~sel
        # --- relax the gathered tile through the kernel
        tnbr = ell.nbr[rows]
        twgt = torch.where(sel[:, None], ell.wgt[rows], INF)
        v_of = row2v[rows]
        m, ml, ms = _call_kernel(tnbr, twgt, st.dist, st.lab, block_rows=block_rows,
                                 src_block=src_block, layout=None)
        st, upd = lex_update(m, ml, ms, v_of, st)
        # --- expansion: mark the listed neighbors' rows for a pull at the
        # expander's (updated) distance
        mark = do_expand[:, None] & torch.isfinite(twgt)
        marked = _mark_prio(tnbr, mark, st.dist[v_of], n)[row2v]
        pull |= torch.isfinite(marked)
        prio = torch.minimum(prio, marked)
        # --- every row of an improved vertex needs (re-)expansion
        exp |= upd[row2v]
        imp = upd.sum()
        dmsg = torch.isfinite(twgt).sum()
        # frontier = dirty rows actually popped this round
        _hist_write(hist, it, _round_row(sel.sum(), dmsg, imp, st.dist))
        rlx += imp.to(torch.float32)
        msg += dmsg.to(torch.float32)
        it += 1
    return st, _stats(it, rlx, msg, hist, telemetry_rounds)


def _mark_prio(nbr: torch.Tensor, mark: torch.Tensor, prio_of_row: torch.Tensor, n: int):
    """(n,) f32: the least ``prio_of_row`` of a row that lists the vertex at
    a ``mark``ed slot, +inf if none.

    An expanded row's vertex has a finite distance (it is a seed or has
    improved, and distances only fall), so a vertex is marked exactly where
    this is finite: the reference's separate ``dirty_v`` scatter-max is
    ``isfinite`` of it.
    """
    cand = torch.where(mark, prio_of_row[:, None], INF).reshape(-1)
    return segment_min(cand, nbr.reshape(-1).long(), n, INF)


def voronoi_cells_pallas_frontier_lanes(
    ell: EllGraph,
    seeds: torch.Tensor,
    *,
    frontier_size: int = 1024,
    block_rows: int = 256,
    src_block: Optional[int] = None,
    interpret: Optional[bool] = None,
    max_iters: Optional[int] = None,
    telemetry_rounds: int = 0,
) -> tuple[VoronoiState, VoronoiStats]:
    """:func:`voronoi_cells_pallas_frontier` of every row of a (B, S) seed
    batch (what ``jax.vmap`` of it computes), with one kernel launch a round.

    Each active lane selects its own K rows.  The rows of all active lanes
    form one (A·K, k) tile whose neighbor ids are offset by lane·N into the
    flattened (B·N,) dist and lab, so the single-query kernel relaxes every
    lane at once; the offset is taken off the winning neighbor ids after.
    A constant offset within a row keeps its lexicographic order, so each
    lane gets exactly its own tile's result.  A lane whose condition fails
    keeps its state, counters and history from then on, as the batched
    ``while_loop`` keeps the carry of a finished lane, so every lane equals
    the single loop of its row bit for bit.  One host sync a round (which
    lanes are active).  ``interpret`` is ignored.

    Returns:
      (state, stats) with a leading (B,) axis on every array.
    """
    n = ell.n
    R, k = ell.nbr.shape
    dev = ell.nbr.device
    B = seeds.shape[0]
    if B * n >= 2**31:
        raise ValueError(f"{B} lanes of {n} vertices pass int32 neighbor ids")
    K = min(frontier_size, R)
    cap = _cap(max_iters, 16 * n + 64)
    row2v = ell.row2v
    st = init_states(n, seeds)
    exp = torch.stack([torch.isin(row2v, s) for s in seeds])
    pull = torch.zeros((B, R), dtype=torch.bool, device=dev)
    prio = torch.full((B, R), INF, dtype=torch.float32, device=dev)
    hist = torch.zeros((B, telemetry_rounds + 1, 4), dtype=torch.float32, device=dev)
    rlx = torch.zeros(B, dtype=torch.float32, device=dev)
    msg = torch.zeros(B, dtype=torch.float32, device=dev)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    active = (pull.any(dim=1) | exp.any(dim=1)) & (cap > 0)
    lanes = active.nonzero().squeeze(1)  # the round's one host sync
    obs.host_read()
    rounds = 0
    while lanes.numel():
        A = lanes.numel()
        lane_off = lanes * n  # (A,) int64
        p = torch.minimum(torch.where(pull[lanes], prio[lanes], INF),
                          torch.where(exp[lanes], st.dist[lanes][:, row2v], INF))
        rows = smallest_k(p, K)  # (A, K)
        sel = torch.isfinite(p.gather(1, rows))
        flat_rows = (lanes[:, None] * R + rows).reshape(-1)
        do_expand = exp.view(-1)[flat_rows].view(A, K) & sel
        pull.view(-1)[flat_rows] &= ~sel.reshape(-1)
        prio.view(-1)[flat_rows] = torch.where(sel, INF, prio.view(-1)[flat_rows].view(A, K)
                                               ).reshape(-1)
        exp.view(-1)[flat_rows] &= ~sel.reshape(-1)
        rows = rows.reshape(-1)
        tnbr = (ell.nbr[rows].view(A, K, k) + lane_off[:, None, None].to(torch.int32)
                ).view(A * K, k)
        twgt = torch.where(sel.reshape(-1, 1), ell.wgt[rows], INF)
        seg = (row2v[rows].view(A, K) + lane_off[:, None]).reshape(-1)  # flat vertex ids
        m, ml, ms = _call_kernel(tnbr, twgt, st.dist.view(-1), st.lab.view(-1),
                                 block_rows=block_rows, src_block=src_block, layout=None)
        # (a row with no finite candidate holds IMAX there, which no update reads)
        ms = ms - lane_off.repeat_interleave(K).to(torch.int32)
        flat_st = VoronoiState(dist=st.dist.view(-1), lab=st.lab.view(-1),
                               pred=st.pred.view(-1))
        new, upd = lex_update(m, ml, ms, seg, flat_st)
        st = VoronoiState(dist=new.dist.view(B, n), lab=new.lab.view(B, n),
                          pred=new.pred.view(B, n))
        upd = upd.view(B, n)
        mark = do_expand.reshape(-1, 1) & torch.isfinite(twgt)
        marked = _mark_prio(tnbr, mark, st.dist.view(-1)[seg], B * n).view(B, n)[:, row2v]
        pull |= torch.isfinite(marked)
        prio = torch.minimum(prio, marked)
        exp |= upd[:, row2v]
        imp = upd.sum(dim=1)  # 0 in the lanes that were done
        dmsg = torch.zeros(B, dtype=torch.int64, device=dev).index_add_(
            0, lanes, torch.isfinite(twgt).view(A, K * k).sum(dim=1))
        front = torch.zeros(B, dtype=torch.int64, device=dev).index_add_(
            0, lanes, sel.sum(dim=1))
        # every active lane is at round `rounds`; the others keep their rows
        h = min(rounds, telemetry_rounds)
        row = _round_row(front, dmsg, imp, st.dist)
        hist[:, h] = torch.where(active[:, None], row, hist[:, h])
        rlx += imp.to(torch.float32)
        msg += dmsg.to(torch.float32)
        it += active.to(torch.int32)
        rounds += 1
        active &= (pull.any(dim=1) | exp.any(dim=1)) & (rounds < cap)
        lanes = active.nonzero().squeeze(1)  # the round's one host sync
        obs.host_read()
    return st, VoronoiStats(
        iterations=it,
        relaxations=rlx,
        messages=msg,
        history=hist if telemetry_rounds > 0 else None,
    )
