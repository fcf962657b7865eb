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

Not ported yet: ``voronoi_cells_pallas_frontier`` (see ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.graph import EllGraph, segment_min
from repro_torch.core.voronoi import (
    VoronoiState,
    VoronoiStats,
    _hist_write,
    _round_row,
    init_state,
    init_states,
)
from repro_torch.kernels.minplus.minplus import (
    blocked_layout,
    minplus_blocked_call,
    minplus_call,
)

IMAX = torch.iinfo(torch.int32).max
INF = float("inf")


def _cap(max_iters: Optional[int], default: int) -> int:
    # clamp to int32 range like the reference: 4n + 64 overflows int32 for
    # n >= 2**29
    return min(max_iters if max_iters is not None else default, 2**31 - 2)


def lane_segments(row2v: torch.Tensor, n: int, lanes: int) -> torch.Tensor:
    """Flat vertex ids ``row2v + lane * n`` of the (lanes, R) kernel output,
    in int64 (lanes * n passes 2**31 on large graphs)."""
    offs = torch.arange(lanes, dtype=torch.int64, device=row2v.device)[:, None] * n
    return (row2v.to(torch.int64) + offs).reshape(-1)


def _rows_to_vertices(m, ml, ms, seg, st: VoronoiState, active=None):
    """Reduces per-row lexicographic minima to per-vertex state updates.

    Split high-degree rows recombine lexicographically; ``upd`` is the
    strict-improvement mask over (dist, lab, pred).  ``seg`` maps each row
    to its vertex; with a lane axis (m (B, R), state (B, N)) it holds the
    flat ids of :func:`lane_segments`, so one reduction serves every lane.
    ``active`` (B,) keeps the state of the lanes it marks False.
    """
    nseg = st.dist.numel()
    m, ml, ms = m.reshape(-1), ml.reshape(-1), ms.reshape(-1)
    mv = segment_min(m, seg, nseg, INF)
    e1 = m == mv[seg]
    mlv = segment_min(torch.where(e1, ml, IMAX), seg, nseg, IMAX)
    e2 = e1 & (ml == mlv[seg])
    msv = segment_min(torch.where(e2, ms, IMAX), seg, nseg, IMAX)
    shape = st.dist.shape
    mv, mlv, msv = mv.view(shape), mlv.view(shape), msv.view(shape)
    same = mv == st.dist
    upd = torch.isfinite(mv) & (
        (mv < st.dist)
        | (same & (mlv < st.lab))
        | (same & (mlv == st.lab) & (msv < st.pred))
    )
    if active is not None:
        upd &= active[:, None]
    new = VoronoiState(
        dist=torch.where(upd, mv, st.dist),
        lab=torch.where(upd, mlv, st.lab),
        pred=torch.where(upd, msv, st.pred),
    )
    return new, upd


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
    return _rows_to_vertices(m, ml, ms, seg, st, active)


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
    return st, VoronoiStats(
        iterations=torch.tensor(it, dtype=torch.int32, device=dev),
        relaxations=rlx,
        messages=msg,
        history=hist if telemetry_rounds > 0 else None,
    )


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
        if not bool(active.any()):  # the round's one host sync
            break
    return st, VoronoiStats(
        iterations=it,
        relaxations=rlx,
        messages=msg,
        history=hist if telemetry_rounds > 0 else None,
    )
