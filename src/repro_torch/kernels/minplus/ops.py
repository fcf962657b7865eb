"""The min-plus kernel applied to Voronoi state, and its fixpoint loop.

Counterpart of ``repro.kernels.minplus.ops``: :func:`relax_ell` applies one
kernel relaxation to a :class:`VoronoiState`, and :func:`voronoi_cells_pallas`
iterates it to the fixpoint (the execution engine behind
``SolverConfig(mode="pallas")``).  The JAX ``while_loop`` becomes a Python
loop with one host sync a round (the "did anything improve" test).

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
)
from repro_torch.kernels.minplus.minplus import minplus_blocked_call, minplus_call

IMAX = torch.iinfo(torch.int32).max
INF = float("inf")


def _cap(max_iters: Optional[int], default: int) -> int:
    # clamp to int32 range like the reference: 4n + 64 overflows int32 for
    # n >= 2**29
    return min(max_iters if max_iters is not None else default, 2**31 - 2)


def _pad_rows(x: torch.Tensor, mult: int, fill) -> torch.Tensor:
    """Pads the leading axis of ``x`` with ``fill`` up to a multiple of ``mult``."""
    pad = (-x.shape[0]) % mult
    if pad == 0:
        return x
    return torch.cat([x, torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)])


def _rows_to_vertices(m, ml, ms, row2v, n, st: VoronoiState):
    """Reduces per-row lexicographic minima to per-vertex state updates.

    Split high-degree rows recombine lexicographically; ``upd`` is the
    strict-improvement mask over (dist, lab, pred).
    """
    mv = segment_min(m, row2v, n, INF)
    e1 = m == mv[row2v]
    mlv = segment_min(torch.where(e1, ml, IMAX), row2v, n, IMAX)
    e2 = e1 & (ml == mlv[row2v])
    msv = segment_min(torch.where(e2, ms, IMAX), row2v, n, IMAX)
    same = mv == st.dist
    upd = torch.isfinite(mv) & (
        (mv < st.dist)
        | (same & (mlv < st.lab))
        | (same & (mlv == st.lab) & (msv < st.pred))
    )
    new = VoronoiState(
        dist=torch.where(upd, mv, st.dist),
        lab=torch.where(upd, mlv, st.lab),
        pred=torch.where(upd, msv, st.pred),
    )
    return new, upd


def _call_kernel(nbr, wgt, dist, lab, *, block_rows, src_block):
    """Dispatch one (rows, k) tile to the resident or source-blocked kernel.

    For the blocked kernel, dist/lab are padded with the identity (+inf,
    IMAX) to a ``src_block`` multiple, as the reference does.
    """
    if src_block is None:
        return minplus_call(nbr, wgt, dist, lab, block_rows=block_rows)
    dist = _pad_rows(dist, src_block, INF)
    lab = _pad_rows(lab, src_block, IMAX)
    return minplus_blocked_call(
        nbr, wgt, dist, lab, block_rows=block_rows, src_block=src_block
    )


def relax_ell(
    ell: EllGraph,
    st: VoronoiState,
    *,
    block_rows: int = 256,
    src_block: Optional[int] = None,
    interpret: Optional[bool] = None,
) -> tuple[VoronoiState, torch.Tensor]:
    """One min-plus relaxation of the full ELL adjacency via the kernel.

    The reference pads the rows to a ``block_rows`` multiple first; the
    kernels mask the ragged last block themselves, and padding rows are
    inert (+inf weights), so the port skips that copy of the adjacency.
    ``interpret`` is ignored.

    Returns:
      (new_state, upd): ``upd`` is the (N,) bool mask of vertices whose
      (dist, lab, pred) strictly improved.
    """
    m, ml, ms = _call_kernel(
        ell.nbr, ell.wgt, st.dist, st.lab, block_rows=block_rows, src_block=src_block
    )
    return _rows_to_vertices(m, ml, ms, ell.row2v, ell.n, st)


def voronoi_cells_pallas(
    ell: EllGraph,
    seeds: torch.Tensor,
    *,
    block_rows: int = 256,
    src_block: Optional[int] = None,
    interpret: Optional[bool] = None,
    max_iters: Optional[int] = None,
    telemetry_rounds: int = 0,
) -> tuple[VoronoiState, VoronoiStats]:
    """Bellman-Ford Voronoi cells with the min-plus relaxation kernel.

    ``relaxations`` counts vertices whose state strictly improved;
    ``messages`` charges each improved vertex one message per neighbor.
    Counters and history are f32 like the reference's, so history rows
    match it bit for bit; the per-round sums are taken exactly in int64 and
    rounded once, so they do not depend on the device's summation order.
    ``interpret`` is ignored.
    """
    n = ell.n
    dev = ell.nbr.device
    cap = _cap(max_iters, 4 * n + 64)
    st = init_state(n, seeds)
    # out-degree per vertex: ELL rows of one vertex sum their real lanes
    deg = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, ell.row2v, torch.isfinite(ell.wgt).sum(dim=1)
    )
    hist = torch.zeros((telemetry_rounds + 1, 4), dtype=torch.float32, device=dev)
    rlx = torch.zeros((), dtype=torch.float32, device=dev)
    msg = torch.zeros((), dtype=torch.float32, device=dev)
    it = 0
    changed = True
    while changed and it < cap:
        st, upd = relax_ell(ell, st, block_rows=block_rows, src_block=src_block)
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
