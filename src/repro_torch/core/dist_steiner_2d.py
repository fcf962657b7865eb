"""The 2D (src-block x dst-block) partitioned Voronoi engine, beyond the paper.

The counterpart of ``repro.core.dist_steiner_2d``, over ``torch.distributed``
(:mod:`repro_torch.core.mesh`).  The 1D partition all-gathers the whole
(dist, lab) vector every round; the classic 2D SpMV decomposition gives
edge (u, v) to rank (row(u), col(v)):

  * vertices live in R*C fine blocks of ``nf``; rank (r, c) owns fine block
    f = r*C + c;
  * the round's gather is along the row only (over "model": the
    n/R-sized source range of row r);
  * the lexicographic MIN runs down the column (over "data") on the
    n/C-sized destination range.

The pair-table, MST and extraction stages are the 1D engine's
(:func:`repro_torch.core.dist_steiner._finish`), with one-time gathers over
the whole mesh.  The converged output equals the 1D engine's bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import mesh as meshmod
from repro_torch.core.dist_steiner import _count, _finish, _init_block, _rank_rows, _Round
from repro_torch.core.mesh import MAX, SUM, all_gather_tiled, all_reduce, lex_pmin
from repro_torch.core.voronoi import VoronoiState, delta_from_sums, lex_segmin, weight_sums

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class Partition2D:
    """Rank-major flat edge arrays of the (row x col) layout.

    For rank (r, c): ``src_row`` is LOCAL to row r's vertex range
    [r*C*nf, (r+1)*C*nf); ``dst_col`` is local to column c's interleaved
    range (fine block i*C + c -> [i*nf, (i+1)*nf)).
    """

    src_row: np.ndarray
    dst_col: np.ndarray
    w: np.ndarray
    n: int
    nf: int
    R: int
    C: int
    eb: int

    @property
    def npad(self) -> int:
        return self.nf * self.R * self.C


def partition_edges_2d(
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    n: int,
    *,
    R: int,
    C: int,
    symmetrize: bool = True,
    block_multiple: int = 8,
) -> Partition2D:
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(w, np.float32)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    nf = -(-n // (R * C))
    nf = -(-nf // block_multiple) * block_multiple
    fine_s = src // nf
    fine_d = dst // nf
    r = np.minimum(fine_s // C, R - 1)
    c = fine_d % C
    dev = r * C + c
    order = np.argsort(dev, kind="stable")
    src, dst, w, dev = src[order], dst[order], w[order], dev[order]
    counts = np.bincount(dev, minlength=R * C)
    eb = -(-int(counts.max()) // block_multiple) * block_multiple
    osrc = np.zeros((R * C, eb), np.int32)
    odst = np.zeros((R * C, eb), np.int32)
    ow = np.full((R * C, eb), np.inf, np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for d in range(R * C):
        s0, cnt = starts[d], counts[d]
        sl = slice(s0, s0 + cnt)
        rr = d // C
        # local src within row rr
        osrc[d, :cnt] = src[sl] - rr * C * nf
        # local dst within column c: fine i = dst//nf (i % C == c)
        fi = dst[sl] // nf
        odst[d, :cnt] = (fi // C) * nf + (dst[sl] % nf)
        ow[d, :cnt] = w[sl]
    return Partition2D(
        src_row=osrc.reshape(-1),
        dst_col=odst.reshape(-1),
        w=ow.reshape(-1),
        n=n,
        nf=nf,
        R=R,
        C=C,
        eb=eb,
    )


def make_dist_steiner_2d(
    mesh: meshmod.Mesh,
    *,
    n: int,
    nf: int,
    num_seeds: int,
    mode: str = "bucket",
    mst_algo: str = "prim",
    max_iters=None,
    delta=None,
    row_axis: str = "data",
    col_axis: str = "model",
    telemetry_rounds: int = 0,
    telemetry_per_rank: bool = False,
):
    """This rank's part of the 2D pipeline: ``fn(src_row, dst_col, w,
    seeds)`` over its shard -> the 1D engine's 14 outputs (vertex arrays in
    fine-block order, which is plain vertex order).

    Seeds are scattered with ``min`` as in the 1D engine, so a vertex listed
    at several seed indices is owned by the lowest one (the reference's 2D
    scatter leaves that order unspecified).
    """
    if telemetry_rounds < 0:
        raise ValueError(f"telemetry_rounds must be >= 0, got {telemetry_rounds}")
    if telemetry_per_rank and telemetry_rounds < 1:
        raise ValueError(
            "telemetry_per_rank requires telemetry_rounds >= 1 "
            "(the per-rank flight recorder rides the round buffer)"
        )
    R, C = mesh.shape[row_axis], mesh.shape[col_axis]
    S = num_seeds
    npad = nf * R * C
    row_n = C * nf  # vertices of a row block
    col_n = R * nf  # vertices of a column block
    cap = min(max_iters if max_iters is not None else 4 * n + 64, 2**31 - 2)
    both = (row_axis, col_axis)
    g_row, g_col, g_both = mesh.group((row_axis,)), mesh.group((col_axis,)), mesh.group(both)
    r_idx, c_idx = mesh.coords[row_axis], mesh.coords[col_axis]
    off = (r_idx * C + c_idx) * nf  # global base of this rank's slice
    col_pos = r_idx * nf  # this slice's offset within the column range
    n_ghost = npad - n
    n_ranks = R * C if telemetry_per_rank else 0

    def gather_both(dist_l, lab_l):
        full = all_gather_tiled(torch.stack([dist_l, lab_l.to(torch.float32)]), g_both)
        return full[0], full[1].to(torch.int32)

    def body(src_l, dst_l, w, seeds):
        dev = src_l.device
        st, gids = _init_block(seeds, off, nf)
        my_ghost = nf - min(max(n - off, 0), nf)  # this slice's vertices past n
        gsrc = src_l + r_idx * row_n  # global ids, for the tie-break
        if mode == "bucket":
            dlt = (np.float32(delta) if delta is not None
                   else delta_from_sums(all_reduce(weight_sums(w), SUM, g_both)))
        theta = np.float32(0.0)
        rec = _Round(telemetry_rounds, n_ranks, dev)
        it, work = 0, True
        while work and it < cap:
            # (dist, lab) of this row's vertex range: n/R on the wire
            rowst = all_gather_tiled(torch.stack([st.dist, st.lab.to(torch.float32)]), g_col)
            dsrc = rowst[0][src_l]
            lsrc = rowst[1].to(torch.int32)[src_l]
            del rowst
            cand = dsrc + w
            if mode == "bucket":
                cand = torch.where(dsrc <= float(theta), cand, INF)
            del dsrc
            # this rank's lexicographic segment min into the column range,
            # then the column-wide merge: three n/C MIN passes
            m, ml, ms = lex_pmin(*lex_segmin(cand, lsrc, gsrc, dst_l, col_n), g_row)
            m, ml, ms = m[col_pos:col_pos + nf], ml[col_pos:col_pos + nf], ms[col_pos:col_pos + nf]
            same = m == st.dist
            upd = torch.isfinite(m) & (
                (m < st.dist) | (same & (ml < st.lab)) | (same & (ml == st.lab) & (ms < st.pred)))
            st = VoronoiState(dist=torch.where(upd, m, st.dist), lab=torch.where(upd, ml, st.lab),
                              pred=torch.where(upd, ms, st.pred))
            # the slices are disjoint, so sums over the mesh are global
            imp_l = _count(upd)
            att = _count(torch.isfinite(cand))
            fin = torch.isfinite(st.dist)
            front_l = _count(fin & (st.dist <= float(theta))) if mode == "bucket" else imp_l
            unr_l = _count(~fin)
            imp, msg_g, front, unr = all_reduce(
                torch.stack([imp_l, att, front_l, unr_l]), SUM, g_both)
            rows = None
            if telemetry_per_rank:  # every channel is this rank's own
                rows = _rank_rows([front_l, att, imp_l, unr_l - my_ghost], g_both)
            rec.add(it, front, msg_g, imp, unr - n_ghost, rows)
            mx_l = torch.where(fin, st.dist, -INF).max()
            flag = all_reduce(torch.stack([(imp_l > 0).to(torch.float32), mx_l]), MAX, g_both)
            changed, max_fin = flag.tolist()  # the round's one host sync
            obs.host_read()
            if mode == "bucket":
                done = not changed and theta >= max_fin
                if not changed:
                    theta = np.float32(theta + dlt)
                work = not done
            else:
                work = bool(changed)
            it += 1
        gdst = ((dst_l // nf) * C + c_idx) * nf + dst_l % nf
        return _finish(st, gids, off, gsrc, gdst, w, S=S, mst_algo=mst_algo, pair_chunks=1,
                       gather_state=gather_both, g_state=g_both, g_all=g_both, iters=it,
                       rec=rec)

    return body


def run_dist_steiner_2d(mesh, part: Partition2D, seeds, *, device="cuda", **kw):
    """Host wrapper mirroring :func:`~repro_torch.core.dist_steiner.run_dist_steiner`:
    a thin shim over the ``"mesh2d"`` backend of :mod:`repro_torch.solver`."""
    from repro_torch.solver.config import SolverConfig
    from repro_torch.solver.registry import get_backend

    row_axis = kw.pop("row_axis", "data")
    col_axis = kw.pop("col_axis", "model")
    cfg = SolverConfig(backend="mesh2d", **kw)
    return get_backend("mesh2d").solve_prepared(
        cfg, mesh, part, np.asarray(seeds, np.int32), row_axis=row_axis, col_axis=col_axis,
        device=device,
    )
