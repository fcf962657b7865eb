"""Work-proportional delta re-solve: incremental ELL surgery + tree repair.

Counterpart of ``repro.delta.incremental``.  The warm-start loop
(:func:`~repro_torch.delta.resolve.reset_affected` feeding
``voronoi_cells_frontier(init=...)``) bounds relaxation work by the
affected region; this module also removes the two O(E) stages an epoch
would otherwise pay, the effective-CSR/ELL rebuild and the full distance
graph, so an epoch costs work in proportion to the change.

* :class:`EllPatcher`: in-place ELL row surgery.  Only the changed
  vertices' rows are refilled from the base CSR slices plus the overlay;
  spare padding rows (``ell_pad_rows``) absorb degree growth, so the
  device tensors keep their shape.
* :class:`IncrementalSession`: the epoch loop.  Patch the ELL, reset the
  affected cells, run warm frontier rounds, then repair the S² pair tables
  by recomputing only the rows of affected cells from edges incident to
  their members (a numpy host mirror of the distance graph), splice them
  into the cached tables, and redo the S-vertex MST and the tree walk on
  the device.  Every step keeps the cold pipeline's lexicographic
  tie-breaks and f32 rounding, so the repaired tree is bit-identical to a
  cold solve of the mutated store.

Soundness of the pair-table repair: let ``T`` be the touched set, every
vertex whose (dist, lab, pred) changed plus every delta-record endpoint.
A candidate bridge can appear, disappear or change value only if one of
its endpoints is in T.  So per pair: if the cached winner's endpoints are
outside T, the new entry is ``lexmin(cached, best T-incident candidate)``;
if one is inside T (a "dirty" pair), the pair's row cells are recomputed
exactly from every edge incident to their members, then the T-merge is
applied on top.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from repro_torch.core import tree as treemod
from repro_torch.core import voronoi as vmod
from repro_torch.core.graph import EllGraph
from repro_torch.core.steiner import mst_parent
from repro_torch.delta.log import append_deltas
from repro_torch.delta.resolve import reset_affected

IMAX = np.int32(np.iinfo(np.int32).max)


def effective_adjacency(
    store, verts: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Directed effective out-edges of ``verts``: host (src, dst, w).

    Base CSR slices are gathered per vertex and filtered/reweighted through
    the overlay; surviving added edges incident to ``verts`` are appended
    (both orientations).  O(deg(verts) + |adds|) work, never O(E).
    """
    verts = np.asarray(verts, np.int64)
    indptr = store.indptr
    starts = np.asarray(indptr[verts], np.int64)
    cnt = np.asarray(indptr[verts + 1], np.int64) - starts
    total = int(cnt.sum())
    if total:
        out_off = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        idx = (
            np.arange(total, dtype=np.int64)
            - np.repeat(out_off, cnt)
            + np.repeat(starts, cnt)
        )
        src = np.repeat(verts, cnt)
        dst = np.asarray(store.indices[idx], np.int64)
        w = np.asarray(store.weights[idx], np.float32)
    else:
        src = np.empty(0, np.int64)
        dst = np.empty(0, np.int64)
        w = np.empty(0, np.float32)
    ov = store.overlay
    if ov is not None:
        src, dst, w = ov.apply_base_chunk(src, dst, w)
        if ov.add_u.size:
            m1 = np.isin(ov.add_u, verts)
            m2 = np.isin(ov.add_v, verts)
            src = np.concatenate(
                [src, ov.add_u[m1].astype(np.int64), ov.add_v[m2].astype(np.int64)]
            )
            dst = np.concatenate(
                [dst, ov.add_v[m1].astype(np.int64), ov.add_u[m2].astype(np.int64)]
            )
            w = np.concatenate([w, ov.add_w[m1], ov.add_w[m2]]).astype(np.float32)
    return src, dst, w


class EllPatcher:
    """In-place ELL row maintenance for a delta-mutated store.

    Owns the row layout the ELL was built with (``row_off`` from the
    prepare-time effective CSR) and the bookkeeping of which padding rows
    are still free: padding rows alias ``row2v == 0``, so they cannot be
    found from the :class:`EllGraph` alone.  Each :meth:`apply` refills
    exactly the changed vertices' rows (claiming spare rows when a vertex
    outgrows its block) with one ``index_copy_`` a tensor, keeping shape.

    Ownership: the patch writes into the ELL's tensors.  Pass
    ``owns_buffers=True`` only when the view is private to this patcher;
    for a shared view (e.g. the memoized ``ell_view_cached``) the default
    takes one private copy before the first patch, so the caller's view
    survives.
    """

    def __init__(self, ell: EllGraph, indptr: np.ndarray, *, owns_buffers: bool = False):
        self.ell = ell
        self._owned = bool(owns_buffers)
        k = int(ell.nbr.shape[1])
        self.k = k
        counts = np.diff(np.asarray(indptr, np.int64))
        rows_per_v = np.maximum(1, -(-counts // k))
        self.row_off = np.zeros(counts.size + 1, np.int64)
        np.cumsum(rows_per_v, out=self.row_off[1:])
        self._free_next = int(self.row_off[-1])
        self._padded = int(ell.nbr.shape[0])
        self._extra: Dict[int, List[int]] = {}

    @property
    def free_rows(self) -> int:
        """Spare padding rows still claimable for degree growth."""
        return self._padded - self._free_next

    def apply(self, store, changed: np.ndarray) -> EllGraph:
        """Refills the ELL rows of ``changed`` vertices from the store's
        current effective adjacency; returns the patched (same-shape)
        :class:`EllGraph`, a new object (so memoized views of the old one
        are not reused), and retains it as ``self.ell``.

        Raises:
          RuntimeError: a vertex outgrew its rows and no padding rows are
            left (``ell_pad_rows`` too small for the accumulated deltas).
        """
        changed = np.unique(np.asarray(changed, np.int64))
        if changed.size == 0:
            return self.ell
        src, dst, w = effective_adjacency(store, changed)
        order = np.argsort(src, kind="stable")
        src, dst, w = src[order], dst[order], w[order]
        bounds = np.searchsorted(src, changed)
        bounds = np.append(bounds, src.size)

        k = self.k
        all_rows: List[np.ndarray] = []
        nbr_blk: List[np.ndarray] = []
        wgt_blk: List[np.ndarray] = []
        v_of_blk: List[np.ndarray] = []
        for i, v in enumerate(changed):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            deg = hi - lo
            vi = int(v)
            rows = list(range(int(self.row_off[vi]), int(self.row_off[vi + 1])))
            rows += self._extra.get(vi, [])
            need = max(1, -(-deg // k))
            while len(rows) < need:
                if self._free_next >= self._padded:
                    raise RuntimeError(
                        f"ELL padding exhausted patching vertex {vi} "
                        f"(needs {need} rows, {len(rows)} assigned, 0 free); "
                        f"re-prepare from the store, or raise "
                        f"SolverConfig.ell_pad_rows"
                    )
                self._extra.setdefault(vi, []).append(self._free_next)
                rows.append(self._free_next)
                self._free_next += 1
            r = len(rows)
            nb = np.zeros(r * k, np.int32)
            wg = np.full(r * k, np.inf, np.float32)
            nb[:deg] = dst[lo:hi]
            wg[:deg] = w[lo:hi]
            all_rows.append(np.asarray(rows, np.int64))
            nbr_blk.append(nb.reshape(r, k))
            wgt_blk.append(wg.reshape(r, k))
            v_of_blk.append(np.full(r, vi, np.int32))

        ell = self.ell
        dev = ell.nbr.device
        nbr, wgt, row2v = ell.nbr, ell.wgt, ell.row2v
        if not self._owned:
            # the first patch would overwrite tensors an outside holder may
            # still read: copy once, then patch in place epoch over epoch
            nbr, wgt, row2v = nbr.clone(), wgt.clone(), row2v.clone()
            self._owned = True
        # every row appears once, so the copies are deterministic
        rows = torch.from_numpy(np.concatenate(all_rows)).to(dev)
        nbr.index_copy_(0, rows, torch.from_numpy(np.concatenate(nbr_blk)).to(dev))
        wgt.index_copy_(0, rows, torch.from_numpy(np.concatenate(wgt_blk)).to(dev))
        row2v.index_copy_(0, rows, torch.from_numpy(np.concatenate(v_of_blk)).to(dev))
        self.ell = EllGraph(nbr=nbr, wgt=wgt, row2v=row2v, n=ell.n)
        return self.ell


@dataclasses.dataclass
class EpochResult:
    """Outcome of one :meth:`IncrementalSession.resolve` epoch."""

    epoch: int
    total_distance: float
    num_edges: int
    changed_vertices: int
    affected_cells: int
    vertices_reset: int
    cells_recomputed: int
    member_vertices: int
    iterations: int
    relaxations: int
    messages: int


class IncrementalSession:
    """Epoch-incremental Steiner re-solve over a mutating ``GraphStore``.

    Holds the converged solve of the current epoch (state on ``device``,
    S² pair tables on the host, MST parent, totals) and a patchable
    resident ELL.  Each :meth:`resolve` advances to the store's current
    epoch doing work in proportion to the delta: ELL row surgery,
    affected-cell warm frontier rounds, and a spliced pair-table / MST /
    walk repair, bit-identical to a cold ``mode="frontier"`` solve of the
    mutated store.  Construction is a cold solve plus one O(E) pair
    reduction to seed the tables.
    """

    def __init__(
        self,
        store,
        seeds,
        *,
        ell_width: int = 32,
        ell_pad_rows: int = 1,
        frontier_size: int = 1024,
        mst_algo: str = "prim",
        device="cuda",
    ):
        if mst_algo not in ("prim", "boruvka"):
            raise ValueError(f"unknown mst_algo: {mst_algo!r}")
        self.store = store
        self.frontier_size = frontier_size
        self.mst_algo = mst_algo
        self.device = torch.device(device)
        seeds = store.map_ids(np.asarray(seeds)).astype(np.int64)
        self.seeds = seeds
        self.S = int(seeds.shape[0])
        self._seeds_t = torch.as_tensor(seeds, dtype=torch.int32, device=self.device)

        if store.overlay is None:
            indptr = np.asarray(store.indptr)
        else:
            indptr = store.effective_csr()[0]
        # store.ell() builds fresh tensors on every call, so the session is
        # their sole holder and the patcher may write them in place
        ell = store.ell(ell_width, pad_rows_to=ell_pad_rows, device=self.device)
        self.patcher = EllPatcher(ell, indptr, owns_buffers=True)

        st, stats = vmod.voronoi_cells_frontier(ell, self._seeds_t, frontier_size=frontier_size)
        self.state = st
        self._finish_cold(st)
        self.last = EpochResult(
            epoch=int(store.epoch),
            total_distance=self.total_distance,
            num_edges=self.num_edges,
            changed_vertices=0,
            affected_cells=0,
            vertices_reset=0,
            cells_recomputed=self.S,
            member_vertices=int(st.dist.shape[0]),
            iterations=int(stats.iterations),
            relaxations=int(stats.relaxations),
            messages=int(stats.messages),
        )

    # ------------------------------------------------------------------
    # cold bootstrap: one full pair reduction to seed the cached tables
    # ------------------------------------------------------------------

    def _finish_cold(self, st) -> None:
        dist, lab = st.dist.cpu().numpy(), st.lab.cpu().numpy()
        verts = np.arange(dist.shape[0], dtype=np.int64)
        src, dst, w = effective_adjacency(self.store, verts)
        self.dmat, self.umat, self.vmat = self._pair_rows(src, dst, w, dist, lab)
        self._finish(st)

    # ------------------------------------------------------------------
    # host mirror of core.distance_graph.distance_graph
    # ------------------------------------------------------------------

    def _pair_rows(
        self, src, dst, w, dist: np.ndarray, lab: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Three-pass lexicographic (d', u, v) reduction in numpy, with the
        distance graph's rounding: f32 ``(dist[u] + w) + dist[v]``
        candidates, exact-min passes, canonical bridge orientation (u in
        the lower seed's cell).  ``dist``/``lab`` are host arrays."""
        S = self.S
        ls, ld = lab[src], lab[dst]
        cross = (ls != ld) & (ls < S) & (ld < S) & np.isfinite(w)
        src, dst, w, ls, ld = src[cross], dst[cross], w[cross], ls[cross], ld[cross]
        d = (dist[src] + w) + dist[dst]
        key = np.minimum(ls, ld).astype(np.int64) * S + np.maximum(ls, ld)
        lower_first = ls < ld
        cu = np.where(lower_first, src, dst)
        cv = np.where(lower_first, dst, src)

        dmat = np.full(S * S, np.inf, np.float32)
        np.minimum.at(dmat, key, d)
        e1 = d == dmat[key]
        umat = np.full(S * S, IMAX, np.int64)
        np.minimum.at(umat, key[e1], cu[e1])
        e2 = e1 & (cu == umat[key])
        vmat = np.full(S * S, IMAX, np.int64)
        np.minimum.at(vmat, key[e2], cv[e2])
        return dmat, umat.astype(np.int32), vmat.astype(np.int32)

    # ------------------------------------------------------------------
    # MST + bridge pruning + predecessor walk, on the device
    # ------------------------------------------------------------------

    def _finish(self, st) -> None:
        """The cold pipeline's tail from the repaired tables
        (:func:`repro_torch.core.steiner.finish_pipeline` less the O(E)
        distance graph, which the caller repaired instead)."""
        S, dev = self.S, self.device
        dmat, umat, vmat = (torch.from_numpy(x).to(dev) for x in (self.dmat, self.umat, self.vmat))
        parent = mst_parent(dmat, S, self.mst_algo)
        tree = treemod.extract_tree(st.dist.shape[0], st, dmat, umat, vmat, parent, S)
        self.parent = parent.cpu().numpy()
        self.total_distance = float(tree.total_distance)
        self.num_edges = int(tree.num_edges)

    # ------------------------------------------------------------------
    # the epoch step
    # ------------------------------------------------------------------

    def apply_deltas(self, records: Iterable[tuple]) -> EpochResult:
        """Appends ``records`` to the store's delta log, reloads, and
        re-solves incrementally (``append_deltas`` + :meth:`resolve`)."""
        records = list(records)
        append_deltas(self.store, records)
        self.store.reload()
        changed = np.unique(
            np.asarray([r[1] for r in records] + [r[2] for r in records], np.int64)
        )
        return self.resolve(self.store.map_ids(changed))

    def resolve(self, changed: np.ndarray) -> EpochResult:
        """Advances the session to the store's current epoch given the
        (stored-id) vertices its new delta records touch."""
        changed = np.unique(np.asarray(changed, np.int64))
        old = self.state
        old_dist, old_lab, old_pred = (x.cpu().numpy() for x in (old.dist, old.lab, old.pred))

        ell = self.patcher.apply(self.store, changed)
        warm0, cells, n_reset = reset_affected(old, self.seeds, changed, self.S)
        st, stats = vmod.voronoi_cells_frontier(
            ell, self._seeds_t, frontier_size=self.frontier_size, init=warm0
        )
        new_dist, new_lab, new_pred = (x.cpu().numpy() for x in (st.dist, st.lab, st.pred))
        self.state = st

        S = self.S
        diffv = np.nonzero(
            (old_dist != new_dist) | (old_lab != new_lab) | (old_pred != new_pred)
        )[0]
        touched = np.union1d(diffv, changed)
        members = np.empty(0, np.int64)
        C = np.empty(0, np.int64)
        if touched.size:
            # pair table of every candidate that could have appeared or
            # changed value: edges incident to a touched vertex
            srcT, dstT, wT = effective_adjacency(self.store, touched)
            dT, uT, vT = self._pair_rows(srcT, dstT, wT, new_dist, new_lab)

            # dirty pairs: the cached winner's bridge touches T, so the
            # runner-up among unchanged candidates (never cached) may now
            # win: recompute those pairs' row cells exactly
            inT = np.zeros(new_lab.shape[0], bool)
            inT[touched] = True
            fk = np.nonzero(np.isfinite(self.dmat))[0]
            dirty = fk[inT[self.umat[fk]] | inT[self.vmat[fk]]]
            # every s-t cross edge has an endpoint in EACH cell, so one
            # covered side per dirty pair suffices: take the smaller cell
            ds, dt = dirty // S, dirty % S
            csize = np.bincount(new_lab[new_lab < S], minlength=S)
            C = np.unique(np.where(csize[ds] <= csize[dt], ds, dt))
            if C.size:
                members = np.nonzero(np.isin(new_lab, C))[0].astype(np.int64)
                srcC, dstC, wC = effective_adjacency(self.store, members)
                dk, uk, vk = self._pair_rows(srcC, dstC, wC, new_dist, new_lab)
                inC = np.zeros(S, bool)
                inC[C] = True
                grid = (inC[:, None] | inC[None, :]).reshape(-1)
                self.dmat[grid] = dk[grid]
                self.umat[grid] = uk[grid]
                self.vmat[grid] = vk[grid]

            # two-way lexicographic merge of the T-incident candidates into
            # every entry (idempotent on the recomputed grid)
            better = (dT < self.dmat) | (
                (dT == self.dmat)
                & ((uT < self.umat) | ((uT == self.umat) & (vT < self.vmat)))
            )
            self.dmat[better] = dT[better]
            self.umat[better] = uT[better]
            self.vmat[better] = vT[better]
        self._finish(st)

        self.last = EpochResult(
            epoch=int(self.store.epoch),
            total_distance=self.total_distance,
            num_edges=self.num_edges,
            changed_vertices=int(changed.size),
            affected_cells=int(cells.size),
            vertices_reset=int(n_reset),
            cells_recomputed=int(C.size),
            member_vertices=int(members.size),
            iterations=int(stats.iterations),
            relaxations=int(stats.relaxations),
            messages=int(stats.messages),
        )
        return self.last
