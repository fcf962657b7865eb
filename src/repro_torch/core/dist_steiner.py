"""Distributed Steiner tree: the paper's Alg. 3 over ``torch.distributed``.

The counterpart of ``repro.core.dist_steiner``, which runs the paper's MPI
design under ``shard_map`` on a JAX device mesh.  Here it runs SPMD, one
process a mesh position (:mod:`repro_torch.core.mesh`):

  paper (HavoqGT / MPI)                    this module
  ---------------------------------------  ---------------------------------
  graph partitions, ~equal vertices/rank   1D partition: vertex blocks over
                                           the "model" axis; edges bucketed
                                           by dst-block and dealt over the
                                           replica axes ("pod", "data")
  async vertex-centric visitors            bulk-synchronous rounds, with
                                           ``local_steps`` collective-free
                                           local rounds a global exchange
  priority message queue                   Δ-bucketed thresholding, or
                                           mode="frontier": per-rank top-K
                                           dirty rows of a sharded ELL view
  MPI_Allreduce(MPI_MIN) on E_N distances  all_reduce(MIN) on the S² pair
                                           table, then two more passes on
                                           the endpoint ids
  replicated sequential MST (Boost Prim)   replicated dense Prim / Borůvka
  TREE_EDGE_ASYNC pred-walk                pointer doubling over a gathered
                                           pred vector
  chunked collectives for |S|=10K (§V-F)   ``pair_chunks``

Each rank holds its vertex block (nb,) of (dist, lab, pred), replicated
across the replica axes, and its edge shard (eb,).  A round is one
all-gather of (dist, lab) over "model", the three lexicographic MIN passes
over the replica axes, and a few scalar reductions; the reference's
``lax.while_loop`` is a host loop with one host sync a round.

Counters are exact: each round's counts are summed across ranks in int64
and rounded once to f32, then carried in f32 as the reference carries them
(its f32 psums are exact below 2**24).  The bucket width Δ is the exact
mean over every shard's finite weights, rounded once
(:func:`repro_torch.core.voronoi.delta_from_sums`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import mesh as meshmod
from repro_torch.knobs import sync_free
from repro_torch.core.distance_graph import edge_pair_tables
from repro_torch.core.mesh import IMAX, MAX, SUM, all_gather, all_gather_tiled, all_reduce, lex_pmin
from repro_torch.core.steiner import mst_parent
from repro_torch.core.tree import bridge_endpoints
from repro_torch.core.voronoi import (
    VoronoiState,
    _hist_write,
    delta_from_sums,
    lex_segmin,
    lex_update,
    smallest_k,
    weight_sums,
)

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class Partition:
    """Host-side partitioning result (numpy; placement by the caller).

    Flat edge arrays have length ``n_replica * n_blocks * eb`` laid out
    replica-major, so rank ``r * n_blocks + b`` (replica r, vertex column
    b) holds the slice ``[rank * eb, (rank + 1) * eb)``.
    """

    src: np.ndarray
    dst: np.ndarray
    w: np.ndarray
    n: int  # true vertex count
    nb: int  # vertex block size (padded)
    eb: int  # edges per device (padded)
    n_blocks: int
    n_replica: int

    @property
    def npad(self) -> int:
        return self.nb * self.n_blocks


def partition_edges(
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    n: int,
    *,
    n_replica: int,
    n_blocks: int,
    symmetrize: bool = True,
    block_multiple: int = 8,
) -> Partition:
    """1D dst-block edge partition (paper §IV scale-out design).

    Every directed edge goes to the vertex column owning its destination
    block; edges within a block are dealt round-robin across replicas.
    Padding edges are ``(0, block_base, +inf)``, inert under min-plus.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(w, np.float32)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    nb = -(-n // n_blocks)
    nb = -(-nb // block_multiple) * block_multiple
    blk = dst // nb
    order = np.argsort(blk, kind="stable")
    src, dst, w, blk = src[order], dst[order], w[order], blk[order]
    counts = np.bincount(blk, minlength=n_blocks)
    # round-robin replica assignment within each block
    within = np.arange(len(src)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
    )
    rep = within % n_replica
    per_bucket = np.zeros((n_replica, n_blocks), np.int64)
    for b in range(n_blocks):
        c = counts[b]
        per_bucket[:, b] = c // n_replica + (np.arange(n_replica) < c % n_replica)
    eb = max(1, int(per_bucket.max()))
    eb = -(-eb // block_multiple) * block_multiple
    osrc = np.zeros((n_replica, n_blocks, eb), np.int32)
    odst = np.zeros((n_replica, n_blocks, eb), np.int32)
    ow = np.full((n_replica, n_blocks, eb), np.inf, np.float32)
    for b in range(n_blocks):
        odst[:, b, :] = b * nb  # padding dst = block base (local id 0)
    bucket_key = rep * n_blocks + blk
    korder = np.argsort(bucket_key, kind="stable")
    ks, kd, kw, kk = src[korder], dst[korder], w[korder], bucket_key[korder]
    uniq, starts = np.unique(kk, return_index=True)
    ends = np.r_[starts[1:], len(kk)]
    for u, s0, s1 in zip(uniq, starts, ends):
        r, b = divmod(int(u), n_blocks)
        c = s1 - s0
        osrc[r, b, :c] = ks[s0:s1]
        odst[r, b, :c] = kd[s0:s1]
        ow[r, b, :c] = kw[s0:s1]
    return Partition(
        src=osrc.reshape(-1),
        dst=odst.reshape(-1),
        w=ow.reshape(-1),
        n=n,
        nb=nb,
        eb=eb,
        n_blocks=n_blocks,
        n_replica=n_replica,
    )


@dataclasses.dataclass(frozen=True)
class EllPartition:
    """Host-side 1D-sharded ELL view (numpy; placement by the caller).

    ELL rows (see :class:`repro_torch.core.graph.EllGraph`) are bucketed by
    the vertex block owning their *source* vertex and dealt round-robin
    across replicas within the block, as :class:`Partition` deals edges.
    Flat arrays have leading length ``n_replica * n_blocks * rb``,
    replica-major.  Padding rows alias the block base vertex (``b * nb``)
    with all-``+inf`` weights: they can never enter a frontier.
    """

    nbr: np.ndarray  # (n_replica * n_blocks * rb, k) int32 neighbor ids
    wgt: np.ndarray  # (n_replica * n_blocks * rb, k) f32; +inf padding
    row2v: np.ndarray  # (n_replica * n_blocks * rb,) int32 owning vertex
    n: int  # true vertex count
    nb: int  # vertex block size (padded)
    rb: int  # ELL rows per device (padded)
    k: int  # ELL row width
    n_blocks: int
    n_replica: int

    @property
    def npad(self) -> int:
        return self.nb * self.n_blocks

    @classmethod
    def from_buckets(cls, nbr, wgt, row2v, *, n: int, nb: int):
        """Flattens filled (R, B, rb[, k]) bucket arrays (see
        :func:`ell_bucket_arrays`) into the device layout."""
        R, B, rb, k = nbr.shape
        return cls(
            nbr=nbr.reshape(-1, k),
            wgt=wgt.reshape(-1, k),
            row2v=row2v.reshape(-1),
            n=n,
            nb=nb,
            rb=rb,
            k=k,
            n_blocks=B,
            n_replica=R,
        )


def ell_bucket_arrays(counts: np.ndarray, k: int, nb: int, block_multiple: int = 8):
    """Allocates the padded per-bucket ELL arrays, plus ``rb``.

    The one source of the shard geometry (``rb`` rounding, ``+inf`` weight
    padding, padding rows aliasing the block base vertex), shared by
    :func:`partition_ell` and the disk loader
    (:func:`repro_torch.graphstore.partition.load_partition_ell`), whose
    outputs must agree bit for bit.
    """
    R, B = counts.shape
    rb = max(1, int(counts.max()))
    rb = -(-rb // block_multiple) * block_multiple
    nbr = np.zeros((R, B, rb, k), np.int32)
    wgt = np.full((R, B, rb, k), np.inf, np.float32)
    row2v = np.zeros((R, B, rb), np.int32)
    for b in range(B):
        row2v[:, b, :] = b * nb  # padding rows alias the block base
    return nbr, wgt, row2v, rb


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def partition_ell(
    ell,
    *,
    n_replica: int,
    n_blocks: int,
    block_multiple: int = 8,
) -> EllPartition:
    """Shards a global ELL view (host or device) by source vertex block.

    Every ELL row goes to the vertex column owning its source block
    (``row2v // nb``); rows within a block are dealt round-robin across
    replicas in global row order, so the shards equal what
    :func:`repro_torch.graphstore.partition.partition_ell_store` streams to
    disk from the same CSR.
    """
    nbr = _host(ell.nbr)
    wgt = _host(ell.wgt)
    row2v = _host(ell.row2v).astype(np.int64)
    n = ell.n
    k = nbr.shape[1]
    nb = -(-n // n_blocks)
    nb = -(-nb // block_multiple) * block_multiple
    blk = row2v // nb
    # within-block rank in global row order -> round-robin replica
    order = np.argsort(blk, kind="stable")
    bs = blk[order]
    run_start = np.r_[0, np.flatnonzero(bs[1:] != bs[:-1]) + 1]
    run_len = np.diff(np.r_[run_start, bs.shape[0]])
    within = np.empty(blk.shape[0], np.int64)
    within[order] = np.arange(bs.shape[0]) - np.repeat(run_start, run_len)
    rep = within % n_replica
    counts = np.zeros((n_replica, n_blocks), np.int64)
    np.add.at(counts, (rep, blk), 1)
    onbr, owgt, orow, _ = ell_bucket_arrays(counts, k, nb, block_multiple)
    bucket_key = rep * n_blocks + blk
    korder = np.argsort(bucket_key, kind="stable")  # ascending row order
    kk = bucket_key[korder]
    uniq, starts = np.unique(kk, return_index=True)
    ends = np.r_[starts[1:], len(kk)]
    for u, s0, s1 in zip(uniq, starts, ends):
        r, b = divmod(int(u), n_blocks)
        rows = korder[s0:s1]
        c = len(rows)
        onbr[r, b, :c] = nbr[rows]
        owgt[r, b, :c] = wgt[rows]
        orow[r, b, :c] = row2v[rows]
    return EllPartition.from_buckets(onbr, owgt, orow, n=n, nb=nb)


# ----------------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DistSteinerConfig:
    """Static configuration of the distributed pipeline.

    Wire-format knobs are validated here, eagerly: ``lab_i16`` gathers
    labels as int16, which holds every label in [0, S] only while
    ``S < 32768``; ``fuse_gather`` rides labels on an f32 all-gather,
    exact only while ``S < 2**24``.
    """

    n: int
    nb: int
    num_seeds: int
    mode: str = "bucket"  # "dense" | "bucket" | "frontier"
    mst_algo: str = "prim"  # "prim" | "boruvka"
    local_steps: int = 1  # >1: collective-free local rounds a global round
    pair_chunks: int = 1  # paper §V-F chunked Allreduce on the S² table
    max_iters: Optional[int] = None
    delta: Optional[float] = None
    fuse_gather: bool = True  # one fused (dist, lab) all-gather
    lab_i16: bool = False  # gather labels as int16 (S < 32768): 6 B/vertex
    frontier_size: int = 1024  # top-K dirty rows per rank (mode="frontier")
    # H of the (H+1, 4) per-round telemetry buffer (global counts)
    telemetry_rounds: int = 0
    # also carry an (H+1, n_ranks, 4) per-rank buffer (obs.flight)
    telemetry_per_rank: bool = False

    def __post_init__(self) -> None:
        if self.mode not in ("dense", "bucket", "frontier"):
            raise ValueError(
                f"unknown mode: {self.mode!r} "
                f"(use 'dense' | 'bucket' | 'frontier')"
            )
        if self.lab_i16 and self.num_seeds >= 32768:
            raise ValueError(
                f"lab_i16 gathers labels as int16, which requires "
                f"|S| < 32768; got num_seeds={self.num_seeds}"
            )
        if self.fuse_gather and not self.lab_i16 and self.num_seeds >= 2**24:
            raise ValueError(
                f"fuse_gather packs labels into an f32 all-gather, exact "
                f"only for |S| < 2**24; got num_seeds={self.num_seeds} — "
                f"use fuse_gather=False (or lab_i16 for |S| < 32768)"
            )
        if self.mode == "frontier" and self.local_steps != 1:
            raise ValueError(
                f"local_steps > 1 is not supported with mode='frontier' "
                f"(the top-K candidates must cross devices every round); "
                f"got local_steps={self.local_steps}"
            )
        if self.frontier_size < 1:
            raise ValueError(
                f"frontier_size must be >= 1, got {self.frontier_size}"
            )
        if self.telemetry_rounds < 0:
            raise ValueError(
                f"telemetry_rounds must be >= 0, got {self.telemetry_rounds}"
            )
        if self.telemetry_per_rank and self.telemetry_rounds < 1:
            raise ValueError(
                "telemetry_per_rank requires telemetry_rounds >= 1 "
                "(the per-rank flight recorder rides the round buffer)"
            )


def _count(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dtype=torch.int64)


class _Round:
    """The round counters and telemetry buffers of one fixpoint loop."""

    def __init__(self, H: int, n_ranks: int, dev):
        self.rlx = torch.zeros((), dtype=torch.float32, device=dev)
        self.msg = torch.zeros((), dtype=torch.float32, device=dev)
        self.hist = torch.zeros((H + 1, 4), dtype=torch.float32, device=dev)
        self.histr = torch.zeros((H + 1, n_ranks, 4), dtype=torch.float32, device=dev)

    def add(self, it: int, front, msg, imp, unr, rank_rows=None) -> None:
        """Records round ``it``: exact int64 counts, each rounded once to
        f32; ``rank_rows`` is the (n_ranks, 4) per-rank row or None."""
        self.rlx += imp.to(torch.float32)
        self.msg += msg.to(torch.float32)
        _hist_write(self.hist, it, torch.stack([front, msg, imp, unr]).to(torch.float32))
        if rank_rows is not None:
            self.histr[min(it, self.histr.shape[0] - 1)] = rank_rows

    def stats(self, iters: int) -> torch.Tensor:
        it = torch.tensor(float(iters), dtype=torch.float32, device=self.rlx.device)
        return torch.stack([it, self.rlx, self.msg])


def _rank_rows(row, group) -> torch.Tensor:
    """This rank's (4,) int64 channel row gathered from every rank of
    ``group`` in rank order: (n_ranks, 4) f32."""
    return all_gather(torch.stack(row).to(torch.float32), group)


def _init_block(seeds: torch.Tensor, off: int, nb: int):
    """Paper Alg. 3 INITIALIZATION of the (nb,) block starting at vertex
    ``off``.  The scatters take the ``min``, so a vertex listed at several
    seed indices is owned by the lowest one (duplicates are inert).
    Returns (state, gids)."""
    dev, S = seeds.device, seeds.shape[0]
    inblk = (seeds >= off) & (seeds < off + nb)
    tgt = torch.where(inblk, seeds - off, nb).long()
    dist = torch.full((nb + 1,), INF, dtype=torch.float32, device=dev)
    dist.scatter_reduce_(0, tgt, torch.zeros(S, dtype=torch.float32, device=dev), "amin")
    lab = torch.full((nb + 1,), S, dtype=torch.int32, device=dev)
    lab.scatter_reduce_(0, tgt, torch.arange(S, dtype=torch.int32, device=dev), "amin")
    gids = torch.arange(nb, dtype=torch.int32, device=dev) + off
    return VoronoiState(dist=dist[:nb], lab=lab[:nb], pred=gids), gids


def _finish(st, gids, off, esrc, edst, ew, *, S, mst_algo, pair_chunks, gather_state,
            g_state, g_all, iters, rec):
    """Stages 2-6 after the fixpoint (shared by every mode and both
    engines): pair tables -> Allreduce(MIN) over ``g_all`` -> replicated
    MST -> bridge pruning -> pred-walk marking by pointer doubling.

    ``st`` is this rank's block from vertex ``off``; ``(esrc, edst, ew)``
    its shard's directed edges in global ids (+inf weights are inert);
    ``gather_state`` gathers (dist, lab) of every vertex; ``g_state`` is
    the group whose blocks tile the vertices (vertex arrays are gathered
    and summed over it).  Returns the 14 outputs of the pipeline.
    """
    nb = st.dist.shape[0]
    distf, labf = gather_state(st.dist, st.lab)
    dmat, umat, vmat = lex_pmin(*edge_pair_tables(esrc, edst, ew, distf, labf, S),
                                g_all, chunks=pair_chunks)
    del labf
    parent = mst_parent(dmat, S, mst_algo)
    bu, bv, bw, bvalid = bridge_endpoints(dmat, umat, vmat, distf, parent, S)
    ptr = all_gather_tiled(st.pred, g_state)  # every vertex's pred
    marked = torch.zeros(nb + 1, dtype=torch.bool, device=st.dist.device)
    for b in (bu, bv):
        mine = bvalid & (b >= off) & (b < off + nb)
        marked[torch.where(mine, b - off, nb).long()] = True
    marked = marked[:nb]
    while True:  # one flag a round
        markedf = all_gather_tiled(marked, g_state)
        t = ptr - off
        hit = markedf & (t >= 0) & (t < nb)
        new = marked.clone()
        new[t[hit].long()] = True
        ch = all_reduce(_count(new != marked)[None], MAX, g_all)
        marked, ptr = new, ptr[ptr.long()]
        done = not int(ch)
        obs.host_read(2)  # the masked gather and the flag
        if done:
            break
    path_edge = marked & (st.pred != gids)
    path_w = torch.where(path_edge, st.dist - distf[st.pred.long()], 0.0)
    total = all_reduce(path_w.sum()[None], SUM, g_state)[0] + bw.sum()
    nedges = all_reduce(_count(path_edge)[None], SUM, g_state)[0] + _count(bvalid)
    full = [all_gather_tiled(x, g_state) for x in (st.dist, st.lab, st.pred, marked, path_edge)]
    return (*full, bu, bv, bw, bvalid, total, nedges.to(torch.int32), rec.stats(iters),
            rec.hist, rec.histr)


@dataclasses.dataclass
class _Loop:
    """The carry of one fixpoint loop: this rank's block, its counters,
    the shard's per-call views, and what the host loop reads or keeps."""

    st: VoronoiState
    gids: torch.Tensor
    rec: _Round
    views: tuple
    dirty: Optional[torch.Tensor] = None  # frontier: rows still to pop
    wsums: Optional[torch.Tensor] = None  # bucket: weight sums over every rank
    theta: np.float32 = np.float32(0.0)  # bucket: the host's threshold


@dataclasses.dataclass(frozen=True)
class DistRounds:
    """The fixpoint of :func:`make_dist_steiner` apart from its host loop.

    ``init(*shard, seeds)`` builds the loop's carry (:class:`_Loop`) and
    ``round(loop, it)`` runs round ``it``, advancing ``loop`` and returning
    the flag tensor that the host loop reads (its one host sync a round);
    neither reads a tensor on the host, so both run on fake tensors
    (``launch/dryrun.py`` runs init and one round).  In mode "bucket" the
    host sets ``loop.theta`` between rounds from Δ, which the real path
    reads from ``loop.wsums`` (:func:`delta_from_sums`) unless the config
    fixes it.
    """

    init: Callable
    round: Callable


def make_dist_steiner(
    mesh: meshmod.Mesh,
    cfg: DistSteinerConfig,
    *,
    vert_axis: str = "model",
    replica_axes: Sequence[str] = ("data",),
):
    """Builds this rank's part of the distributed Steiner pipeline.

    For ``mode="dense"``/``"bucket"`` returns ``fn(src, dst, w, seeds) ->
    (dist, lab, pred, marked, path_edge, bu, bv, bw, bvalid, total,
    num_edges, stats, hist, histr)`` where ``(src, dst, w)`` is this rank's
    shard of the :class:`Partition` layout on its device; for
    ``mode="frontier"`` ``fn(nbr, wgt, row2v, seeds)`` over its shard of the
    :class:`EllPartition` layout.  Every rank returns the same outputs: the
    vertex arrays gathered to (npad,), the rest replicated.
    """
    return _build(mesh, cfg, vert_axis, tuple(replica_axes))[0]


def make_dist_rounds(
    mesh: meshmod.Mesh,
    cfg: DistSteinerConfig,
    *,
    vert_axis: str = "model",
    replica_axes: Sequence[str] = ("data",),
) -> DistRounds:
    """The init and the round of :func:`make_dist_steiner`'s fixpoint, over
    the same shard arguments (:class:`DistRounds`)."""
    return _build(mesh, cfg, vert_axis, tuple(replica_axes))[1]


def _build(mesh: meshmod.Mesh, cfg: DistSteinerConfig, vert_axis: str, replica_axes: tuple):
    all_axes = replica_axes + (vert_axis,)
    S, nb = cfg.num_seeds, cfg.nb
    n_blocks = mesh.shape[vert_axis]
    npad = nb * n_blocks
    # frontier advances <= K rows/device/round: allow proportionally more
    # rounds before the safety cap (matching voronoi_cells_frontier)
    default_cap = (16 if cfg.mode == "frontier" else 4) * cfg.n + 64
    cap = cfg.max_iters if cfg.max_iters is not None else default_cap
    cap = min(cap, 2**31 - 2)
    g_vert = mesh.group((vert_axis,))
    g_rep = mesh.group(replica_axes) if replica_axes else None
    g_all = mesh.group(all_axes)
    my_blk = mesh.coords[vert_axis]
    off = my_blk * nb
    is_r0 = all(mesh.coords[a] == 0 for a in replica_axes)
    n_ghost = npad - cfg.n  # phantom padding vertices, never reached
    my_ghost = nb - min(max(cfg.n - off, 0), nb)  # those of this block
    per_rank = cfg.telemetry_per_rank
    n_ranks = mesh.axis_size(all_axes) if per_rank else 0
    H = cfg.telemetry_rounds

    def gather_state(dist_l, lab_l):
        """All-gather (dist, lab) along the vertex axis: one fused f32
        gather (labels exact below 2**24), or labels as int16 (their bytes
        on the wire), or two gathers."""
        if cfg.lab_i16:
            distf = all_gather_tiled(dist_l, g_vert)
            lab16 = all_gather_tiled(lab_l.to(torch.int16), g_vert)
            return distf, lab16.to(torch.int32)
        if cfg.fuse_gather:
            full = all_gather_tiled(torch.stack([dist_l, lab_l.to(torch.float32)]), g_vert)
            return full[0], full[1].to(torch.int32)
        return all_gather_tiled(dist_l, g_vert), all_gather_tiled(lab_l, g_vert)

    def r0(x):
        """A block channel: counted on the replica-0 rank only, so the
        per-rank rows sum exactly to the global channels."""
        return x if is_r0 else torch.zeros_like(x)

    def finish(st, esrc, edst, ew, gids, iters, rec):
        return _finish(st, gids, off, esrc, edst, ew, S=S, mst_algo=cfg.mst_algo,
                       pair_chunks=cfg.pair_chunks, gather_state=gather_state,
                       g_state=g_vert, g_all=g_all, iters=iters, rec=rec)

    @sync_free
    def edge_init(src, dst, w, seeds):
        st, gids = _init_block(seeds, off, nb)
        ldst = dst - off  # the partitioner puts every dst in this block
        sin = (src >= off) & (src < off + nb)
        lsrc = torch.clamp(src - off, 0, nb - 1)
        wsums = None
        if cfg.mode == "bucket" and cfg.delta is None:
            wsums = all_reduce(weight_sums(w), SUM, g_all)
        return _Loop(st, gids, _Round(H, n_ranks, src.device), (src, w, ldst, sin, lsrc),
                     wsums=wsums)

    @sync_free(static=("it",))
    def edge_round(loop, it):
        """One global round of modes "dense" and "bucket": the (dist, lab)
        all-gather, ``local_steps`` relaxations, the replica MIN passes and
        the round's counts.  Returns the (2,) f32 flag over every rank:
        (any vertex improved, the largest finite distance)."""
        src, w, ldst, sin, lsrc = loop.views
        st, theta = loop.st, loop.theta

        def local_relax(cur, distf, labf):
            """One relaxation against the (possibly stale) gathered state;
            sources in this block read the fresh local copy."""
            dsrc = torch.where(sin, cur.dist[lsrc], distf[src])
            lab_s = torch.where(sin, cur.lab[lsrc], labf[src])
            cand = dsrc + w
            if cfg.mode == "bucket":
                # theta: the host's np.float32 threshold, not a tensor
                cand = torch.where(dsrc <= float(theta), cand, INF)  # jitlint: ignore[TS03]
            del dsrc
            new, _ = lex_update(cand, lab_s, src, ldst, cur)
            return new, _count(torch.isfinite(cand))

        distf, labf = gather_state(st.dist, st.lab)
        cur = st
        msg_i = torch.zeros((), dtype=torch.int64, device=src.device)
        for _ in range(cfg.local_steps):
            cur, att = local_relax(cur, distf, labf)
            msg_i += att
        del distf, labf
        if g_rep is not None:
            cur = VoronoiState(*lex_pmin(cur.dist, cur.lab, cur.pred, g_rep))
        diff = (cur.dist != st.dist) | (cur.lab != st.lab) | (cur.pred != st.pred)
        imp_l = _count(diff)
        fin = torch.isfinite(cur.dist)
        # bucket: the frontier is the vertices under the threshold;
        # dense has none, its active set IS the improved-vertex set
        front_l = (_count(fin & (cur.dist <= float(theta)))  # jitlint: ignore[TS03] (theta)
                   if cfg.mode == "bucket" else imp_l)
        unr_l = _count(~fin)
        imp, front, unr = all_reduce(torch.stack([imp_l, front_l, unr_l]), SUM, g_vert)
        msg_g = all_reduce(msg_i[None], SUM, g_all)[0]
        rows = None
        if per_rank:
            rows = _rank_rows([r0(front_l), msg_i, r0(imp_l), r0(unr_l - my_ghost)], g_all)
        loop.rec.add(it, front, msg_g, imp, unr - n_ghost, rows)
        mx_l = torch.where(fin, cur.dist, -INF).max()
        loop.st = cur
        return all_reduce(torch.stack([(imp_l > 0).to(torch.float32), mx_l]), MAX, g_all)

    def body(src, dst, w, seeds):
        loop = edge_init(src, dst, w, seeds)
        if cfg.mode == "bucket":
            delta = (np.float32(cfg.delta) if cfg.delta is not None
                     else delta_from_sums(loop.wsums))
        it, work = 0, True
        while work and it < cap:
            theta = loop.theta
            changed, max_fin = edge_round(loop, it).tolist()  # the round's one host sync
            obs.host_read()
            if cfg.mode == "bucket":
                # terminate only on a quiet round with every source active
                done = not changed and theta >= max_fin
                if not changed:
                    loop.theta = np.float32(theta + delta)
                work = not done
            else:
                work = bool(changed)
            it += 1
        return finish(loop.st, src, dst, w, loop.gids, it, loop.rec)

    @sync_free
    def frontier_init(nbr, wgt, row2v, seeds):
        st, gids = _init_block(seeds, off, nb)
        K = min(cfg.frontier_size, nbr.shape[0])
        lrow = torch.clamp(row2v - off, 0, nb - 1).long()
        # rows with no finite edge can never send: never in the queue
        has_edges = torch.isfinite(wgt).any(dim=1)
        dirty = torch.isin(row2v, seeds) & has_edges
        return _Loop(st, gids, _Round(H, n_ranks, nbr.device),
                     (nbr, wgt, row2v, lrow, has_edges, K), dirty=dirty)

    @sync_free(static=("it",))
    def frontier_round(loop, it):
        """One round of mode "frontier": each rank pops its top-K
        lowest-distance dirty rows and relaxes only their edges; candidates
        reach their (possibly remote) owner through the lexicographic MIN
        over every rank.  Returns the (1,) flag: any row still dirty."""
        nbr, wgt, row2v, lrow, has_edges, K = loop.views
        st, dirty = loop.st, loop.dirty
        rowdist = torch.where(dirty, st.dist[lrow], INF)
        rows = smallest_k(rowdist, K)
        sel = torch.isfinite(rowdist[rows])
        dirty[rows] &= ~sel
        lsel = lrow[rows]
        cand = st.dist[lsel][:, None] + torch.where(sel[:, None], wgt[rows], INF)
        k = cand.shape[1]
        labc = torch.where(sel, st.lab[lsel], IMAX)[:, None].expand(K, k)
        srcc = torch.where(sel, row2v[rows], IMAX)[:, None].expand(K, k)
        m, ml, ms = lex_segmin(cand, labc, srcc, nbr[rows].reshape(-1), npad)
        m, ml, ms = (x[off:off + nb] for x in lex_pmin(m, ml, ms, g_all))
        same = m == st.dist
        upd = torch.isfinite(m) & (
            (m < st.dist) | (same & (ml < st.lab)) | (same & (ml == st.lab) & (ms < st.pred)))
        loop.st = VoronoiState(dist=torch.where(upd, m, st.dist),
                               lab=torch.where(upd, ml, st.lab),
                               pred=torch.where(upd, ms, st.pred))
        # rows of updated vertices become dirty again
        dirty |= upd[lrow] & has_edges
        imp_l = _count(upd)
        unr_l = _count(~torch.isfinite(loop.st.dist))
        att = _count(torch.isfinite(cand))
        front_l = _count(sel)  # rows popped from this rank's queue
        imp, unr = all_reduce(torch.stack([imp_l, unr_l]), SUM, g_vert)
        msg_g, front = all_reduce(torch.stack([att, front_l]), SUM, g_all)
        rows_r = None
        if per_rank:  # pops and attempts are this rank's own
            rows_r = _rank_rows([front_l, att, r0(imp_l), r0(unr_l - my_ghost)], g_all)
        loop.rec.add(it, front, msg_g, imp, unr - n_ghost, rows_r)
        return all_reduce(_count(dirty)[None].clamp(max=1), MAX, g_all)

    def frontier_body(nbr, wgt, row2v, seeds):
        """Paper §IV message prioritization over the sharded ELL view (see
        ``frontier_round``)."""
        loop = frontier_init(nbr, wgt, row2v, seeds)
        it, work = 0, True
        while work and it < cap:
            work = bool(frontier_round(loop, it))  # the round's one host sync
            obs.host_read()
            it += 1
        # this shard's directed edges from the ELL rows (padding slots carry
        # +inf weight, inert in the pair tables)
        esrc = row2v[:, None].expand(nbr.shape).reshape(-1)
        return finish(loop.st, esrc, nbr.reshape(-1), wgt.reshape(-1), loop.gids, it, loop.rec)

    if cfg.mode == "frontier":
        return frontier_body, DistRounds(frontier_init, frontier_round)
    return body, DistRounds(edge_init, edge_round)


@dataclasses.dataclass(frozen=True)
class DistSteinerResult:
    """Host-side view of the distributed pipeline's output."""

    dist: np.ndarray
    lab: np.ndarray
    pred: np.ndarray
    marked: np.ndarray
    path_edge: np.ndarray
    bridge_u: np.ndarray
    bridge_v: np.ndarray
    bridge_w: np.ndarray
    bridge_valid: np.ndarray
    total_distance: float
    num_edges: int
    iterations: int
    relaxations: float
    messages: float
    # (H+1, 4) per-round telemetry (obs.ROUND_CHANNELS rows); None when
    # the pipeline ran with telemetry_rounds=0
    history: Optional[np.ndarray] = None
    # (H+1, n_ranks, 4) per-rank flight-recorder buffer; None unless the
    # pipeline ran with telemetry_per_rank=True
    per_rank: Optional[np.ndarray] = None

    def edge_set(self):
        out = set()
        for v in np.nonzero(self.path_edge)[0]:
            a, b = int(self.pred[v]), int(v)
            out.add((min(a, b), max(a, b)))
        for i in np.nonzero(self.bridge_valid)[0]:
            a, b = int(self.bridge_u[i]), int(self.bridge_v[i])
            out.add((min(a, b), max(a, b)))
        return out


def result_from_device(out, n: int) -> DistSteinerResult:
    """Converts the 14-tuple pipeline output to a host-side result."""
    (
        dist, lab, pred, marked, path_edge, bu, bv, bw, bvalid, total, ne, stats, hist, histr,
    ) = [x.cpu().numpy() for x in out]
    obs.host_read(len(out))
    return DistSteinerResult(
        dist=dist[:n],
        lab=lab[:n],
        pred=pred[:n],
        marked=marked[:n],
        path_edge=path_edge[:n],
        bridge_u=bu,
        bridge_v=bv,
        bridge_w=bw,
        bridge_valid=bvalid,
        total_distance=float(total),
        num_edges=int(ne),
        iterations=int(stats[0]),
        relaxations=float(stats[1]),
        messages=float(stats[2]),
        history=hist if hist.shape[0] > 1 else None,
        per_rank=histr if histr.shape[1] > 0 else None,
    )


def run_dist_steiner(
    mesh: meshmod.Mesh,
    part: Partition,
    seeds: np.ndarray,
    *,
    vert_axis: str = "model",
    replica_axes: Sequence[str] = ("data",),
    device="cuda",
    **cfg_kw,
) -> DistSteinerResult:
    """Convenience wrapper: this rank's shard -> pipeline -> host result.

    Kept for callers that already hold a ``(mesh, Partition)`` pair; a thin
    shim over the ``"mesh1d"`` backend of :mod:`repro_torch.solver`, whose
    prepared handle also keeps the shard on the device across queries.
    """
    from repro_torch.solver.config import SolverConfig
    from repro_torch.solver.registry import get_backend

    cfg = SolverConfig(backend="mesh1d", **cfg_kw)
    return get_backend("mesh1d").solve_prepared(
        cfg, mesh, part, np.asarray(seeds, np.int32), vert_axis=vert_axis,
        replica_axes=tuple(replica_axes), device=device,
    )
