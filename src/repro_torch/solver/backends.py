"""The execution strategies behind the solver registry.

  "single"  one query on one device, every Voronoi schedule of the
            reference: "dense" and "bucket" over the COO graph
            (:func:`repro_torch.core.steiner.run_pipeline`), "frontier"
            over the ELL view (:func:`~repro_torch.core.voronoi.voronoi_cells_frontier`),
            and "pallas", the min-plus kernel schedule
            (:func:`repro_torch.kernels.minplus.ops.voronoi_cells_pallas`, or
            with ``pallas_frontier`` its top-K compacted twin), each followed
            by :func:`repro_torch.core.steiner.finish_pipeline`.  A warm
            ``init`` state is taken by "dense", "bucket" and "frontier".
  "batch"   B queries against one resident graph (the serving layer's
            backend).  "pallas" runs the batched fixpoint (one kernel launch
            a round for all lanes), then the tail lane by lane; "dense" and
            "bucket" run each lane through the single pipeline, whose
            E-sized temporaries times B would not fit beside a full-width
            graph.  Every lane equals a single solve of its row bit for bit.

``prepare`` takes an in-memory :class:`~repro_torch.core.graph.Graph` or
an on-disk :class:`~repro_torch.graphstore.GraphStore`: a store is
materialized once as the COO graph and, for the ELL modes, as an ELL view
filled straight from its CSR with ``cfg.ell_pad_rows`` row padding.

With ``src_block`` set on the card, the resident schedule's blocked layout
is built once per prepared ELL view for one lane and once for a lane axis:
by "single" in ``prepare`` (kept beside the ELL view), by "batch" at its
first solve.  The top-K schedules relax a new tile every round, whose
layout the kernel's wrapper builds each round.

  "mesh1d"  the paper's design on a (replica x vertex-block) mesh of ranks
            over ``torch.distributed`` (:mod:`repro_torch.core.dist_steiner`;
            mode "frontier" over a sharded ELL view).
  "mesh2d"  the (src-block x dst-block) decomposition
            (:mod:`repro_torch.core.dist_steiner_2d`).

The mesh backends run SPMD, one process a mesh position
(:mod:`repro_torch.core.mesh`): every rank prepares and solves with the same
arguments, partitions on the host (or loads its store's shards when they
are fresh and match ``mesh_shape``), keeps only its own shard on its device,
and returns the same answer.  A mesh of one position needs no setup.

With :mod:`repro_torch.obs` on, ``prepare`` records the reference's
sub-spans: "prepare:materialize" and "prepare:ell_build" (single, batch),
"prepare:partition" or "prepare:shard_load", then "prepare:place" (mesh).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import dist_steiner as d1
from repro_torch.core import dist_steiner_2d as d2
from repro_torch.core import steiner as smod
from repro_torch.core import voronoi as vmod
from repro_torch.core.mesh import device_mesh
from repro_torch.core.graph import EllGraph, Graph, ell_view_cached, graph_cached
from repro_torch.graphstore.loader import GraphStore
from repro_torch.kernels.minplus import ops as kops
from repro_torch.solver.config import BACKEND_MODES, SolverConfig
from repro_torch.solver.registry import (
    SolveOutput,
    SolveTelemetry,
    register_backend,
    telemetry_from_counts,
    to_host,
)

def blocked_layout_cached(ell: EllGraph, cfg: SolverConfig, lanes: int = 1):
    """The blocked kernel's layout of the ELL view ``ell`` (the one the
    kernel relaxes) for ``lanes`` query lanes, built once per ELL object,
    src_block and ``lanes > 1`` (one layout serves every batch width); None
    without ``src_block`` or on the CPU
    (:func:`~repro_torch.kernels.minplus.ops.ell_layout`)."""
    if cfg.src_block is None or ell.nbr.device.type == "cpu":
        return None
    return graph_cached(ell, ("blocked", cfg.src_block, lanes > 1),
                        lambda: kops.ell_layout(ell, cfg.src_block, lanes))


class _Backend:
    """What the single and batch backends share: validation and prepare."""

    preprocessing: tuple = ()
    seeds_ndim = 1
    # modes whose solves consume the ELL view
    ell_modes: tuple = ()

    def validate(self, cfg: SolverConfig) -> None:
        if cfg.backend != self.name:
            raise ValueError(
                f"config targets backend {cfg.backend!r}, dispatched to {self.name!r}"
            )
        if cfg.mode not in BACKEND_MODES[self.name]:
            raise ValueError(f"mode {cfg.mode!r} is not supported by backend {self.name!r}")

    def prepare(self, cfg: SolverConfig, g, device: torch.device) -> dict:
        """Places the COO graph on ``device``, plus its ELL view when
        ``cfg.mode`` is in :attr:`ell_modes`.

        A :class:`GraphStore` is materialized once (its effective graph when
        it carries deltas) and kept as the "store" artifact; its ELL view is
        filled from the CSR with ``cfg.ell_pad_rows`` row padding.  An
        in-memory graph's ELL view is the memoized ``ell_view_cached``.
        """
        if isinstance(g, GraphStore):
            with obs.span("prepare:materialize", backend=self.name):
                art = {"graph": g.to_graph(device=device), "store": g}
            if cfg.mode in self.ell_modes:
                with obs.span("prepare:ell_build", backend=self.name):
                    art["ell"] = g.ell(cfg.ell_width, pad_rows_to=cfg.ell_pad_rows,
                                       device=device)
            return art
        if not isinstance(g, Graph):
            raise TypeError(
                f"prepare() takes a Graph or a GraphStore, not a {type(g).__name__}"
            )
        g = g.to(device)
        art = {"graph": g}
        if cfg.mode in self.ell_modes:
            with obs.span("prepare:ell_build", backend=self.name):
                art["ell"] = ell_view_cached(g, cfg.ell_width)
        return art


def _resident_layout(ell: EllGraph, cfg: SolverConfig, lanes: int = 1):
    """The blocked layout of the resident kernel schedule (mode "pallas"
    without ``pallas_frontier``) over the ELL view it relaxes, else None."""
    if cfg.mode != "pallas" or cfg.pallas_frontier:
        return None
    return blocked_layout_cached(ell, cfg, lanes)


def _pallas_kw(cfg: SolverConfig) -> dict:
    """The kernel knobs of the "pallas" schedules."""
    kw = dict(block_rows=cfg.block_rows, src_block=cfg.src_block, max_iters=cfg.max_iters,
              telemetry_rounds=cfg.telemetry_rounds)
    if cfg.pallas_frontier:
        kw["frontier_size"] = cfg.frontier_size
    return kw


@register_backend("single")
class SingleBackend(_Backend):
    """One query on one device; all four Voronoi schedules."""

    preprocessing = ("ell_view [mode=frontier|pallas]",)
    ell_modes = ("frontier", "pallas")

    def prepare(self, cfg: SolverConfig, g, device: torch.device) -> dict:
        """As :meth:`_Backend.prepare`, and with ``src_block`` on the card the
        resident kernel schedule's blocked layout ("blocked_layout")."""
        art = super().prepare(cfg, g, device)
        layout = _resident_layout(art.get("ell"), cfg)
        if layout is not None:
            art["blocked_layout"] = layout
        return art

    def solve(self, cfg, artifacts, seeds, num_seeds, warm_state=None) -> SolveOutput:
        res = self.solve_raw(
            cfg, artifacts["graph"], seeds, num_seeds, ell=artifacts.get("ell"),
            layout=artifacts.get("blocked_layout"), init=warm_state,
        )
        st = res.stats
        td, ne, it, rlx, msg, hist = to_host(
            res.tree.total_distance, res.tree.num_edges,
            st.iterations, st.relaxations, st.messages, st.history,
        )
        return SolveOutput(
            total_distance=float(td),
            num_edges=int(ne),
            raw=res,
            telemetry=telemetry_from_counts(it, rlx, msg, hist, cfg.telemetry_rounds),
        )

    def solve_raw(
        self,
        cfg: SolverConfig,
        g: Graph,
        seeds,
        num_seeds: int,
        ell: Optional[EllGraph] = None,
        layout=None,
        init: Optional[vmod.VoronoiState] = None,
    ) -> smod.SteinerResult:
        """Runs the pipeline of ``cfg.mode`` on the graph's device; returns
        the native :class:`SteinerResult`.

        ``init`` warm-starts the Voronoi loop (modes "dense", "bucket" and
        "frontier"; the others raise ValueError, as in the reference).
        """
        if init is not None and cfg.mode not in ("dense", "bucket", "frontier"):
            raise ValueError(
                f"warm-start init is only supported for mode "
                f"'dense'|'bucket'|'frontier', not {cfg.mode!r}"
            )
        seeds = torch.as_tensor(seeds, dtype=torch.int32, device=g.device)
        if init is not None:
            init = vmod.VoronoiState(*(t.to(g.device) for t in (init.dist, init.lab, init.pred)))
        if cfg.mode in ("dense", "bucket"):
            return smod.run_pipeline(
                g, seeds, num_seeds=num_seeds, mode=cfg.mode, mst_algo=cfg.mst_algo,
                delta=cfg.delta, max_iters=cfg.max_iters,
                telemetry_rounds=cfg.telemetry_rounds, init=init,
            )
        if ell is None:
            ell = ell_view_cached(g, cfg.ell_width)
        if cfg.mode == "frontier":
            st, stats = vmod.voronoi_cells_frontier(
                ell, seeds, frontier_size=cfg.frontier_size, max_rounds=cfg.max_iters,
                telemetry_rounds=cfg.telemetry_rounds, init=init,
            )
        elif cfg.pallas_frontier:
            st, stats = kops.voronoi_cells_pallas_frontier(ell, seeds, **_pallas_kw(cfg))
        else:
            if layout is None:
                layout = _resident_layout(ell, cfg)
            st, stats = kops.voronoi_cells_pallas(ell, seeds, layout=layout, **_pallas_kw(cfg))
        return smod.finish_pipeline(g, st, stats, num_seeds, cfg.mst_algo)


@register_backend("batch")
class BatchBackend(_Backend):
    """B queries a call against one resident graph.

    Mode "pallas" runs the Voronoi fixpoint batched (one kernel launch a
    round for all B lanes) and the tail (distance graph, Prim, tree) lane by
    lane, since its E-sized temporaries times B would not fit beside a
    full-width graph and its output is per lane anyway.  Modes "dense" and
    "bucket" run each lane through the single pipeline.
    """

    preprocessing = ("ell_view [mode=pallas]",)
    seeds_ndim = 2
    ell_modes = ("pallas",)

    def solve(self, cfg, artifacts, seeds, num_seeds) -> SolveOutput:
        res = self.solve_raw(
            cfg, artifacts["graph"], seeds, num_seeds, ell=artifacts.get("ell")
        )
        # Lane aggregation as in the reference: iterations = slowest lane,
        # f32 counters summed with np.sum, history rows summed (a finished
        # lane's rows stopped growing).  One fetch for the whole batch.
        st = res.stats
        it, rlx, msg, hist, td, ne = to_host(
            st.iterations, st.relaxations, st.messages, st.history,
            res.tree.total_distance, res.tree.num_edges,
        )
        iters = int(np.max(it))
        per_round = None
        if hist is not None and cfg.telemetry_rounds > 0:
            per_round = hist.sum(axis=0)[: min(iters, cfg.telemetry_rounds)]
        telem = SolveTelemetry(
            iterations=iters,
            relaxations=int(round(float(np.sum(rlx)))),
            messages=int(round(float(np.sum(msg)))),
            per_round=per_round,
        )
        return SolveOutput(total_distance=td, num_edges=ne, raw=res, telemetry=telem)

    def solve_raw(
        self,
        cfg: SolverConfig,
        g: Graph,
        seeds,
        num_seeds: int,
        ell: Optional[EllGraph] = None,
    ) -> smod.SteinerResult:
        """Runs the batched pipeline on the graph's device; returns a
        :class:`SteinerResult` with a leading (B,) axis on every array."""
        seeds = torch.as_tensor(seeds, dtype=torch.int32, device=g.device)
        if seeds.dim() != 2:
            raise ValueError(f"seeds must be (B, S), got shape {tuple(seeds.shape)}")
        if cfg.mode in ("dense", "bucket"):
            return _stack([
                smod.run_pipeline(
                    g, row, num_seeds=num_seeds, mode=cfg.mode, mst_algo=cfg.mst_algo,
                    delta=cfg.delta, max_iters=cfg.max_iters,
                    telemetry_rounds=cfg.telemetry_rounds,
                ) for row in seeds
            ])
        if ell is None:
            ell = ell_view_cached(g, cfg.ell_width)
        if cfg.pallas_frontier:
            st, stats = kops.voronoi_cells_pallas_frontier_lanes(ell, seeds, **_pallas_kw(cfg))
        else:
            st, stats = kops.voronoi_cells_pallas_lanes(
                ell, seeds, layout=_resident_layout(ell, cfg, seeds.shape[0]), **_pallas_kw(cfg))
        lanes = []
        for b in range(seeds.shape[0]):
            lane_st = vmod.VoronoiState(dist=st.dist[b], lab=st.lab[b], pred=st.pred[b])
            lane_stats = vmod.VoronoiStats(
                iterations=stats.iterations[b], relaxations=stats.relaxations[b],
                messages=stats.messages[b],
                history=None if stats.history is None else stats.history[b],
            )
            lanes.append(smod.finish_pipeline(g, lane_st, lane_stats, num_seeds, cfg.mst_algo))
        return smod.SteinerResult(
            tree=_stack([r.tree for r in lanes]),
            state=st,
            stats=stats,
            parent=torch.stack([r.parent for r in lanes]),
            dmat=torch.stack([r.dmat for r in lanes]),
        )


def _stack(results):
    """Per-lane results (dataclasses of tensors, such as SteinerResult) as
    one with a leading (B,) axis."""

    def stack(objs):
        first = objs[0]
        if first is None:
            return None
        if isinstance(first, torch.Tensor):
            return torch.stack(objs)
        return type(first)(**{f.name: stack([getattr(o, f.name) for o in objs])
                              for f in dataclasses.fields(first)})

    return stack(results)


# ----------------------------------------------------------------------------
# mesh backends
# ----------------------------------------------------------------------------


def _host_edges(g):
    """A Graph's (src, dst, w) as host numpy arrays."""
    return tuple(t.cpu().numpy() for t in (g.src, g.dst, g.w))


def _shard(arrays, idx: int, rows: int, device):
    """Rank ``idx``'s slice of each flat rank-major array, on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a[idx * rows:(idx + 1) * rows])).to(device)
                 for a in arrays)


def _mesh_output(res, cfg: SolverConfig) -> SolveOutput:
    return SolveOutput(
        total_distance=res.total_distance,
        num_edges=res.num_edges,
        raw=res,
        telemetry=telemetry_from_counts(
            res.iterations, res.relaxations, res.messages, res.history,
            cfg.telemetry_rounds, per_rank=res.per_rank,
        ),
    )


def _partition_span(backend: str, from_shards: bool):
    """The span of a mesh prepare's partition: "prepare:shard_load" when it
    loads a store's shards, else "prepare:partition"."""
    return obs.span("prepare:shard_load" if from_shards else "prepare:partition",
                    backend=backend)


def _store_scheme(store, scheme: str, dims, ell_k=None) -> bool:
    """True when ``store`` holds fresh shards of ``scheme`` cut for ``dims``
    (and ELL shards of width ``ell_k``)."""
    meta = store.partition_meta
    if not meta or meta.get("scheme") != scheme or not store.partition_fresh:
        return False
    keys = ("n_replica", "n_blocks") if scheme == "1d" else ("R", "C")
    if (meta[keys[0]], meta[keys[1]]) != tuple(dims):
        return False
    return ell_k is None or meta.get("ell", {}).get("k") == ell_k


class _MeshBackend(_Backend):
    seeds_ndim = 1

    def _prepared(self, cfg, g, device, part, arrays, from_shards: bool):
        """The artifacts: the mesh, the host partition ("part", or
        "ellpart" in mode "frontier"), this rank's shard of ``arrays`` on
        ``device`` ("edges"), and whether the partition was loaded from the
        store's shards ("from_shards")."""
        mesh = device_mesh(cfg.mesh_shape, ("data", "model"))
        rows = arrays[0].shape[0] // mesh.size
        key = "ellpart" if cfg.mode == "frontier" else "part"
        with obs.span("prepare:place", backend=self.name):
            edges = _shard(arrays, mesh.rank, rows, device)
        art = {"graph": g, "mesh": mesh, key: part, "from_shards": from_shards,
               "edges": edges}
        if isinstance(g, GraphStore):
            art["store"] = g
        return art

    def solve(self, cfg, artifacts, seeds, num_seeds) -> SolveOutput:
        part = artifacts["ellpart" if cfg.mode == "frontier" else "part"]
        return _mesh_output(self.solve_prepared(
            cfg, artifacts["mesh"], part, seeds, edges=artifacts["edges"]), cfg)

    @staticmethod
    def _check_graph(g):
        if not isinstance(g, (Graph, GraphStore)):
            raise TypeError(
                f"prepare() takes a Graph or a GraphStore, not a {type(g).__name__}"
            )


@register_backend("mesh1d")
class Mesh1DBackend(_MeshBackend):
    """The paper's design: dst-block 1D partition over a mesh of ranks.

    ``mode="frontier"`` swaps the edge partition for a per-block sharded
    ELL view (:class:`~repro_torch.core.dist_steiner.EllPartition`) driving
    the prioritized top-K schedule.
    """

    preprocessing = ("mesh", "partition_1d [or ell_partition]", "shard to the device")

    def prepare(self, cfg: SolverConfig, g, device: torch.device) -> dict:
        """Partitions on the host (memoized per in-memory graph), or loads
        a store's fresh 1D shards cut for ``mesh_shape``; keeps this rank's
        shard on ``device``."""
        self._check_graph(g)
        R, B = cfg.mesh_shape
        device_mesh(cfg.mesh_shape, ("data", "model"))  # raises before any work
        frontier = cfg.mode == "frontier"
        shards = isinstance(g, GraphStore) and _store_scheme(
            g, "1d", (R, B), cfg.ell_width if frontier else None)
        with _partition_span(self.name, shards):
            if frontier:
                if shards:
                    part = g.load_partition_ell()
                elif isinstance(g, GraphStore):
                    part = d1.partition_ell(g.ell(cfg.ell_width, device=device),
                                            n_replica=R, n_blocks=B)
                else:
                    part = graph_cached(g, ("partition_ell", cfg.ell_width, R, B),
                                        lambda: d1.partition_ell(
                                            ell_view_cached(g, cfg.ell_width),
                                            n_replica=R, n_blocks=B))
            elif shards:
                part = g.load_partition()
            elif isinstance(g, GraphStore):  # the store already holds both directions
                part = d1.partition_edges(*g.coo(), g.n, n_replica=R, n_blocks=B,
                                          symmetrize=False)
            else:
                # g is already symmetric and padded; its padding edges stay inert
                part = graph_cached(g, ("partition_1d", R, B), lambda: d1.partition_edges(
                    *_host_edges(g), g.n, n_replica=R, n_blocks=B, symmetrize=False))
        arrays = (part.nbr, part.wgt, part.row2v) if frontier else (part.src, part.dst, part.w)
        return self._prepared(cfg, g, device, part, arrays, shards)

    def solve_prepared(
        self,
        cfg: SolverConfig,
        mesh,
        part,
        seeds,
        *,
        vert_axis: str = "model",
        replica_axes: Sequence[str] = ("data",),
        edges=None,
        device="cuda",
    ) -> d1.DistSteinerResult:
        """Runs this rank's part on a (mesh, Partition | EllPartition) pair;
        ``edges`` is this rank's shard on its device (placed here when
        None).  Every rank calls it with the same arguments."""
        frontier = cfg.mode == "frontier"
        if frontier and not isinstance(part, d1.EllPartition):
            raise TypeError(
                "mesh1d mode='frontier' runs on an EllPartition (the "
                "sharded ELL view) — prepare the graph through "
                "SteinerSolver(cfg).prepare(graph); the legacy "
                "run_dist_steiner edge-Partition path has no ELL view"
            )
        replica_axes = tuple(replica_axes)
        axes = replica_axes + (vert_axis,)
        if (part.n_replica, part.n_blocks) != (mesh.axis_size(replica_axes),
                                               mesh.shape[vert_axis]):
            raise ValueError(
                f"the partition is cut for {part.n_replica} replicas x {part.n_blocks} "
                f"blocks, the mesh has {mesh.axis_size(replica_axes)} x "
                f"{mesh.shape[vert_axis]}")
        if edges is None:
            arrays = (part.nbr, part.wgt, part.row2v) if frontier else (part.src, part.dst, part.w)
            rows = part.rb if frontier else part.eb
            edges = _shard(arrays, mesh.axis_index(axes), rows, device)
        seeds = torch.as_tensor(seeds, dtype=torch.int32, device=edges[0].device)
        dcfg = d1.DistSteinerConfig(
            n=part.n, nb=part.nb, num_seeds=int(seeds.shape[0]), mode=cfg.mode,
            mst_algo=cfg.mst_algo, local_steps=cfg.local_steps, pair_chunks=cfg.pair_chunks,
            max_iters=cfg.max_iters, delta=cfg.delta, fuse_gather=cfg.fuse_gather,
            lab_i16=cfg.lab_i16, frontier_size=cfg.frontier_size,
            telemetry_rounds=cfg.telemetry_rounds, telemetry_per_rank=cfg.telemetry_per_rank,
        )
        fn = d1.make_dist_steiner(mesh, dcfg, vert_axis=vert_axis, replica_axes=replica_axes)
        return d1.result_from_device(fn(*edges, seeds), part.n)


@register_backend("mesh2d")
class Mesh2DBackend(_MeshBackend):
    """The (src-block x dst-block) 2D decomposition over a mesh of ranks."""

    preprocessing = ("mesh", "partition_2d", "shard to the device")

    def prepare(self, cfg: SolverConfig, g, device: torch.device) -> dict:
        """As :meth:`Mesh1DBackend.prepare`, with the 2D partition."""
        self._check_graph(g)
        R, C = cfg.mesh_shape
        device_mesh(cfg.mesh_shape, ("data", "model"))
        shards = isinstance(g, GraphStore) and _store_scheme(g, "2d", (R, C))
        with _partition_span(self.name, shards):
            if shards:
                part = g.load_partition_2d()
            elif isinstance(g, GraphStore):
                part = d2.partition_edges_2d(*g.coo(), g.n, R=R, C=C, symmetrize=False)
            else:
                part = graph_cached(g, ("partition_2d", R, C), lambda: d2.partition_edges_2d(
                    *_host_edges(g), g.n, R=R, C=C, symmetrize=False))
        return self._prepared(cfg, g, device, part, (part.src_row, part.dst_col, part.w),
                              shards)

    def solve_prepared(
        self,
        cfg: SolverConfig,
        mesh,
        part,
        seeds,
        *,
        row_axis: str = "data",
        col_axis: str = "model",
        edges=None,
        device="cuda",
    ) -> d1.DistSteinerResult:
        """See :meth:`Mesh1DBackend.solve_prepared`."""
        if (part.R, part.C) != (mesh.shape[row_axis], mesh.shape[col_axis]):
            raise ValueError(f"the partition is cut for {part.R} x {part.C} ranks, the mesh "
                             f"has {mesh.shape[row_axis]} x {mesh.shape[col_axis]}")
        if edges is None:
            edges = _shard((part.src_row, part.dst_col, part.w),
                           mesh.axis_index((row_axis, col_axis)), part.eb, device)
        seeds = torch.as_tensor(seeds, dtype=torch.int32, device=edges[0].device)
        fn = d2.make_dist_steiner_2d(
            mesh, n=part.n, nf=part.nf, num_seeds=int(seeds.shape[0]), mode=cfg.mode,
            mst_algo=cfg.mst_algo, max_iters=cfg.max_iters, delta=cfg.delta,
            row_axis=row_axis, col_axis=col_axis, telemetry_rounds=cfg.telemetry_rounds,
            telemetry_per_rank=cfg.telemetry_per_rank,
        )
        return d1.result_from_device(fn(*edges, seeds), part.n)
