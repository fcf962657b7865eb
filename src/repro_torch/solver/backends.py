"""The execution strategies behind the solver registry.

Ported so far, both with ``mode="pallas"`` only:

  "single"  one query: the min-plus kernel schedule
            (:func:`repro_torch.kernels.minplus.ops.voronoi_cells_pallas`)
            followed by :func:`repro_torch.core.steiner.finish_pipeline`.
  "batch"   B queries against one resident graph (the serving layer's
            backend): the batched fixpoint
            (:func:`~repro_torch.kernels.minplus.ops.voronoi_cells_pallas_lanes`,
            one kernel launch a round for all lanes), then the tail lane by
            lane.  Every lane equals a single solve of its row bit for bit.

With ``src_block`` set on the card, the blocked kernel's layout is built
once per graph for one lane and once for a lane axis: by "single" in
``prepare`` (kept beside the ELL view), by "batch" at its first solve.

Every other (backend, mode) pair, the ``pallas_frontier`` schedule and
graph-store inputs raise ``NotImplementedError`` (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import steiner as smod
from repro_torch.core import tree as treemod
from repro_torch.core import voronoi as vmod
from repro_torch.core.graph import EllGraph, Graph, ell_view_cached, graph_cached
from repro_torch.kernels.minplus import ops as kops
from repro_torch.solver.config import SolverConfig
from repro_torch.solver.registry import (
    SolveOutput,
    SolveTelemetry,
    register_backend,
    telemetry_from_counts,
    to_host,
)

NOT_PORTED = "not ported yet: see ROADMAP.md"


def blocked_layout_cached(g: Graph, cfg: SolverConfig, lanes: int = 1):
    """The blocked kernel's layout of ``g``'s ELL view for ``lanes`` query
    lanes, built once per graph version, src_block and ``lanes > 1`` (one
    layout serves every batch width); None without ``src_block`` or on the
    CPU (:func:`~repro_torch.kernels.minplus.ops.ell_layout`)."""
    if cfg.src_block is None or g.device.type == "cpu":
        return None
    ell = ell_view_cached(g, cfg.ell_width)
    return graph_cached(g, ("blocked", cfg.ell_width, cfg.src_block, lanes > 1),
                        lambda: kops.ell_layout(ell, cfg.src_block, lanes))


class _PallasBackend:
    """What the single and batch backends share: validation and prepare."""

    preprocessing = ("ell_view [mode=pallas]",)
    seeds_ndim = 1

    def validate(self, cfg: SolverConfig) -> None:
        if cfg.backend != self.name:
            raise ValueError(
                f"config targets backend {cfg.backend!r}, dispatched to {self.name!r}"
            )
        if cfg.mode != "pallas":
            raise NotImplementedError(
                f"backend={cfg.backend!r} mode={cfg.mode!r}: {NOT_PORTED}"
            )
        if cfg.pallas_frontier:
            raise NotImplementedError(f"pallas_frontier=True: {NOT_PORTED}")
        if cfg.mst_algo != "prim":
            raise NotImplementedError(f"mst_algo={cfg.mst_algo!r}: {NOT_PORTED}")

    def prepare(self, cfg: SolverConfig, g, device: torch.device) -> dict:
        """Places the COO graph on ``device`` and builds its ELL view."""
        if not isinstance(g, Graph):
            raise NotImplementedError(
                f"prepare() of a {type(g).__name__}: only in-memory Graph "
                f"inputs are ported ({NOT_PORTED})"
            )
        g = g.to(device)
        return {"graph": g, "ell": ell_view_cached(g, cfg.ell_width)}


@register_backend("single")
class SingleBackend(_PallasBackend):
    """One query on one device; the min-plus kernel schedule."""

    def prepare(self, cfg: SolverConfig, g, device: torch.device) -> dict:
        """As the batch backend's, and with ``src_block`` on the card the
        blocked kernel's layout ("blocked_layout")."""
        art = super().prepare(cfg, g, device)
        art["blocked_layout"] = blocked_layout_cached(art["graph"], cfg)
        return art

    def solve(self, cfg, artifacts, seeds, num_seeds) -> SolveOutput:
        res = self.solve_raw(
            cfg, artifacts["graph"], seeds, num_seeds, ell=artifacts["ell"],
            layout=artifacts["blocked_layout"],
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
    ) -> smod.SteinerResult:
        """Runs the pipeline on the graph's device; returns the native
        :class:`SteinerResult`."""
        if ell is None:
            ell = ell_view_cached(g, cfg.ell_width)
        if layout is None:
            layout = blocked_layout_cached(g, cfg)
        seeds = torch.as_tensor(seeds, dtype=torch.int32, device=g.device)
        st, stats = kops.voronoi_cells_pallas(
            ell,
            seeds,
            block_rows=cfg.block_rows,
            src_block=cfg.src_block,
            max_iters=cfg.max_iters,
            telemetry_rounds=cfg.telemetry_rounds,
            layout=layout,
        )
        return smod.finish_pipeline(g, st, stats, num_seeds, cfg.mst_algo)


@register_backend("batch")
class BatchBackend(_PallasBackend):
    """B queries a call against one resident graph.

    The Voronoi fixpoint runs batched (one kernel launch a round for all B
    lanes); the tail (distance graph, Prim, tree) runs lane by lane, since
    its E-sized temporaries times B would not fit beside a full-width graph
    and its output is per lane anyway.
    """

    seeds_ndim = 2

    def solve(self, cfg, artifacts, seeds, num_seeds) -> SolveOutput:
        res = self.solve_raw(
            cfg, artifacts["graph"], seeds, num_seeds, ell=artifacts["ell"]
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
        if ell is None:
            ell = ell_view_cached(g, cfg.ell_width)
        seeds = torch.as_tensor(seeds, dtype=torch.int32, device=g.device)
        if seeds.dim() != 2:
            raise ValueError(f"seeds must be (B, S), got shape {tuple(seeds.shape)}")
        st, stats = kops.voronoi_cells_pallas_lanes(
            ell,
            seeds,
            block_rows=cfg.block_rows,
            src_block=cfg.src_block,
            max_iters=cfg.max_iters,
            telemetry_rounds=cfg.telemetry_rounds,
            layout=blocked_layout_cached(g, cfg, seeds.shape[0]),
        )
        lanes = []
        for b in range(seeds.shape[0]):
            lane_st = vmod.VoronoiState(dist=st.dist[b], lab=st.lab[b], pred=st.pred[b])
            lane_stats = vmod.VoronoiStats(
                iterations=stats.iterations[b], relaxations=stats.relaxations[b],
                messages=stats.messages[b],
                history=None if stats.history is None else stats.history[b],
            )
            lanes.append(smod.finish_pipeline(g, lane_st, lane_stats, num_seeds, cfg.mst_algo))
        tree = treemod.SteinerTree(**{
            f.name: torch.stack([getattr(r.tree, f.name) for r in lanes])
            for f in dataclasses.fields(treemod.SteinerTree)
        })
        return smod.SteinerResult(
            tree=tree,
            state=st,
            stats=stats,
            parent=torch.stack([r.parent for r in lanes]),
            dmat=torch.stack([r.dmat for r in lanes]),
        )
