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

The mesh backends raise ``NotImplementedError`` (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import steiner as smod
from repro_torch.core import voronoi as vmod
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

NOT_PORTED = "not ported yet: see ROADMAP.md"


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
            art = {"graph": g.to_graph(device=device), "store": g}
            if cfg.mode in self.ell_modes:
                art["ell"] = g.ell(cfg.ell_width, pad_rows_to=cfg.ell_pad_rows, device=device)
            return art
        if not isinstance(g, Graph):
            raise TypeError(
                f"prepare() takes a Graph or a GraphStore, not a {type(g).__name__}"
            )
        g = g.to(device)
        art = {"graph": g}
        if cfg.mode in self.ell_modes:
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
