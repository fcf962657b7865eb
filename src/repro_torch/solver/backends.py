"""The execution strategies behind the solver registry.

Ported so far: ``"single"`` with ``mode="pallas"``, the min-plus kernel
schedule (:func:`repro_torch.kernels.minplus.ops.voronoi_cells_pallas`)
followed by :func:`repro_torch.core.steiner.finish_pipeline`.  Every other
(backend, mode) pair, the ``pallas_frontier`` schedule and graph-store
inputs raise ``NotImplementedError`` (see ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import steiner as smod
from repro_torch.core.graph import EllGraph, Graph, ell_view_cached
from repro_torch.kernels.minplus import ops as kops
from repro_torch.solver.config import SolverConfig
from repro_torch.solver.registry import (
    SolveOutput,
    register_backend,
    telemetry_from_counts,
    to_host,
)

NOT_PORTED = "not ported yet: see ROADMAP.md"


@register_backend("single")
class SingleBackend:
    """One query on one device; the min-plus kernel schedule."""

    preprocessing = ("ell_view [mode=pallas]",)

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

    def solve(self, cfg, artifacts, seeds, num_seeds) -> SolveOutput:
        res = self.solve_raw(
            cfg, artifacts["graph"], seeds, num_seeds, ell=artifacts["ell"]
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
    ) -> smod.SteinerResult:
        """Runs the pipeline on the graph's device; returns the native
        :class:`SteinerResult`."""
        if ell is None:
            ell = ell_view_cached(g, cfg.ell_width)
        seeds = torch.as_tensor(seeds, dtype=torch.int32, device=g.device)
        st, stats = kops.voronoi_cells_pallas(
            ell,
            seeds,
            block_rows=cfg.block_rows,
            src_block=cfg.src_block,
            max_iters=cfg.max_iters,
            telemetry_rounds=cfg.telemetry_rounds,
        )
        return smod.finish_pipeline(g, st, stats, num_seeds, cfg.mst_algo)
