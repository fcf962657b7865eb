"""One frozen config for every execution strategy of the one algorithm.

The same fields, defaults and validation as ``repro.solver.config``, so one
:class:`SolverConfig` value describes a solve in both packages.  This
package runs every backend and mode of the reference with either MST
algorithm.  The device is not a config field: it is an argument of
:class:`~repro_torch.solver.SteinerSolver`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch import knobs

BACKENDS: Tuple[str, ...] = ("single", "mesh1d", "mesh2d", "batch")
MODES: Tuple[str, ...] = ("dense", "bucket", "frontier", "pallas")
MST_ALGOS: Tuple[str, ...] = ("prim", "boruvka")

# Which Voronoi schedules each backend can execute (in the reference).
BACKEND_MODES = {
    "single": ("dense", "bucket", "frontier", "pallas"),
    "batch": ("dense", "bucket", "pallas"),
    "mesh1d": ("dense", "bucket", "frontier"),
    "mesh2d": ("dense", "bucket"),
}


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static configuration of the unified Steiner solver.

    Attributes (see ``repro.solver.config.SolverConfig`` for the full text):
      backend: "single" | "mesh1d" | "mesh2d" | "batch".
      mode: Voronoi schedule, "dense" | "bucket" | "frontier" | "pallas"
        (the min-plus kernel of :mod:`repro_torch.kernels.minplus`).
      mst_algo: "prim" | "boruvka".
      delta: bucket width (mode="bucket").
      max_iters: cap on relaxation rounds (None -> 4n + 64).
      ell_width: ELL row width of the frontier/pallas view.
      ell_pad_rows: ELL row padding for graph-store inputs (spare rows the
        delta layer's row surgery claims).
      frontier_size: top-K rows a round (frontier schedules).
      block_rows: work items of one thread block's tile (mode="pallas"):
        ELL rows (with ``src_block``, the layout's runs) for one query,
        (row or run, lane pair) items with a lane axis.
      src_block: source-blocked relaxation (mode="pallas"): each kernel
        launch gathers dist/lab from one source slice, a whole number of
        (src_block,) blocks sized to the card's L2, over a per-graph layout
        of the adjacency built once; any positive int.  None gathers from
        the whole table in one launch.
      interpret: Pallas interpreter override of the reference; accepted and
        ignored here (a CUDA kernel has no interpreter).
      pallas_frontier: top-K work-compacted kernel schedule.
      batch_size, mesh_shape, local_steps, pair_chunks, fuse_gather,
        lab_i16, telemetry_per_rank: batch and mesh knobs.
      telemetry_rounds: depth H of the (H+1, 4) per-round telemetry buffer
        (0 disables it).
    """

    backend: str = "single"
    mode: str = "bucket"
    mst_algo: str = "prim"
    delta: Optional[float] = None
    max_iters: Optional[int] = None
    # mode="frontier" / mode="pallas"
    ell_width: int = 32
    ell_pad_rows: int = 1
    frontier_size: int = 1024
    # mode="pallas"
    block_rows: int = 256
    src_block: Optional[int] = None
    interpret: Optional[bool] = None
    pallas_frontier: bool = False
    # backend="batch"
    batch_size: int = 8
    # backend="mesh1d"/"mesh2d"
    mesh_shape: Tuple[int, int] = (1, 1)
    local_steps: int = 1
    pair_chunks: int = 1
    fuse_gather: bool = True
    lab_i16: bool = False
    # per-round telemetry buffer depth (0 disables)
    telemetry_rounds: int = 256
    # per-rank flight recorder (mesh1d/mesh2d; needs telemetry_rounds >= 1)
    telemetry_per_rank: bool = False

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend: {self.backend!r} (use one of {BACKENDS})"
            )
        if self.mode not in MODES:
            raise ValueError(
                f"unknown mode: {self.mode!r} "
                f"(use 'dense' | 'bucket' | 'frontier' | 'pallas')"
            )
        if self.mode not in BACKEND_MODES[self.backend]:
            raise ValueError(
                f"mode {self.mode!r} is not supported by backend "
                f"{self.backend!r} (supported: {BACKEND_MODES[self.backend]})"
            )
        if self.mst_algo not in MST_ALGOS:
            raise ValueError(
                f"unknown mst_algo: {self.mst_algo!r} (use 'prim' | 'boruvka')"
            )
        if self.delta is not None and not self.delta > 0:
            raise ValueError(f"delta must be positive, got {self.delta}")
        if self.max_iters is not None and self.max_iters < 1:
            raise ValueError(f"max_iters must be >= 1, got {self.max_iters}")
        for name in ("ell_width", "ell_pad_rows", "frontier_size",
                     "batch_size", "local_steps", "pair_chunks",
                     "block_rows"):
            v = getattr(self, name)
            if not (isinstance(v, int) and v >= 1):
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        if not (isinstance(self.telemetry_rounds, int) and self.telemetry_rounds >= 0):
            raise ValueError(
                f"telemetry_rounds must be an int >= 0, "
                f"got {self.telemetry_rounds!r}"
            )
        if self.telemetry_per_rank:
            if self.backend not in ("mesh1d", "mesh2d"):
                raise ValueError(
                    f"telemetry_per_rank records one row per mesh device "
                    f"and requires backend 'mesh1d' or 'mesh2d'; "
                    f"got backend={self.backend!r}"
                )
            if self.telemetry_rounds < 1:
                raise ValueError(
                    "telemetry_per_rank requires telemetry_rounds >= 1 "
                    "(the per-rank flight recorder rides the round buffer)"
                )
        if self.src_block is not None and not (
            isinstance(self.src_block, int) and self.src_block >= 1
        ):
            raise ValueError(
                f"src_block must be None or a positive int, got {self.src_block!r}"
            )
        if self.interpret is not None and not isinstance(self.interpret, bool):
            raise ValueError(
                f"interpret must be None (auto), True, or False, "
                f"got {self.interpret!r}"
            )
        if self.pallas_frontier and self.mode != "pallas":
            raise ValueError(
                f"pallas_frontier=True requires mode='pallas', "
                f"got mode={self.mode!r}"
            )
        if (
            self.backend == "mesh1d"
            and self.mode == "frontier"
            and self.local_steps != 1
        ):
            raise ValueError(
                f"local_steps > 1 is not supported with mode='frontier' "
                f"(top-K candidates must cross devices every round); "
                f"got local_steps={self.local_steps}"
            )
        ms = self.mesh_shape
        if (
            not isinstance(ms, tuple)
            or len(ms) != 2
            or not all(isinstance(d, int) and d >= 1 for d in ms)
        ):
            raise ValueError(
                f"mesh_shape must be a (int, int) tuple of positive dims, "
                f"got {ms!r}"
            )
        if self.backend == "mesh2d":
            for name, default in (
                ("local_steps", 1),
                ("pair_chunks", 1),
                ("fuse_gather", True),
                ("lab_i16", False),
            ):
                if getattr(self, name) != default:
                    raise ValueError(
                        f"{name} is a mesh1d-only knob (backend='mesh2d' "
                        f"got {name}={getattr(self, name)!r})"
                    )

    def replace(self, **kw) -> "SolverConfig":
        """Functional update (re-validates)."""
        return dataclasses.replace(self, **kw)


# every field is a view knob or a solve knob: a new one fails the import
knobs.validate_config_coverage(f.name for f in dataclasses.fields(SolverConfig))
