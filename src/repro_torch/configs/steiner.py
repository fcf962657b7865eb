"""The paper's own workload: distributed 2-approx Steiner minimal trees.

Shape cells mirror Table III scales sized for v5e HBM (vertex-state
all-gather bounds N; see DESIGN.md §Memory): LVJ-like (8M vertices, 128M
directed edges), UKW-like (64M / 4B), CLW-like (512M / 64B, |S|=10K).

Each workload exports a canonical :class:`repro_torch.solver.SolverConfig`
preset (``SOLVER_PRESETS`` / :func:`solver_preset`) — the single source of
truth the dry-run, perf hillclimb, and launchers consume instead of
re-assembling knob dicts.  Preset choices follow the perf hillclimb
(benchmarks/perf_steiner.py --bench roofline): Δ-bucket scheduling and a
fused (dist, lab) gather everywhere; the CLW cell (|S| = 10240) adds the
paper §V-F chunked pair-table Allreduce and the int16 label gather
(valid for |S| < 32768).
"""

from repro_torch.configs.base import ArchSpec, SteinerConfig, STEINER_SHAPES
from repro_torch.solver import SolverConfig

MODEL = SteinerConfig(name="steiner", mode="bucket", mst_algo="prim")

REDUCED = SteinerConfig(name="steiner-reduced")

# Production mesh for the paper cells: single pod, 16 replica × 16 vertex
# blocks (launch.mesh.make_production_mesh); the dry-run overrides the
# mesh itself but consumes every other knob from these presets.
_BASE = SolverConfig(
    backend="mesh1d",
    mode="bucket",
    mst_algo="prim",
    max_iters=10_000,
    mesh_shape=(16, 16),
    fuse_gather=True,
)

SOLVER_PRESETS = {
    "lvj_1k": _BASE,
    "ukw_1k": _BASE,
    # |S| = 10240: S² pair table is 400 MB of f32 — chunk the Allreduce
    # (paper §V-F); int16 labels cut steady-state gather wire by 25%.
    "clw_10k": _BASE.replace(pair_chunks=8, lab_i16=True),
    # Single-device kernel fast path: the min-plus relaxation (the CUDA
    # kernel on the card, its plain version on the CPU) behind the
    # "batch" backend — the serving engine reaches the same path via
    # ServeConfig(mode="pallas").
    "serve_pallas": SolverConfig(
        backend="batch",
        mode="pallas",
        mst_algo="prim",
        max_iters=10_000,
        ell_width=32,
        block_rows=256,
    ),
    # Distributed message prioritization (paper §IV): per-block top-K
    # dirty-row selection over the sharded ELL view — O(K·k) segment-min
    # work per device per round instead of O(E_shard).  K=8192 rows ×
    # k=32 keeps each round's relax slab (~256K candidates/device) well
    # under the collective terms that bound the roofline.
    "mesh_frontier": _BASE.replace(
        mode="frontier", ell_width=32, frontier_size=8192
    ),
}


def solver_preset(shape_name: str) -> SolverConfig:
    """Canonical solver config for one paper workload cell."""
    try:
        return SOLVER_PRESETS[shape_name]
    except KeyError:
        raise KeyError(
            f"no solver preset for shape {shape_name!r}; "
            f"known: {sorted(SOLVER_PRESETS)}"
        ) from None


ARCH = ArchSpec(
    arch_id="steiner",
    family="steiner",
    model=MODEL,
    shapes=STEINER_SHAPES,
    source="this paper (Reza et al. 2022)",
    reduced=REDUCED,
)
