"""The multi-rank cases of tests/test_torch_mesh_ranks.py, shared by the
port's rank program (_torch_mesh_ranks_prog.py) and the reference's
8-device program (_torch_mesh_ref_prog.py).

Inputs come from the port's numpy generators, which equal the reference's
(tests/test_torch_graphs.py), so this module imports neither JAX nor the
JAX package.  A case is solved through the solver facade ("solver") or
through ``run_dist_steiner`` / ``run_dist_steiner_2d`` on an explicit mesh
("legacy", the only way to a three-axis mesh).
"""

import numpy as np

from repro_torch.data.graphs import er_edges, rmat_edges

FIELDS = ("dist", "lab", "pred", "marked", "path_edge", "bridge_u", "bridge_v", "bridge_w",
          "bridge_valid")
SCALARS = ("num_edges", "iterations", "relaxations", "messages")

CASES = {
    # 8 ranks
    "mesh1d_2x4_bucket": dict(world=8, graph=0, kind="solver", kw=dict(
        backend="mesh1d", mode="bucket", mesh_shape=(2, 4), telemetry_rounds=64)),
    "mesh1d_2x4_frontier": dict(world=8, graph=1, kind="solver", kw=dict(
        backend="mesh1d", mode="frontier", mesh_shape=(2, 4), ell_width=8, frontier_size=16,
        telemetry_rounds=64, telemetry_per_rank=True)),
    "mesh1d_2x2x2_dense": dict(world=8, graph=1, kind="legacy", dims=(2, 2, 2),
                               axes=("pod", "data", "model"), replica_axes=("pod", "data"),
                               kw=dict(mode="dense", local_steps=3, pair_chunks=4,
                                       mst_algo="boruvka", telemetry_rounds=64,
                                       telemetry_per_rank=True)),
    "mesh2d_2x4_bucket": dict(world=8, graph=0, kind="solver", kw=dict(
        backend="mesh2d", mode="bucket", mesh_shape=(2, 4), telemetry_rounds=64,
        telemetry_per_rank=True)),
    # 4 ranks
    "mesh1d_2x2_bucket_unfused": dict(world=4, graph=1, kind="legacy", dims=(2, 2),
                                      axes=("data", "model"), replica_axes=("data",),
                                      kw=dict(mode="bucket", fuse_gather=False,
                                              telemetry_rounds=64, telemetry_per_rank=True)),
    "mesh1d_1x4_dense_i16": dict(world=4, graph=0, kind="legacy", dims=(1, 4),
                                 axes=("data", "model"), replica_axes=("data",),
                                 kw=dict(mode="dense", lab_i16=True, telemetry_rounds=64)),
    "mesh2d_2x2_dense": dict(world=4, graph=1, kind="legacy2d", dims=(2, 2),
                             axes=("data", "model"),
                             kw=dict(mode="dense", telemetry_rounds=64, telemetry_per_rank=True)),
}


def case_input(graph: int):
    """(src, dst, w, n, seeds): an ER graph (0) or an RMAT graph (1)."""
    if graph == 0:
        src, dst, w, n = er_edges(50, 0.1, max_weight=9, seed=3)
    else:
        src, dst, w, n = rmat_edges(6, 6, max_weight=20, seed=5)
    seeds = np.random.default_rng(100 + graph).choice(n, size=6, replace=False)
    return src, dst, w, n, seeds.astype(np.int32)


def result_arrays(res, telemetry=None) -> dict:
    """A DistSteinerResult (either package's) as a dict of numpy arrays."""
    out = {f: np.asarray(getattr(res, f)) for f in FIELDS}
    out["total_distance"] = np.float64(res.total_distance)
    for f in SCALARS:
        out[f] = np.float64(getattr(res, f))
    for f in ("history", "per_rank"):
        x = getattr(res, f)
        if x is not None:
            out[f] = np.asarray(x)
    if telemetry is not None and telemetry.per_rank is not None:
        out["telemetry_per_rank"] = np.asarray(telemetry.per_rank)
        out["telemetry_per_round"] = np.asarray(telemetry.per_round)
    return out
