"""The port's distributed solver on a mesh of ranks, one process a rank.

    # 4 CPU ranks (gloo), a (2, 2) mesh:
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/torch_mesh_ranks.py --device cpu
    # 2D decomposition, frontier mode, or one GPU a rank (NCCL):
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/torch_mesh_ranks.py --device cpu \\
        --backend mesh2d
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/torch_mesh_ranks.py --mode frontier
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/torch_mesh_ranks.py

Every rank builds the same RMAT graph from a seed, prepares it with
``SolverConfig(backend=..., mesh_shape=...)`` (it keeps only its own
shard) and answers the same seed-set queries; rank 0 prints each answer
beside a single-device solve of the same query, which it must equal.
"""

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (one GPU a rank) or cpu")
    ap.add_argument("--backend", default="mesh1d", choices=("mesh1d", "mesh2d"))
    ap.add_argument("--mode", default="bucket", choices=("dense", "bucket", "frontier"))
    ap.add_argument("--scale", type=int, default=12, help="RMAT scale of the graph")
    ap.add_argument("--queries", type=int, default=3)
    args = ap.parse_args()

    backend = "gloo" if args.device == "cpu" else "cuda:nccl,cpu:gloo"
    dist.init_process_group(backend)  # torchrun's environment
    rank, world = dist.get_rank(), dist.get_world_size()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    rows = int(np.sqrt(world))
    while world % rows:
        rows -= 1
    mesh_shape = (rows, world // rows)

    from repro_torch.core.graph import from_edges
    from repro_torch.data.graphs import rmat_edges, select_seeds
    from repro_torch.solver import SolverConfig, SteinerSolver

    src, dst, w, n = rmat_edges(args.scale, 8, max_weight=100, seed=0)
    cfg = SolverConfig(backend=args.backend, mode=args.mode, mesh_shape=mesh_shape,
                       frontier_size=256)
    solver = SteinerSolver(cfg, device=args.device)
    t0 = time.perf_counter()
    handle = solver.prepare(from_edges(src, dst, w, n, pad_to=8, device="cpu"))
    prep_s = time.perf_counter() - t0
    single = None
    if rank == 0:
        print(f"{world} ranks, mesh {mesh_shape} ({args.backend}, {args.mode}) on "
              f"{solver.device}; n={n}, {2 * len(src)} directed edges; prepare {prep_s:.3f} s; "
              f"this rank's shard: {handle.artifact('edges')[0].shape[0]} rows", flush=True)
        single = SteinerSolver(SolverConfig(mode="dense"), device=args.device).prepare(
            from_edges(src, dst, w, n, pad_to=8, device=args.device))
    for q in range(args.queries):
        seeds = select_seeds(n, src, dst, 16, strategy="uniform", seed=1000 + q)
        t0 = time.perf_counter()
        out = handle.solve(seeds)
        secs = time.perf_counter() - t0
        if rank == 0:
            want = single.solve(seeds)
            t = out.telemetry
            print(f"query {q}: D={out.total_distance} edges={out.num_edges} rounds="
                  f"{t.iterations} messages={t.messages} in {secs:.3f} s; single solve "
                  f"D={float(want.total_distance)}", flush=True)
            assert out.num_edges == int(want.raw.tree.num_edges)
            assert np.array_equal(out.raw.dist, want.raw.state.dist.cpu().numpy())
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
