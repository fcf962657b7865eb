"""One rank of the port's multi-rank gloo run (tests/test_torch_mesh_ranks.py).

    python tests/_torch_mesh_ranks_prog.py RANK WORLD STORE_FILE OUT_DIR

Rendezvous through a FileStore, then every case of _torch_mesh_cases.py
with ``world == WORLD``, in order, on the CPU; rank r writes
``OUT_DIR/<case>.rank<r>.npz``.  Imports neither JAX nor the JAX package.
"""

import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from _torch_mesh_cases import CASES, case_input, result_arrays


def main() -> None:
    rank, world, store_file, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    from repro_torch.core.dist_steiner import partition_edges, run_dist_steiner
    from repro_torch.core.dist_steiner_2d import partition_edges_2d, run_dist_steiner_2d
    from repro_torch.core.graph import from_edges
    from repro_torch.core.mesh import device_mesh
    from repro_torch.solver import SolverConfig, SteinerSolver

    for name, case in CASES.items():
        if case["world"] != world:
            continue
        src, dst, w, n, seeds = case_input(case["graph"])
        telem = None
        if case["kind"] == "solver":
            g = from_edges(src, dst, w, n, pad_to=8, device="cpu")
            out = SteinerSolver(SolverConfig(**case["kw"]), device="cpu").prepare(g).solve(seeds)
            res, telem = out.raw, out.telemetry
        elif case["kind"] == "legacy":
            mesh = device_mesh(case["dims"], case["axes"])
            n_rep = int(np.prod(case["dims"][:-1]))
            part = partition_edges(src, dst, w, n, n_replica=n_rep, n_blocks=case["dims"][-1])
            res = run_dist_steiner(mesh, part, seeds, replica_axes=case["replica_axes"],
                                   device="cpu", **case["kw"])
        else:
            mesh = device_mesh(case["dims"], case["axes"])
            part = partition_edges_2d(src, dst, w, n, R=case["dims"][0], C=case["dims"][1])
            res = run_dist_steiner_2d(mesh, part, seeds, device="cpu", **case["kw"])
        np.savez(f"{out_dir}/{name}.rank{rank}.npz", **result_arrays(res, telem))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
