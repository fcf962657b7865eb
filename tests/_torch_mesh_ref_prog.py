"""The reference's answers to the cases of _torch_mesh_cases.py, on 8
forced host devices (tests/test_torch_mesh_ranks.py runs it with
XLA_FLAGS=--xla_force_host_platform_device_count=8).

    python tests/_torch_mesh_ref_prog.py OUT_DIR

Writes ``OUT_DIR/<case>.ref.npz`` for every case.
"""

import sys

import numpy as np

from _torch_mesh_cases import CASES, case_input, result_arrays


def main() -> None:
    import jax

    from repro import compat
    from repro.core.dist_steiner import partition_edges, run_dist_steiner
    from repro.core.dist_steiner_2d import partition_edges_2d, run_dist_steiner_2d
    from repro.core.graph import from_edges
    from repro.solver import SolverConfig, SteinerSolver

    assert len(jax.devices()) == 8, jax.devices()
    out_dir = sys.argv[1]
    for name, case in CASES.items():
        src, dst, w, n, seeds = case_input(case["graph"])
        telem = None
        if case["kind"] == "solver":
            g = from_edges(src, dst, w, n, pad_to=8)
            out = SteinerSolver(SolverConfig(**case["kw"])).prepare(g).solve(seeds)
            res, telem = out.raw, out.telemetry
        else:
            mesh = compat.make_mesh_from_devices(
                jax.devices()[:case["world"]], case["dims"], case["axes"])
            if case["kind"] == "legacy":
                part = partition_edges(src, dst, w, n, n_replica=int(np.prod(case["dims"][:-1])),
                                       n_blocks=case["dims"][-1])
                res = run_dist_steiner(mesh, part, seeds, replica_axes=case["replica_axes"],
                                       **case["kw"])
            else:
                part = partition_edges_2d(src, dst, w, n, R=case["dims"][0], C=case["dims"][1])
                res = run_dist_steiner_2d(mesh, part, seeds, **case["kw"])
        np.savez(f"{out_dir}/{name}.ref.npz", **result_arrays(res, telem))
        print("OK", name, flush=True)


if __name__ == "__main__":
    main()
