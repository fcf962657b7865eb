"""End-to-end distributed program on the PyTorch port: interactive seed
exploration at scale.

    PYTHONPATH=src python examples/torch_steiner_knowledge_graph.py               # one GPU
    PYTHONPATH=src python examples/torch_steiner_knowledge_graph.py --device cpu
    # a (2, 2) mesh: 4 CPU ranks over gloo, or one GPU a rank over NCCL
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/torch_steiner_knowledge_graph.py \\
        --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/torch_steiner_knowledge_graph.py

The counterpart of examples/steiner_knowledge_graph.py, the same program.
The paper's motivating workflow (§I): a network scientist repeatedly asks
for the relationship structure between sets of entities in a knowledge
graph.  This program uses the unified solver's ``"mesh1d"`` backend:

  1. ``SteinerSolver.prepare(g)`` partitions the scale-free graph across
     a (data × model) mesh of ranks with the paper's dst-block layout and
     keeps this rank's edge shard on its device — ONCE,
  2. repeated ``handle.solve(seeds)`` calls answer seed-set queries with
     the distributed pipeline (async-amortized local-steps relaxation,
     Δ-bucket prioritization), with nothing rebuilt between queries,
  3. prints per-query runtime, tree size, message statistics.

Without ``torchrun`` it runs a world of one rank (mesh (1, 1)); under
``torchrun`` one rank a process, the mesh shape from the world size.
Every rank makes the same calls; rank 0 prints.
"""

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch import knobs
from repro_torch.core import ref
from repro_torch.core.graph import from_edges
from repro_torch.data.graphs import rmat_edges, select_seeds
from repro_torch.solver import SolverConfig, SteinerSolver

MESH_SHAPES = {1: (1, 1), 2: (1, 2), 4: (2, 2), 8: (2, 4)}
# (|S|, seed strategy, draw seed) of each query, then the repeated |S|
QUERIES = ((8, "uniform", 100), (64, "bfs_level", 101), (256, "bfs_level", 102))
REPEAT = (64, "uniform", 999)


def knowledge_graph_config(mesh_shape) -> SolverConfig:
    """The workflow's solver: mesh1d, Δ-bucket rounds, two local
    relaxation steps between exchanges, Prim."""
    return SolverConfig(backend="mesh1d", mode="bucket", mst_algo="prim", local_steps=2,
                        mesh_shape=mesh_shape)


def answer_queries(handle, n, src, dst, queries=QUERIES, *, edges=None, log=print):
    """Draws each ``(k, strategy, seed)`` query's seeds from the host edges
    ``src``/``dst`` (one direction) and solves it on ``handle``; with
    ``edges`` (a list of (u, v, w)) holds each query of |S| <= 64 to the
    sequential Mehlhorn oracle.  Returns one record a query: its seeds,
    the solve's output and its seconds."""
    records = []
    for qi, (k, strat, seed) in enumerate(queries):
        seeds = select_seeds(n, src, dst, k, strategy=strat, seed=seed)
        t0 = time.perf_counter()
        out = handle.solve(seeds)
        dt = time.perf_counter() - t0
        r = out.raw
        log(f"query {qi}: |S|={k:4d} ({strat:9s}) → D={out.total_distance:9.0f} "
            f"|E_S|={out.num_edges:5d} rounds={r.iterations:3d} "
            f"msgs={r.messages:9.0f} [{dt:5.1f}s]")
        if edges is not None and k <= 64:  # verify small queries against the oracle
            _, d_ref = ref.mehlhorn_ref(n, edges, seeds.tolist())
            if abs(out.total_distance - d_ref) >= 1e-3:
                raise AssertionError((out.total_distance, d_ref))
            log(f"         verified against sequential Mehlhorn (D={d_ref:.0f})")
        records.append({"seeds": seeds, "out": out, "s": dt})
    return records


def repeat_query(handle, n, src, dst, query=REPEAT, *, log=print):
    """A repeated |S| on the same handle: answered with nothing rebuilt
    (``knobs.build_count`` unchanged).  Returns its record, as
    :func:`answer_queries`'s, with the rebuild count."""
    k, strat, seed = query
    seeds = select_seeds(n, src, dst, k, strategy=strat, seed=seed)
    builds = knobs.build_count()
    t0 = time.perf_counter()
    out = handle.solve(seeds)
    dt = time.perf_counter() - t0
    rebuilds = knobs.build_count() - builds
    log(f"repeat |S|={k} (warm handle): D={out.total_distance:.0f} "
        f"[{dt:.2f}s; {rebuilds} rebuilds]")
    if rebuilds:
        raise AssertionError(f"the repeated query rebuilt {rebuilds} views")
    return {"seeds": seeds, "out": out, "s": dt, "rebuilds": rebuilds}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (one GPU a rank) or cpu")
    ap.add_argument("--init-method", default="env://",
                    help="rendezvous of a multi-rank world (torchrun's environment by default, "
                    "or file:///path with RANK and WORLD_SIZE set)")
    args = ap.parse_args()

    if "WORLD_SIZE" in os.environ:  # one rank of several
        backend = "gloo" if args.device == "cpu" else "cuda:nccl,cpu:gloo"
        dist.init_process_group(backend, init_method=args.init_method,
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // dist.get_world_size()))
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    log = print if rank == 0 else (lambda *a: None)
    mesh_shape = MESH_SHAPES.get(world, (2, world // 2))
    log(f"mesh: {dict(zip(('data', 'model'), mesh_shape))} on {world} ranks ({args.device})")

    src, dst, w, n = rmat_edges(13, 8, max_weight=500, seed=11)
    log(f"graph: {n} vertices, {2 * len(src)} directed edges")

    solver = SteinerSolver(knowledge_graph_config(mesh_shape), device=args.device)
    t0 = time.perf_counter()
    handle = solver.prepare(from_edges(src, dst, w, n, device="cpu"))
    part = handle.artifact("part")
    log(f"prepared in {time.perf_counter() - t0:.1f}s "
        f"({handle.preprocessing}; block={part.nb} vertices, "
        f"{part.eb} edges/device)")

    edges = list(zip(src.tolist(), dst.tolist(), w.tolist())) if rank == 0 else None
    answer_queries(handle, n, src, dst, edges=edges, log=log)
    repeat_query(handle, n, src, dst, log=log)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
