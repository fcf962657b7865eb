"""Quickstart: 2-approximate Steiner minimal tree on a scale-free graph, on
the PyTorch port.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The counterpart of examples/quickstart.py, the same program: builds an RMAT
graph (the paper's evaluation family), picks seeds with the paper's
BFS-level strategy, solves through the unified solver API
(``SolverConfig → SteinerSolver.prepare → handle.solve``, mode "bucket"),
and verifies the result against the sequential Mehlhorn oracle
(``repro_torch.core.ref``).  Runs on the GPU unless ``--device cpu`` is
given.
"""

import argparse

from repro_torch.core import ref, tree_edge_list
from repro_torch.core.graph import from_edges
from repro_torch.data.graphs import rmat_edges, select_seeds
from repro_torch.solver import SolverConfig, SteinerSolver


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    # 1) a weighted scale-free graph (paper Table III family)
    src, dst, w, n = rmat_edges(12, 8, max_weight=100, seed=42)
    print(f"graph: {n} vertices, {2 * len(src)} directed edges")

    # 2) seed vertices (paper §V: BFS-level stratified selection)
    seeds = select_seeds(n, src, dst, 32, strategy="bfs_level", seed=7)
    print(f"seeds: {len(seeds)} vertices, e.g. {seeds[:6].tolist()}")

    # 3) the paper's Alg. 2 through the unified solver: preprocessing
    #    happens once in prepare(); solve() reuses it
    g = from_edges(src, dst, w, n, pad_to=64, device=args.device)
    solver = SteinerSolver(SolverConfig(backend="single", mode="bucket"), device=args.device)
    handle = solver.prepare(g)
    out = handle.solve(seeds)
    res = out.raw
    print(
        f"Steiner tree: D(G_S) = {out.total_distance:.0f}, "
        f"|E_S| = {out.num_edges}, "
        f"{int(res.stats.iterations)} relaxation rounds, "
        f"{float(res.stats.messages):.0f} generated messages"
    )

    # 3b) repeated queries reuse the prepared handle
    seeds2 = select_seeds(n, src, dst, 32, strategy="uniform", seed=8)
    out2 = handle.solve(seeds2)
    print(f"second query (warm handle): D(G_S) = {out2.total_distance:.0f}")

    # 4) cross-check against the sequential Mehlhorn reference
    edges = list(zip(src.tolist(), dst.tolist(), w.tolist()))
    t_ref, d_ref = ref.mehlhorn_ref(n, edges, seeds.tolist())
    if abs(out.total_distance - d_ref) >= 1e-3:
        raise AssertionError((out.total_distance, d_ref))
    if tree_edge_list(res.state, res.tree) != t_ref:
        raise AssertionError("the tree's edges differ from the Mehlhorn reference's")
    print(f"matches sequential Mehlhorn reference exactly (D = {d_ref:.0f})")

    # 5) seeds all connected, tree is valid
    if not ref.tree_is_valid(n, edges, seeds.tolist(), t_ref):
        raise AssertionError("the reference tree is not a valid Steiner tree")
    print("tree validity: OK (acyclic, connected, spans all seeds)")


if __name__ == "__main__":
    main()
