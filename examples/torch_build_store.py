"""Out-of-core graphs: build a .gstore on disk, then serve queries off it, on
the PyTorch port.

    PYTHONPATH=src python examples/torch_build_store.py [--scale 14]
    PYTHONPATH=src python examples/torch_build_store.py --device cpu

The counterpart of examples/build_store.py, the same program: streams a
scale-14 RMAT graph (~16K vertices, ~260K directed edges; ingest memory
stays bounded by the chunk size, never O(edges)) into a ``.gstore``
directory (a temporary one, removed at the end, unless ``--out`` names
one), reopens it with checksum verification, proves solver parity against
the fully in-memory path, and boots a
:class:`repro_torch.serve.SteinerServer` straight off the store.  The
stores are byte for byte the reference's.  Runs on the GPU unless
``--device cpu`` is given.

The equivalent CLI:

    python -m repro_torch.graphstore build /tmp/g14.gstore --source rmat \\
        --scale 14 --edge-factor 8
    python -m repro_torch.graphstore info /tmp/g14.gstore
"""

import argparse
import tempfile
from pathlib import Path

import numpy as np

from repro_torch.core import from_edges
from repro_torch.data.graphs import rmat_edges
from repro_torch.graphstore import RmatEdgeSource, build_store, open_store
from repro_torch.serve import ServeConfig, SteinerServer
from repro_torch.solver import SolverConfig, SteinerSolver


def run(args, out: Path) -> None:
    # 1) stream the graph to disk — two passes, bounded chunk memory
    source = RmatEdgeSource(args.scale, args.edge_factor, seed=0)
    path, stats = build_store(source, out)
    print(
        f"built {path}\n"
        f"  n={stats.n:,} directed edges={stats.m_directed:,} "
        f"in {stats.seconds:.2f}s ({stats.edges_per_sec:,.0f} edges/s)\n"
        f"  peak chunk transient: {stats.peak_chunk_bytes / 2**20:.1f} MiB "
        f"(vs {stats.m_directed * 8 / 2**20:.0f} MiB of edge payload on disk)"
    )

    # 2) reopen with checksum verification; lazy memmapped views
    store = open_store(path)

    # 3) parity: a handle prepared from disk answers exactly like one
    #    prepared from RAM (the acceptance bar for the storage layer)
    rng = np.random.default_rng(0)
    seeds = rng.choice(store.n, size=16, replace=False).astype(np.int32)
    cfg = SolverConfig(backend="single", mode="bucket")
    disk = SteinerSolver(cfg, device=args.device).prepare(store).solve(seeds)
    src, dst, w, n = rmat_edges(args.scale, args.edge_factor, seed=0)
    mem = SteinerSolver(cfg, device=args.device).prepare(
        from_edges(src, dst, w, n, device=args.device)).solve(seeds)
    if disk.total_distance != mem.total_distance:
        raise AssertionError((disk.total_distance, mem.total_distance))
    print(f"  solver parity (disk vs RAM): D = {disk.total_distance}")

    # 4) serve queries straight off the store
    server = SteinerServer(graph_path=path, config=ServeConfig(buckets=(16,), max_batch=4),
                           device=args.device)
    for q in range(8):
        qs = np.random.default_rng(100 + q).choice(store.n, size=16, replace=False)
        r = server.query(qs.tolist())
        print(f"  query {q}: D={r.total_distance:9.1f} "
              f"({'cache' if r.from_cache else 'fresh'})")
    s = server.stats()
    print(f"served {s['completed']} queries, p50 {s['latency_p50_ms']:.1f}ms")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=14, help="RMAT n = 2^scale")
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--out", default=None, help=".gstore path (default: a temporary one)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.out:
        run(args, Path(args.out))
        return
    with tempfile.TemporaryDirectory() as tmp:
        run(args, Path(tmp) / f"rmat_s{args.scale}.gstore")


if __name__ == "__main__":
    main()
