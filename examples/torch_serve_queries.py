"""Serving Steiner queries: batched multi-query engine over one graph, on the
PyTorch port.

    PYTHONPATH=src python examples/torch_serve_queries.py
    PYTHONPATH=src python examples/torch_serve_queries.py --device cpu

The counterpart of examples/serve_queries.py, the same program: stands up a
:class:`repro_torch.serve.SteinerServer` on an RMAT graph, then plays a
small Zipfian query stream through it — a network scientist issuing
repeated seed-set queries against one fixed graph, turned into a service:
shape buckets, micro-batched execution, LRU result caching.  Each fresh
answer is checked against a single solve of the same seeds.  Runs on the
GPU unless ``--device cpu`` is given.
"""

import argparse

import numpy as np

from repro_torch.core import from_edges
from repro_torch.data.graphs import rmat_edges
from repro_torch.serve import ServeConfig, SteinerServer
from repro_torch.solver import SolverConfig, SteinerSolver


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    # 1) one resident graph, shared by every query
    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=42)
    g = from_edges(src, dst, w, n, pad_to=64, device=args.device)
    print(f"graph: {n} vertices, {int(g.num_edges)} directed edges")

    # 2) the server: 3 shape buckets, batches of 8
    server = SteinerServer(g, ServeConfig(buckets=(8, 16, 32), max_batch=8),
                           device=args.device)
    server.warmup()
    print("warmed 3 buckets")

    # 3) a Zipfian stream over 30 distinct queries (hot queries repeat)
    rng = np.random.default_rng(0)
    pool = [
        rng.choice(n, size=int(rng.integers(3, 24)), replace=False).tolist()
        for _ in range(30)
    ]
    p = 1.0 / np.arange(1, 31) ** 1.1
    p /= p.sum()
    stream = [pool[i] for i in rng.choice(30, size=120, p=p)]

    # 4) submit in bursts of 8, flush each burst through the micro-batcher
    single = SteinerSolver(SolverConfig(backend="single", mode="bucket"),
                           device=args.device).prepare(g)
    for burst_start in range(0, len(stream), 8):
        tickets = [
            server.submit(q) for q in stream[burst_start : burst_start + 8]
        ]
        results = server.flush()
        for t in tickets[:1]:  # print one per burst
            r = results[t]
            src_tag = "cache" if r.from_cache else f"bucket {r.bucket}"
            print(
                f"  |S|={len(r.key):2d} -> D(G_S)={r.total_distance:7.0f} "
                f"({r.num_edges} edges, {src_tag}, "
                f"{r.latency_s * 1e3:.1f} ms)"
            )
        for r in results.values():
            if not r.from_cache:  # a served lane answers as a single solve
                one = single.solve(list(r.key))
                if (one.total_distance, one.num_edges) != (r.total_distance, r.num_edges):
                    raise AssertionError((r.key, r.total_distance, one.total_distance))

    # 5) service counters
    s = server.stats()
    print(
        f"served {s['completed']} queries: QPS={s['qps']:.1f}, "
        f"p50={s['latency_p50_ms']:.1f}ms, p99={s['latency_p99_ms']:.1f}ms, "
        f"cache hit rate={s['cache_hit_rate']:.0%}, "
        f"pad waste={s['pad_waste']:.0%}"
    )


if __name__ == "__main__":
    main()
