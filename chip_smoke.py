#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # full width: RMAT scale 23, 1024 seeds
    python3 chip_smoke.py --scale 18 # a shorter rehearsal of phases 6 and 7

Phases (any failure raises and the script exits non-zero, printing no
result):

1. device and build: the card's name and power limit, torch's version, and
   the seconds nvcc took to build every kernel source of the package;
2. every kernel against its plain PyTorch version on the card, exact on all
   three outputs: both min-plus kernels over the sweep shapes of
   tests/test_kernels.py in f32 and bf16, all-padding rows, a ragged R, K in
   {4, 8, 16, 32, 48} and source blocks that do not divide N; their lane
   axis with B in {1, 2, 8} and one lane entirely +inf; the segment min
   over the sweep shapes, all padding, a tie-heavy case and one large
   shape, (NB, EB, vb) = (8192, 2048, 256), through its public wrapper;
3. the fixed answers of the RMAT scale-10 workload (547.0 / 44 edges /
   10 rounds / 2638 relaxations / 45912 messages) through
   SteinerSolver(SolverConfig(backend="single", mode="pallas")) on the card,
   resident and with src_block=256;
4. RMAT scale 16, 64 seeds: the solve on the card (kernels) against the same
   solve on the CPU (plain path), bit for bit on the Voronoi state, the pair
   tables, the MST, the tree, the counters and the per-round telemetry,
   resident and with src_block=4096 (the blocked kernel's path);
5. RMAT scale 16, serving: one Zipf query stream through
   SteinerServer(g, ServeConfig(mode="pallas", buckets=(8, 16, 32),
   max_batch=8)) on the card and on the CPU, with identical results and
   non-latency counters; then one (8, 16) seed batch through the batch
   backend with src_block=4096, card vs CPU bit for bit;
6. full width, the repo's lvj_1k cell cut to RMAT: prepare, one cold and 3
   warm solves with their times and a stage breakdown; launches equal to
   the rounds; the kernel equal to the plain version at the converged state;
   one more relaxation of the fixpoint improves nothing;
7. serving at full width on phase 6's graph: the stream of
   benchmarks/perf_serve.py (pool 40, 200 queries, Zipf 1.1, seed 0,
   buckets 8/16/32, batch 8, flush every 8); warmup, QPS, fresh and cached
   latency, batches, pad waste, each batch's seconds and rounds, peak device
   memory; the lane kernel launched once a round per batch; for the served
   batch of each bucket with the most distinct lanes, and for one batch of
   eight distinct pool keys, every distinct lane equal to a single solve of
   its row bit for bit;
8. one JSON line with each kernel's launches on its path, its error and
   mismatches against the plain version, and its time beside its bound and
   the plain version's time (the lane kernel at the eight-key batch's
   state, and at B = 1 against the single kernel);
9. last line: {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
IMAX = 2**31 - 1


def log(*a):
    print(*a, flush=True)


def sync():
    import torch

    torch.cuda.synchronize()


def timed(fn, *a, **kw):
    """Result and host seconds of ``fn`` ending in a device synchronize."""
    sync()
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    sync()
    return out, time.perf_counter() - t0


def event_ms(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    fn()  # warm
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def device_profile(fn, wall_s):
    """Device activity of one run of ``fn`` under torch.profiler.

    Sums the device-side events (kernels, copies, fills; one stream, so they
    do not overlap): ``busy_share`` is that time over ``wall_s``, an
    unprofiled run's host time, and ``top_device_ms`` groups it by kernel.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    by_name = {}  # kernel families: names cut to 70 characters
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name[:70]
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    total_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:8]
    return {
        "device_ms": total_us / 1e3,
        "busy_share": total_us / 1e6 / wall_s,
        "top_device_ms": {k: round(v / 1e3, 3) for k, v in top},
    }


class Tally:
    """Mismatches and the largest |m - m_plain| of one kernel's comparisons."""

    def __init__(self):
        self.mismatches = 0
        self.max_abs_err = 0.0
        self.cases = 0

    def compare(self, got, want, what):
        import torch

        sync()
        bad = 0
        for g, w in zip(got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"{what}: {g.dtype}{tuple(g.shape)} vs "
                                     f"{w.dtype}{tuple(w.shape)}")
            bad += int((g != w).sum())
        fin = torch.isfinite(got[0]) & torch.isfinite(want[0])
        if bool(fin.any()):
            err = float((got[0][fin] - want[0][fin]).abs().max())
            self.max_abs_err = max(self.max_abs_err, err)
        self.cases += 1
        self.mismatches += bad
        if bad:
            raise AssertionError(f"{what}: {bad} elements differ from the plain version")


def ell_inputs(R, K, N, seed):
    """The random ELL tiles of tests/test_kernels.py (numpy)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, N, (R, K)).astype(np.int32)
    wgt = np.asarray(rng.uniform(1, 10, (R, K)), np.float32)
    wgt[rng.random((R, K)) < 0.25] = np.inf
    dist = np.where(rng.random(N) < 0.5, rng.uniform(0, 50, N), np.inf).astype(np.float32)
    lab = rng.integers(0, 7, N).astype(np.int32)
    return nbr, wgt, dist, lab


def segmin_inputs(NB, EB, VB, seed, ties=False):
    """The random buckets of tests/test_kernels.py (numpy); ``ties`` draws
    integer candidates in [0, 4) and three labels."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if ties:
        vals = rng.integers(0, 4, (NB, EB)).astype(np.float64)
        lab = rng.integers(0, 3, (NB, EB))
    else:
        vals = rng.uniform(0, 100, (NB, EB))
        lab = rng.integers(0, 9, (NB, EB))
    cand = np.where(rng.random((NB, EB)) < 0.7, vals, np.inf).astype(np.float32)
    ldst = rng.integers(0, VB, (NB, EB)).astype(np.int32)
    src = rng.integers(0, 10**6, (NB, EB)).astype(np.int32)
    return cand, ldst, lab.astype(np.int32), src


def build_query_pool(n, rng, pool_size, buckets):
    """Distinct seed sets, sizes log-uniform over the bucket ladder (a copy
    of benchmarks/perf_serve.py's)."""
    import numpy as np

    lo, hi = 2, max(buckets)
    sizes = np.exp(rng.uniform(np.log(lo), np.log(hi + 1), size=pool_size)).astype(int)
    sizes = np.clip(sizes, lo, hi)
    return [rng.choice(n, size=int(k), replace=False).tolist() for k in sizes]


def zipf_stream(rng, pool_size, num_queries, s):
    """Zipfian rank-popularity sample over pool indices, rank 0 hottest (a
    copy of benchmarks/perf_serve.py's)."""
    import numpy as np

    p = 1.0 / np.arange(1, pool_size + 1) ** s
    p /= p.sum()
    return rng.choice(pool_size, size=num_queries, p=p)


def serve_stream(server, queries, flush_every):
    """Submits ``queries`` in order, flushing every ``flush_every`` and at
    the end; returns the results in submission order and the seconds."""
    t0 = time.perf_counter()
    tickets, results = [], {}
    for i, q in enumerate(queries):
        tickets.append(server.submit(q))
        if (i + 1) % flush_every == 0:
            results.update(server.flush())
    results.update(server.flush())
    return [results[t] for t in tickets], time.perf_counter() - t0


TIMED_STATS = ("qps", "latency_p50_ms", "latency_p99_ms", "fresh_p50_ms", "fresh_p99_ms",
               "cached_p50_ms", "cached_p99_ms")


def phase2_kernels(dev, tally):
    import torch

    from repro_torch.kernels.minplus.minplus import minplus_blocked_call, minplus_call
    from repro_torch.kernels.minplus.ref import minplus_torch

    def on(dtype, nbr, wgt, dist, lab):
        return (torch.from_numpy(nbr).to(dev), torch.from_numpy(wgt).to(dev, dtype),
                torch.from_numpy(dist).to(dev, dtype), torch.from_numpy(lab).to(dev))

    resident = [(128, 4, 64), (256, 8, 300), (512, 16, 1024), (128, 32, 4096),
                (1000, 32, 777), (333, 48, 5000), (4099, 16, 70000)]
    blocked = [(128, 8, 256, 64), (256, 4, 512, 128), (300, 32, 1000, 96),
               (77, 48, 4096, 1000), (2000, 16, 50000, 4096)]
    for dtype in (torch.float32, torch.bfloat16):
        for R, K, N in resident:
            t = on(dtype, *ell_inputs(R, K, N, seed=R + K))
            want = minplus_torch(*t)
            for br in (min(128, R), 256, 1):
                tally["minplus_call"].compare(
                    minplus_call(*t, block_rows=br), want, f"resident {R, K, N} {dtype} br={br}")
        for R, K, N, SB in blocked:
            t = on(dtype, *ell_inputs(R, K, N, seed=N))
            want = minplus_torch(*t)
            for br in (min(128, R), 256):
                tally["minplus_blocked_call"].compare(
                    minplus_blocked_call(*t, block_rows=br, src_block=SB), want,
                    f"blocked {R, K, N, SB} {dtype} br={br}")
    # all-padding rows: the identity triple
    R, K, N = 128, 8, 64
    empty = (torch.zeros((R, K), dtype=torch.int32, device=dev),
             torch.full((R, K), float("inf"), device=dev),
             torch.zeros(N, device=dev), torch.zeros(N, dtype=torch.int32, device=dev))
    ident = (torch.full((R,), float("inf"), device=dev),
             torch.full((R,), IMAX, dtype=torch.int32, device=dev),
             torch.full((R,), IMAX, dtype=torch.int32, device=dev))
    tally["minplus_call"].compare(minplus_call(*empty, block_rows=128), ident, "empty rows")
    tally["minplus_blocked_call"].compare(
        minplus_blocked_call(*empty, block_rows=128, src_block=16), ident, "empty rows")
    # mixed input types (bf16 weights over f32 distances and back)
    nbr, wgt, dist, lab = ell_inputs(500, 32, 2000, seed=9)
    for wd, dd in ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
        t = (torch.from_numpy(nbr).to(dev), torch.from_numpy(wgt).to(dev, wd),
             torch.from_numpy(dist).to(dev, dd), torch.from_numpy(lab).to(dev))
        want = minplus_torch(*t)
        tally["minplus_call"].compare(minplus_call(*t), want, f"mixed {wd}/{dd}")
        tally["minplus_blocked_call"].compare(
            minplus_blocked_call(*t, src_block=300), want, f"mixed {wd}/{dd}")
    # K sweep at a ragged R: narrower, equal to and wider than a warp
    for K in (4, 8, 16, 32, 48):
        t = on(torch.float32, *ell_inputs(1537, K, 3001, seed=K))
        want = minplus_torch(*t)
        tally["minplus_call"].compare(minplus_call(*t, block_rows=256), want, f"K={K}")
        tally["minplus_blocked_call"].compare(
            minplus_blocked_call(*t, block_rows=256, src_block=1000), want, f"K={K}")


def phase2_lanes(dev, tally):
    """The lane axis of both min-plus kernels: (B, N) distances, one launch
    for all lanes, against the plain version; the last lane (or, for B = 1,
    a second case) is entirely unreached."""
    import numpy as np
    import torch

    from repro_torch.kernels.minplus.minplus import minplus_blocked_call, minplus_call
    from repro_torch.kernels.minplus.ref import minplus_torch

    shapes = [(1000, 32, 777, 96), (4099, 16, 70000, 4096), (300, 48, 1000, 1000)]
    for dtype in (torch.float32, torch.bfloat16):
        for R, K, N, SB in shapes:
            nbr, wgt, _, _ = ell_inputs(R, K, N, seed=R)
            for B in (1, 2, 8):
                lanes = [ell_inputs(R, K, N, seed=R + 1 + b)[2:] for b in range(B)]
                dist = np.stack([d for d, _ in lanes])
                lab = np.stack([lb for _, lb in lanes])
                for unreached in ((False, True) if B == 1 else (True,)):
                    d = dist.copy()
                    if unreached:
                        d[-1] = np.inf
                    t = (torch.from_numpy(nbr).to(dev), torch.from_numpy(wgt).to(dev, dtype),
                         torch.from_numpy(d).to(dev, dtype), torch.from_numpy(lab).to(dev))
                    want = minplus_torch(*t)
                    what = f"lanes B={B} {R, K, N} {dtype} unreached={unreached}"
                    tally["minplus_call (lanes)"].compare(
                        minplus_call(*t, block_rows=256), want, "resident " + what)
                    tally["minplus_blocked_call"].compare(
                        minplus_blocked_call(*t, block_rows=128, src_block=SB), want,
                        "blocked " + what)


SEGMIN_PATH_SHAPE = (8192, 2048, 256)  # (NB, EB, vb): 293 MB of inputs and outputs


def phase2_segmin(dev, tally):
    """The segment-min kernel against its plain version, and its own path:
    one call of the public wrapper at SEGMIN_PATH_SHAPE with the launch
    counter set to 0 just before.  Returns that shape's inputs and the
    path's launches."""
    import torch

    from repro_torch.kernels.segmin import segmin as kseg
    from repro_torch.kernels.segmin.ops import segmin_bucketed
    from repro_torch.kernels.segmin.ref import segmin_bucketed_torch

    def on(dtype, cand, ldst, lab, src):
        return (torch.from_numpy(cand).to(dev, dtype), torch.from_numpy(ldst).to(dev),
                torch.from_numpy(lab).to(dev), torch.from_numpy(src).to(dev))

    t_seg = tally["segmin_bucketed_call"]
    for dtype in (torch.float32, torch.bfloat16):
        for NB, EB, VB in [(1, 256, 32), (4, 512, 64), (2, 1000, 128), (8, 64, 256)]:
            t = on(dtype, *segmin_inputs(NB, EB, VB, seed=EB))
            t_seg.compare(segmin_bucketed(*t, vb=VB, edge_block=256),
                          segmin_bucketed_torch(*t, VB), f"segmin {NB, EB, VB} {dtype}")
        t = on(dtype, *segmin_inputs(16, 3000, 40, seed=5, ties=True))
        t_seg.compare(segmin_bucketed(*t, vb=40, edge_block=512),
                      segmin_bucketed_torch(*t, 40), f"segmin ties {dtype}")
    z = torch.zeros((2, 128), dtype=torch.int32, device=dev)
    pad = (torch.full((2, 128), float("inf"), device=dev), z, z, z)
    t_seg.compare(segmin_bucketed(*pad, vb=16, edge_block=128),
                  segmin_bucketed_torch(*pad, 16), "segmin all padding")
    NB, EB, VB = SEGMIN_PATH_SHAPE
    big = on(torch.float32, *segmin_inputs(NB, EB, VB, seed=1))
    kseg.segmin_bucketed_call.launches = 0
    got = segmin_bucketed(*big, vb=VB)
    launches = kseg.segmin_bucketed_call.launches
    t_seg.compare(got, segmin_bucketed_torch(*big, VB), f"segmin {SEGMIN_PATH_SHAPE}")
    return big, launches


def phase3_fixed_answers(dev):
    from repro_torch.core.graph import from_edges
    from repro_torch.data.graphs import rmat_edges, select_seeds
    from repro_torch.solver import SolverConfig, SteinerSolver

    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    seeds = select_seeds(n, src, dst, 16, strategy="uniform", seed=1000)
    g = from_edges(src, dst, w, n, pad_to=8, device=dev)
    for sb in (None, 256):
        cfg = SolverConfig(backend="single", mode="pallas", src_block=sb)
        out = SteinerSolver(cfg, device=dev).prepare(g).solve(seeds)
        t = out.telemetry
        got = (out.total_distance, out.num_edges, t.iterations, t.relaxations, t.messages)
        log(f"phase 3: src_block={sb} -> {got}")
        if got != (547.0, 44, 10, 2638, 45912):
            raise AssertionError(f"scale-10 fixed answers differ: {got}")


def _bitwise(a, b, what):
    import torch

    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
        raise AssertionError(f"{what}: card and CPU differ")


def phase4_card_vs_cpu(dev, counters):
    """Card vs CPU at scale 16.  Fills ``counters[src_block]`` with the
    (resident, blocked) launches of the card's solve and returns the
    blocked solve's handle and converged state (its kernel's timing inputs)."""
    from repro_torch.core import distance_graph as dgmod
    from repro_torch.core.graph import from_edges
    from repro_torch.data.graphs import rmat_edges, select_seeds
    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.solver import SolverConfig, SteinerSolver

    src, dst, w, n = rmat_edges(16, 8, max_weight=100, seed=0)
    seeds = select_seeds(n, src, dst, 64, strategy="uniform", seed=1000)
    out = {}
    for sb in (None, 4096):
        cfg = SolverConfig(backend="single", mode="pallas", src_block=sb)
        runs = {}
        for d in (dev, "cpu"):
            h = SteinerSolver(cfg, device=d).prepare(
                from_edges(src, dst, w, n, pad_to=8, device=d))
            if d == dev:
                kmod.minplus_call.launches = kmod.minplus_blocked_call.launches = 0
            res, secs = timed(h.solve, seeds)
            if d == dev:
                counters[sb] = (kmod.minplus_call.launches, kmod.minplus_blocked_call.launches)
            runs[str(d)] = (h, res, secs)
        (hg, rg, tg), (hc, rc, tc) = runs[str(dev)], runs["cpu"]
        a, b = rg.raw, rc.raw
        for f in ("dist", "lab", "pred"):
            _bitwise(getattr(a.state, f), getattr(b.state, f), f"state.{f}")
        for name, x, y in zip(("dmat", "umat", "vmat"),
                              dgmod.distance_graph(hg.graph, a.state, len(seeds)),
                              dgmod.distance_graph(hc.graph, b.state, len(seeds))):
            _bitwise(x, y, name)
        _bitwise(a.dmat, b.dmat, "result.dmat")
        _bitwise(a.parent, b.parent, "parent")
        for f in ("in_tree_vertex", "path_edge", "bridge_u", "bridge_v", "bridge_w",
                  "bridge_valid", "total_distance", "num_edges"):
            _bitwise(getattr(a.tree, f), getattr(b.tree, f), f"tree.{f}")
        for f in ("iterations", "relaxations", "messages", "history"):
            _bitwise(getattr(a.stats, f), getattr(b.stats, f), f"stats.{f}")
        ta, tb = rg.telemetry, rc.telemetry
        if (ta.iterations, ta.relaxations, ta.messages) != (
                tb.iterations, tb.relaxations, tb.messages) or not (
                ta.per_round == tb.per_round).all():
            raise AssertionError("telemetry: card and CPU differ")
        if (rg.total_distance, rg.num_edges) != (rc.total_distance, rc.num_edges):
            raise AssertionError("solve output: card and CPU differ")
        R = tuple(hg.artifact("ell").nbr.shape)
        log(f"phase 4: scale 16 src_block={sb} ELL {R}: bit-identical; "
            f"D={rg.total_distance} edges={rg.num_edges} rounds={ta.iterations} "
            f"relax={ta.relaxations} msgs={ta.messages}; card {tg:.3f} s, cpu {tc:.3f} s")
        out[sb] = (hg, a.state)
    return out[4096]


def phase5_server_card_vs_cpu(dev):
    """RMAT scale 16: the same query stream through the server on the card
    and on the CPU, then one batch with src_block=4096 through the batch
    backend.  Returns the lane launches of each kernel on the card."""
    import numpy as np
    import torch

    from repro_torch.core.graph import from_edges
    from repro_torch.data.graphs import rmat_edges
    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.serve import ServeConfig, SteinerServer, pad_seed_set
    from repro_torch.solver import SolverConfig, SteinerSolver

    src, dst, w, n = rmat_edges(16, 8, max_weight=100, seed=0)
    buckets = (8, 16, 32)
    rng = np.random.default_rng(0)
    pool = build_query_pool(n, rng, 10, buckets)
    queries = [pool[i] for i in zipf_stream(rng, 10, 24, 1.1)]
    cfg = ServeConfig(mode="pallas", buckets=buckets, max_batch=8)
    runs, launches = {}, {}
    for d in (dev, "cpu"):
        srv = SteinerServer(from_edges(src, dst, w, n, pad_to=8, device=d), cfg, device=d)
        kmod.minplus_call.lane_launches = 0
        results, secs = serve_stream(srv, queries, 8)
        if d == dev:
            launches["minplus_call (lanes)"] = kmod.minplus_call.lane_launches
        runs[str(d)] = ([(r.key, r.bucket, r.total_distance, r.num_edges, r.from_cache)
                         for r in results], srv.stats(), secs)
    (rg, sg, tg), (rc, sc, tc) = runs[str(dev)], runs["cpu"]
    if rg != rc:
        raise AssertionError("server results: card and CPU differ")
    untimed = [{k: v for k, v in st.items() if k not in TIMED_STATS} for st in (sg, sc)]
    if untimed[0] != untimed[1]:
        raise AssertionError(f"server stats: card {untimed[0]} vs CPU {untimed[1]}")
    log(f"phase 5: scale 16 server, {len(queries)} queries: card and CPU identical; "
        f"batches {sg['batches_per_bucket']}, hits {sg['cache_hits']}; card {tg:.3f} s, "
        f"cpu {tc:.3f} s")

    rows = np.stack([pad_seed_set(sorted(set(q))[:16], 16) for q in pool[:8]])
    bcfg = SolverConfig(backend="batch", mode="pallas", src_block=4096)
    outs = {}
    for d in (dev, "cpu"):
        h = SteinerSolver(bcfg, device=d).prepare(from_edges(src, dst, w, n, pad_to=8, device=d))
        kmod.minplus_blocked_call.lane_launches = 0
        outs[str(d)] = h.solve(rows)
        if d == dev:
            launches["minplus_blocked_call"] = kmod.minplus_blocked_call.lane_launches
    a, b = outs[str(dev)], outs["cpu"]
    if launches["minplus_blocked_call"] != a.telemetry.iterations:
        raise AssertionError(f"blocked lane launches {launches['minplus_blocked_call']} != "
                             f"rounds {a.telemetry.iterations}")
    for part, fields in (("state", ("dist", "lab", "pred")),
                         ("tree", ("in_tree_vertex", "path_edge", "bridge_u", "bridge_v",
                                   "bridge_w", "bridge_valid", "total_distance", "num_edges")),
                         ("stats", ("iterations", "relaxations", "messages", "history"))):
        for f in fields:
            _bitwise(getattr(getattr(a.raw, part), f), getattr(getattr(b.raw, part), f),
                     f"batch {part}.{f}")
    _bitwise(a.raw.parent, b.raw.parent, "batch parent")
    _bitwise(a.raw.dmat, b.raw.dmat, "batch dmat")
    if not (torch.equal(torch.from_numpy(a.total_distance), torch.from_numpy(b.total_distance))
            and a.telemetry.relaxations == b.telemetry.relaxations):
        raise AssertionError("batch solve output: card and CPU differ")
    log(f"phase 5: scale 16 batch (8, 16) src_block=4096: bit-identical; rounds "
        f"{a.raw.stats.iterations.tolist()}, {launches['minplus_blocked_call']} blocked "
        f"lane launches")
    return launches


def seeds_dev(seeds, dev):
    import torch

    return torch.as_tensor(seeds, dtype=torch.int32, device=dev)


def bound_ms(R, K, N, dist_bytes=4, wgt_bytes=4):
    """Least time of one relaxation: each input read once, each output
    written once, over the device memory rate (the operations, ~2 a lane,
    are far below the card's rate)."""
    nbytes = R * K * (4 + wgt_bytes) + N * (dist_bytes + 4) + R * 12
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase6_full_width(dev, scale, n_seeds, tally):
    import numpy as np
    import torch

    from repro_torch.core import distance_graph as dgmod
    from repro_torch.core import mst as mstmod
    from repro_torch.core import tree as treemod
    from repro_torch.core.graph import from_edges
    from repro_torch.data.graphs import rmat_edges, select_seeds
    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.kernels.minplus import ops as kops
    from repro_torch.kernels.minplus.ref import minplus_torch
    from repro_torch.solver import SolverConfig, SteinerSolver

    rec = {"scale": scale, "seeds": n_seeds}
    t0 = time.perf_counter()
    src, dst, w, n = rmat_edges(scale, 8, max_weight=100, seed=0)
    seeds = select_seeds(n, src, dst, n_seeds, strategy="uniform", seed=1000)
    rec["host_rmat_s"] = time.perf_counter() - t0
    g_host = (src, dst, w, n)
    cfg = SolverConfig(backend="single", mode="pallas", ell_width=32, max_iters=10_000)
    torch.cuda.reset_peak_memory_stats()

    def prepare():
        g = from_edges(*g_host, pad_to=8, device=dev)
        return SteinerSolver(cfg, device=dev).prepare(g)

    h, rec["prepare_s"] = timed(prepare)
    del src, dst, w
    ell = h.artifact("ell")
    R, K = ell.nbr.shape
    rec.update(n=n, directed_edges=h.graph.num_edges, ell_rows=R, ell_width=K)
    log(f"phase 6: n={n} E={h.graph.num_edges} ELL=({R}, {K}) host RMAT "
        f"{rec['host_rmat_s']:.1f} s, prepare {rec['prepare_s']:.3f} s")

    kmod.minplus_call.launches = kmod.minplus_blocked_call.launches = 0
    solves = []
    for i in range(4):
        out, secs = timed(h.solve, seeds)
        solves.append((out, secs))
    launches = (kmod.minplus_call.launches, kmod.minplus_blocked_call.launches)
    iters = [o.telemetry.iterations for o, _ in solves]
    if launches != (sum(iters), 0):
        raise AssertionError(f"launches {launches} != rounds {iters}")
    first = solves[0][0]
    for o, _ in solves[1:]:
        if (o.total_distance, o.num_edges, o.telemetry.iterations) != (
                first.total_distance, first.num_edges, first.telemetry.iterations):
            raise AssertionError("warm solves disagree with the cold solve")
    t = first.telemetry
    rec.update(
        cold_solve_s=solves[0][1], warm_solve_s=[s for _, s in solves[1:]],
        total_distance=first.total_distance, num_edges=first.num_edges,
        iterations=t.iterations, relaxations=t.relaxations, messages=t.messages,
        launches_per_solve=launches[0] // 4,
    )
    log(f"phase 6: D={first.total_distance} edges={first.num_edges} rounds={t.iterations} "
        f"relax={t.relaxations} msgs={t.messages}; cold {solves[0][1]:.3f} s, warm "
        + ", ".join(f"{s:.3f}" for _, s in solves[1:]) + " s")
    tree = first.raw.tree
    n_vert = int(tree.in_tree_vertex.sum())
    if not (np.isfinite(first.total_distance) and n_vert == first.num_edges + 1
            and bool(tree.in_tree_vertex[seeds_dev(seeds, dev)].all())):
        raise AssertionError("full-width result is not a tree spanning every seed")

    # stage breakdown of one more solve (host clock, synchronized)
    S = len(seeds)
    sd = seeds_dev(seeds, dev)
    (st, stats), rec["t_voronoi_s"] = timed(
        kops.voronoi_cells_pallas, ell, sd, max_iters=cfg.max_iters,
        telemetry_rounds=cfg.telemetry_rounds)
    (dmat, umat, vmat), rec["t_distance_graph_s"] = timed(
        dgmod.distance_graph, h.graph, st, S)

    def mst():
        wm = torch.minimum(dmat.view(S, S), dmat.view(S, S).T)
        wm.fill_diagonal_(float("inf"))
        return mstmod.prim_dense(wm)

    parent, rec["t_prim_s"] = timed(mst)
    tree, rec["t_tree_s"] = timed(treemod.extract_tree, n, st, dmat, umat, vmat, parent, S)
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for f in ("dist", "lab", "pred"):
        if not torch.equal(getattr(st, f), getattr(first.raw.state, f)):
            raise AssertionError(f"breakdown run state.{f} differs")
    log("phase 6: stages voronoi {t_voronoi_s:.3f} s, distance graph "
        "{t_distance_graph_s:.3f} s, prim {t_prim_s:.3f} s, tree {t_tree_s:.3f} s; "
        "peak {peak_mem_gb:.1f} GB".format(**rec))

    rec.update(device_profile(lambda: h.solve(seeds), min(rec["warm_solve_s"])))
    log("phase 6: device busy {busy_share:.3f} of a warm solve; top device time (ms): "
        "{top}".format(busy_share=rec["busy_share"], top=json.dumps(rec["top_device_ms"])))

    # the kernel at the converged state: equal to the plain version, and the
    # fixpoint is stable under one more relaxation
    args = (ell.nbr, ell.wgt, st.dist, st.lab)
    want = minplus_torch(*args)
    tally["minplus_call"].compare(kmod.minplus_call(*args), want, "full width")
    _, upd = kops.relax_ell(ell, st)
    if bool(upd.any()):
        raise AssertionError("one more relaxation of the fixpoint improved a vertex")
    del want
    return rec, h, st


def phase7_serving(dev, h):
    """The perf_serve stream through SteinerServer on phase 6's graph.

    Returns the record, the lane launches of the stream and the (B, N)
    state of a batch of eight distinct pool keys (the lane kernel's
    comparison and timing inputs)."""
    import numpy as np
    import torch

    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.kernels.minplus import ops as kops
    from repro_torch.serve import ServeConfig, SteinerServer
    from repro_torch.serve.plan import canonical_key, pad_seed_set
    from repro_torch.solver import SolverConfig, SteinerSolver

    buckets, pool_size, n_queries, zipf_s, batch, flush_every = (8, 16, 32), 40, 200, 1.1, 8, 8
    g = h.graph
    rng = np.random.default_rng(0)  # perf_serve's --seed 0: pool first, then the stream
    pool = build_query_pool(g.n, rng, pool_size, buckets)
    queries = [pool[i] for i in zipf_stream(rng, pool_size, n_queries, zipf_s)]
    torch.cuda.reset_peak_memory_stats()
    server = SteinerServer(g, ServeConfig(mode="pallas", buckets=buckets, max_batch=batch),
                           device=dev)
    _, warm_s = timed(server.warmup)

    batches, kept = [], {}
    solve = server._handle.solve

    def recorded(seed_batch):  # each batch's seconds and rounds; per bucket, the
        # batch with the most distinct lanes is kept
        t0 = time.perf_counter()
        out = solve(seed_batch)
        sync()
        bucket = seed_batch.shape[1]
        batches.append({"bucket": bucket, "s": time.perf_counter() - t0,
                        "rounds": out.telemetry.iterations,
                        "lane_rounds": out.raw.stats.iterations.tolist()})
        rows = np.array(seed_batch)
        distinct = len(np.unique(rows, axis=0))
        if distinct > kept.get(bucket, (0,))[0]:
            kept[bucket] = (distinct, rows, out)
        return out

    server._handle.solve = recorded
    kmod.minplus_call.launches = kmod.minplus_call.lane_launches = 0
    results, stream_s = serve_stream(server, queries, flush_every)
    lane_launches = kmod.minplus_call.lane_launches
    single_launches = kmod.minplus_call.launches - lane_launches
    rounds = sum(b["rounds"] for b in batches)
    if lane_launches != rounds or single_launches:
        raise AssertionError(f"lane kernel launched {lane_launches} times ({single_launches} "
                             f"single) for {rounds} rounds in {len(batches)} batches")
    st = server.stats()
    rec = {
        "queries": len(queries), "pool": pool_size, "zipf": zipf_s, "buckets": list(buckets),
        "batch": batch, "flush_every": flush_every, "warmup_s": warm_s,
        "stream_s": stream_s, "qps": len(queries) / stream_s,
        "stats": {k: v for k, v in st.items() if k != "batches_per_bucket"},
        "batches_per_bucket": {str(k): v for k, v in st["batches_per_bucket"].items()},
        "batches": batches, "lane_launches": lane_launches, "rounds": rounds,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if not all(np.isfinite(r.total_distance) and r.total_distance >= 0 for r in results):
        raise AssertionError("a served total is not finite")
    log(f"phase 7: {len(queries)} queries in {stream_s:.3f} s (QPS {rec['qps']:.2f}); "
        f"warmup {warm_s:.3f} s; fresh p50/p99 {st['fresh_p50_ms']:.1f}/"
        f"{st['fresh_p99_ms']:.1f} ms, cached p50/p99 {st['cached_p50_ms']:.3f}/"
        f"{st['cached_p99_ms']:.3f} ms; hits {st['cache_hits']}; batches "
        f"{st['batches_per_bucket']}; pad waste {st['pad_waste']:.3f}; peak "
        f"{rec['peak_mem_gb']:.1f} GB")
    log("phase 7: batches (bucket, s, rounds): " + ", ".join(
        f"({b['bucket']}, {b['s']:.3f}, {b['rounds']})" for b in batches))
    log(f"phase 7: {lane_launches} lane-kernel launches for {rounds} rounds in "
        f"{len(batches)} batches of {batch} lanes")

    single = SteinerSolver(SolverConfig(backend="single", mode="pallas"), device=dev).prepare(g)

    def lanes_equal_single(seed_batch, out):
        """Every distinct lane of a batch equals a single solve of its row
        bit for bit; returns the number of distinct lanes."""
        _, firsts = np.unique(seed_batch, axis=0, return_index=True)
        for lane in sorted(firsts.tolist()):
            one = single.solve(seed_batch[lane]).raw
            for part, fields in (("state", ("dist", "lab", "pred")),
                                 ("tree", ("in_tree_vertex", "path_edge", "bridge_u",
                                           "bridge_v", "bridge_w", "bridge_valid",
                                           "total_distance", "num_edges")),
                                 ("stats", ("iterations", "relaxations", "messages",
                                            "history"))):
                for f in fields:
                    x, y = getattr(getattr(one, part), f), getattr(getattr(out.raw, part), f)[lane]
                    if x.dtype != y.dtype or not torch.equal(x, y):
                        raise AssertionError(f"bucket {seed_batch.shape[1]}: lane {lane} "
                                             f"{part}.{f} differs from the single solve")
            if not (torch.equal(one.parent, out.raw.parent[lane])
                    and torch.equal(one.dmat, out.raw.dmat[lane])):
                raise AssertionError(f"bucket {seed_batch.shape[1]}: lane {lane} MST differs "
                                     f"from the single solve")
        return len(firsts)

    # per bucket, the served batch with the most distinct lanes: each of
    # them equals a single solve of its row
    for bucket, (_, seed_batch, out) in sorted(kept.items()):
        n = lanes_equal_single(seed_batch, out)
        log(f"phase 7: bucket {bucket}: {n} distinct lanes of a served batch equal single "
            f"solves bit for bit (lane rounds {out.raw.stats.iterations.tolist()})")
    # eight distinct pool keys in one batch of the largest bucket: every lane
    # is real, so a lane that reads or writes another lane's data shows
    top = max(buckets)
    distinct = np.stack([pad_seed_set(canonical_key(q), top) for q in pool[:batch]])
    out8 = solve(distinct)
    if lanes_equal_single(distinct, out8) != batch:
        raise AssertionError("the first pool keys are not distinct")
    rec["distinct_lane_rounds"] = out8.raw.stats.iterations.tolist()
    log(f"phase 7: {batch} distinct pool keys in one bucket-{top} batch: every lane equals "
        f"a single solve bit for bit (lane rounds {out8.raw.stats.iterations.tolist()})")
    # where one batch's time goes: the largest bucket's kept batch once more,
    # its batched Voronoi loop alone, and a profiler pass for the busy share
    _, seed_batch, out = kept[max(kept)]
    ell = h.artifact("ell")
    sd = torch.as_tensor(seed_batch, device=dev)
    _, rec["breakdown_batch_s"] = timed(solve, seed_batch)
    _, rec["breakdown_voronoi_s"] = timed(kops.voronoi_cells_pallas_lanes, ell, sd,
                                          telemetry_rounds=256)
    prof = device_profile(lambda: solve(seed_batch), rec["breakdown_batch_s"])
    rec.update({f"breakdown_{k}": v for k, v in prof.items()})
    log(f"phase 7: one bucket-{seed_batch.shape[1]} batch {rec['breakdown_batch_s']:.3f} s, "
        f"of which the batched Voronoi loop {rec['breakdown_voronoi_s']:.3f} s; device "
        f"busy {prof['busy_share']:.3f}; top device time (ms): "
        f"{json.dumps(prof['top_device_ms'])}")
    return rec, lane_launches, out8.raw.state


def kernel_times(dev, ell, st, blocked_in, lanes_st, seg_in, tally):
    """ms of each kernel and of the plain version at its path's shape (the
    blocked and the lane kernels are also held against the plain version
    here)."""
    import torch

    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.kernels.minplus.ops import INF, IMAX as IM, _pad_rows
    from repro_torch.kernels.minplus.ref import minplus_torch
    from repro_torch.kernels.segmin.ref import segmin_bucketed_torch
    from repro_torch.kernels.segmin.segmin import segmin_bucketed_call

    R, K = ell.nbr.shape
    N = st.dist.shape[0]
    args = (ell.nbr, ell.wgt, st.dist, st.lab)
    # the lane kernel at B = 1 on the same state: equal to the single kernel,
    # and its time says whether the single kernel is still worth keeping
    args1 = (ell.nbr, ell.wgt, st.dist[None], st.lab[None])
    tally["minplus_call (lanes)"].compare(
        kmod.minplus_call(*args1), tuple(x[None] for x in kmod.minplus_call(*args)),
        "lanes at B=1 vs the single kernel, full width")
    res = {"minplus_call": dict(
        shape=[R, K, N], ms=event_ms(lambda: kmod.minplus_call(*args), 20),
        plain_ms=event_ms(lambda: minplus_torch(*args), 3), bound_ms=bound_ms(R, K, N),
        lanes_b1_ms=event_ms(lambda: kmod.minplus_call(*args1), 20))}
    h16, st16 = blocked_in
    e16 = h16.artifact("ell")
    SB = 4096
    R, K = e16.nbr.shape
    bargs = (e16.nbr, e16.wgt, _pad_rows(st16.dist, SB, INF), _pad_rows(st16.lab, SB, IM))
    N = bargs[2].shape[0]
    tally["minplus_blocked_call"].compare(
        kmod.minplus_blocked_call(*bargs, src_block=SB), minplus_torch(*bargs),
        "blocked at its main-path shape")
    res["minplus_blocked_call"] = dict(
        shape=[R, K, N, SB],
        ms=event_ms(lambda: kmod.minplus_blocked_call(*bargs, src_block=SB), 20),
        plain_ms=event_ms(lambda: minplus_torch(*bargs), 5),
        resident_ms=event_ms(lambda: kmod.minplus_call(*bargs), 20),
        bound_ms=bound_ms(R, K, N))

    # the lane kernel at its serving shape: one served batch's (B, N) state;
    # its plain version runs lane by lane (the (B, R, K) temporaries of one
    # vectorised call would not fit beside the graph)
    R, K = ell.nbr.shape
    B, N = lanes_st.dist.shape
    largs = (ell.nbr, ell.wgt, lanes_st.dist, lanes_st.lab)

    def plain_lanes():
        outs = [minplus_torch(ell.nbr, ell.wgt, lanes_st.dist[b], lanes_st.lab[b])
                for b in range(B)]
        return tuple(torch.stack(x) for x in zip(*outs))

    tally["minplus_call (lanes)"].compare(
        kmod.minplus_call(*largs), plain_lanes(), "lanes at the serving shape")
    res["minplus_call (lanes)"] = dict(
        shape=[R, K, N, B], ms=event_ms(lambda: kmod.minplus_call(*largs), 20),
        plain_ms=event_ms(plain_lanes, 2),
        single_lane_launches_ms=event_ms(lambda: [
            kmod.minplus_call(ell.nbr, ell.wgt, lanes_st.dist[b], lanes_st.lab[b])
            for b in range(B)], 5),
        bound_ms=(R * K * 8 + B * (N * 8 + R * 12)) / HBM_BYTES_PER_S * 1e3)

    NB, EB = seg_in[0].shape
    VB = SEGMIN_PATH_SHAPE[2]
    res["segmin_bucketed_call"] = dict(
        shape=[NB, EB, VB],
        ms=event_ms(lambda: segmin_bucketed_call(*seg_in, vb=VB), 20),
        plain_ms=event_ms(lambda: segmin_bucketed_torch(*seg_in, VB), 5),
        bound_ms=(NB * EB * 16 + NB * VB * 12) / HBM_BYTES_PER_S * 1e3)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=23, help="RMAT scale of phases 6 and 7")
    ap.add_argument("--seeds", type=int, default=1024, help="seeds of phase 6")
    ap.add_argument("--json", default=None, help="also write the record to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _build

    # ---- phase 1: device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    t_start = t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"phase 1: {smi}; torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"kernel build {build_s:.1f} s")

    names = ("minplus_call", "minplus_call (lanes)", "minplus_blocked_call",
             "segmin_bucketed_call")
    tally = {k: Tally() for k in names}
    # ---- phase 2
    t0 = time.perf_counter()
    phase2_kernels(dev, tally)
    phase2_lanes(dev, tally)
    seg_in, seg_launches = phase2_segmin(dev, tally)
    log("phase 2: kernels equal the plain version in "
        + ", ".join(f"{k} {t.cases}" for k, t in tally.items())
        + f" cases ({time.perf_counter() - t0:.1f} s)")
    # ---- phase 3
    phase3_fixed_answers(dev)
    # ---- phase 4 (the blocked kernel's single-query path)
    counters = {}
    blocked_in = phase4_card_vs_cpu(dev, counters)
    if counters[None][0] == 0 or counters[None][1] != 0:
        raise AssertionError(f"resident solve launched {counters[None]}")
    if counters[4096][1] == 0 or counters[4096][0] != 0:
        raise AssertionError(f"blocked solve launched {counters[4096]}")
    # ---- phase 5 (both lane kernels' serving path at scale 16)
    lanes16 = phase5_server_card_vs_cpu(dev)
    if min(lanes16.values()) == 0:
        raise AssertionError(f"scale-16 serving launched {lanes16}")
    # ---- phase 6 (the resident kernel's main path, full width)
    rec, h, st = phase6_full_width(dev, args.scale, args.seeds, tally)
    # ---- phase 7 (the lane kernel's serving path, full width)
    serve_rec, lane_launches, lanes_st = phase7_serving(dev, h)
    if lane_launches == 0:
        raise AssertionError("the served stream launched no lane kernel")
    times = kernel_times(dev, h.artifact("ell"), st, blocked_in, lanes_st, seg_in, tally)
    log(f"kernel times: {json.dumps(times)}")
    log("tolerance: exact (every output of every kernel equals the plain version's; "
        + ", ".join(f"{k}: {t.cases} cases, {t.mismatches} mismatches"
                    for k, t in tally.items()) + ")")

    # ---- phase 8
    launches = {"minplus_call": rec["launches_per_solve"] * 4,
                "minplus_call (lanes)": lane_launches,
                "minplus_blocked_call": counters[4096][1],
                "segmin_bucketed_call": seg_launches}
    minplus_src = "src/repro_torch/kernels/minplus/csrc/minplus.cu"
    sources = {"minplus_call": minplus_src, "minplus_call (lanes)": minplus_src,
               "minplus_blocked_call": minplus_src,
               "segmin_bucketed_call": "src/repro_torch/kernels/segmin/csrc/segmin.cu"}
    replaces = {"minplus_call": "src/repro/kernels/minplus/minplus.py:77",
                "minplus_call (lanes)": "src/repro/kernels/minplus/minplus.py:77",
                "minplus_blocked_call": "src/repro/kernels/minplus/minplus.py:159",
                "segmin_bucketed_call": "src/repro/kernels/segmin/segmin.py:66"}
    kernels = []
    for name in names:
        kt = times[name]
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": tally[name].max_abs_err, "mismatches": tally[name].mismatches,
            "ms": kt["ms"], "plain_ms": kt["plain_ms"], "bound_ms": kt["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "shape": kt["shape"],
        })
    total_s = time.perf_counter() - t_start
    log(f"script {total_s:.1f} s after the imports")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"device": smi, "torch": torch.__version__, "build_s": build_s,
             "full_width": rec, "serving": serve_rec, "scale16_lane_launches": lanes16,
             "kernel_times": times, "kernels": kernels, "seconds": total_s}, indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    # ---- phase 9
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
