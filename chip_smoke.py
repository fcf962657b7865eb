#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # full width: RMAT scale 23, 1024 seeds
    python3 chip_smoke.py --scale 18 # a shorter rehearsal of phases 6 to 9

Phases (any failure raises and the script exits non-zero, printing no
result):

1. device and build: the card's name and power limit, torch's version, the
   seconds nvcc took to build every kernel source of the package, and what
   `nvcc -Xptxas -v` reported for each min-plus kernel (registers, shared
   memory, spills);
2. every kernel against its plain PyTorch version on the card, exact on all
   three outputs: both min-plus kernels over the sweep shapes of
   tests/test_kernels.py in f32 and bf16, all-padding rows (also with eight
   lanes), a ragged R, K in {4, 8, 16, 32, 33, 48} with and without lanes,
   rows too wide to stage (K in {1800, 2500}) with and without lanes,
   mixed bf16/f32 inputs with and without lanes, a tie-heavy input
   (integer weights, distances and labels) and source blocks that do not
   divide N; their lane axis with B in {1, 2, 3, 4, 5, 8, 9, 16, 17} and
   one lane entirely +inf; the blocked kernel also over layouts of one
   source block a slice (one launch a slice), against the plain fold over
   the same layout as well; the segment min over the sweep shapes, all
   padding, a tie-heavy case and one large shape, (NB, EB, vb) = (8192,
   2048, 256), through its public wrapper;
3. the fixed answers of the RMAT scale-10 workload (547.0 / 44 edges and
   each schedule's rounds, relaxations and messages, SCALE10_ANSWERS)
   through SteinerSolver(SolverConfig(backend="single", mode=...)) on the
   card: "pallas" and "pallas" with pallas_frontier, each resident and
   with src_block=256, "dense", "bucket" and "frontier";
4. RMAT scale 16, 64 seeds: the solve on the card against the same solve
   on the CPU (plain path), bit for bit on the Voronoi state, the pair
   tables, the MST, the tree, the counters and the per-round telemetry, in
   every single-device schedule: "pallas" resident and with src_block=4096
   (one launch a round and slice), "dense", "bucket", "frontier" (no
   kernel), and "pallas" with pallas_frontier (one launch a round;
   with src_block=4096, a layout built each round);
5. RMAT scale 16, serving: one Zipf query stream through
   SteinerServer(g, ServeConfig(mode="pallas", buckets=(8, 16, 32),
   max_batch=8)) and through SteinerServer(g, ServeConfig()) (mode
   "bucket") on the card and on the CPU, with identical results and
   non-latency counters; then one (8, 16) seed batch through the batch
   backend with src_block=4096, in modes "dense" and "bucket", and with
   pallas_frontier, card vs CPU bit for bit (blocked lane launches =
   rounds x lane groups x slices; the top-K batch one launch a round);
5b. RMAT scale 16 from a graph store written by the port's build_store,
   card vs CPU bit for bit: SolverConfig(mode="pallas",
   ell_pad_rows=4096) prepared from the store, resident and with
   src_block=4096 (the layout built from the padded ELL), against the
   in-memory solve; an (8, 16) batch from the store (lane launches =
   rounds); a store-backed SteinerServer in modes "pallas" and "bucket"
   through two apply_deltas epochs (answers, epoch reports, invalidated /
   revalidated / warm counts equal); an IncrementalSession through three
   epochs with Prim and with Borůvka, the last equal to a cold frontier
   solve; boruvka_dense on a tie-heavy (1024, 1024) integer table;
6. full width, the repo's lvj_1k cell cut to RMAT: prepare, one cold and 3
   warm solves with their times and a stage breakdown; launches equal to
   the rounds; the kernel equal to the plain version at the converged state;
   one more relaxation of the fixpoint improves nothing; a profiler pass
   with the kernel's device time a launch inside the loop;
7. serving at full width on phase 6's graph: the stream of
   benchmarks/perf_serve.py (pool 40, 200 queries, Zipf 1.1, seed 0,
   buckets 8/16/32, batch 8, flush every 8); warmup, QPS, fresh and cached
   latency, batches, pad waste, each batch's seconds and rounds, peak device
   memory; the lane kernel launched once a round per batch; for the served
   batch of each bucket with the most distinct lanes, and for one batch of
   eight distinct pool keys, every distinct lane equal to a single solve of
   its row bit for bit; a profiler pass of one batch with the lane
   kernel's device time a launch inside the loop;
8. the source-blocked path at full width: phase 6's graph and seeds through
   SolverConfig(..., src_block=4096): prepare (the layout built once), one
   cold and two warm solves, each bit-identical to phase 6's resident solve
   (state, MST, tree, counters, telemetry); blocked launches = rounds x
   slices; a warm solve and its Voronoi stage of both paths in turns
   (resident, blocked, blocked, resident), and a profiler pass
   of the blocked one with the kernel's device time a launch inside the
   loop; then phase 7's batch of eight distinct keys through the
   batch backend with src_block=4096, bit-identical to the resident batch;
9. the other single-device schedules at full width: phase 6's graph and
   seeds through "dense", "bucket", "frontier" (K = 8192) and "pallas"
   with pallas_frontier (K = 131072, see TOPK_KERNEL_K; resident and
   src_block=4096), a cold and a
   warm solve each at phase 6's fixpoint bit for bit; rounds, counters,
   seconds and the Voronoi stage; launches = rounds on the top-K kernel
   path (a layout built each round with src_block); one (8192, 32) tile's
   kernel times beside its bound and its layout build; a profiler pass
   over the first rounds of the top-K kernel loop;
9b. the store-backed path at full width on phase 6's graph: build_store
   from phase 6's host edges into a temporary directory (removed at the
   end; ~1.3 GB), open_store with CRC verification, prepare with
   ell_pad_rows=65536 (28,045 spare rows) and a warm solve bit-identical
   to phase 6's; a store-backed server over phase 7's stream, 50 queries,
   one apply_deltas of 100 records (60 adds, 20 deletes, 20 reweights),
   50 more, every distinct post-bump answer equal to a cold single solve
   of the mutated store; an IncrementalSession (K = 8192) through three
   epochs of 100 records, the last bit-identical to a cold frontier solve;
   then compact of the store (4 segments, 400 records): the compacted CSR
   equal to the effective CSR taken just before, verify_store, and prepare
   of the compacted store (ell_pad_rows=65536) with a warm pallas solve
   bit-identical to the overlay store's; Borůvka beside Prim on phase 6's
   pair table (equal MST weight); peak device memory; obs is on through the
   phase, and its spans are summed by name (the epoch path's breakdown);
10. the paper's distributed engine on one NCCL rank (mesh (1, 1)): the
   lvj_1k preset (mesh1d, bucket, max_iters=10_000, fuse_gather), mode
   "dense", the mesh_frontier preset (K = 8192, ell_width=32), clw_10k's
   knobs at S = 1024 (pair_chunks=8, lab_i16), Borůvka, per-rank telemetry
   (64 rounds; its flight report checked) and mesh2d bucket, each prepared
   from phase 6's graph with a cold and a warm solve whose state and tree
   equal phase 6's single solve (Borůvka's: the single Borůvka tree of that
   state); rounds, counters, prepare, cold and warm seconds; a profiler pass
   of the bucket solve with NCCL's share of device time; the scale-10 fixed
   answers of the mesh rows (547.0; 17 / 2550 / 257061 bucket, 10 / 2248 /
   31047 frontier); scale 16 card against CPU (gloo) bit for bit in every
   config, and from a store with 1D edge, 1D ELL and 2D shards loaded per
   shard; no kernel launched;
10b. observability on the card: the CLIs as processes at scale 16 in phase
   10's shard directory (`python -m repro_torch.graphstore` build with
   --trace and --metrics, partition, append, compact with fewer shard files
   rewritten than there are, verify; `python -m repro_torch.obs validate`),
   each exiting 0; then with obs on: a traced prepare and warm pallas solve
   on phase 6's graph, bit-identical to phase 6's with launches = rounds,
   its trace validated (prepare, prepare:ell_build, solve, 20 synthetic
   round spans, convergence samples; solver_messages_total = the
   telemetry's), its span beside the host clock, and warm solves with obs
   off and on in turns (the overhead); phase 7's eight distinct keys
   through a traced server (the serve spans; phase 7's answers); the
   lvj_1k mesh preset with per-rank telemetry (its rank track; phase 6's
   state and tree, phase 10's counters);
11. a line of launches by path, then one JSON line with each kernel's
   launches on its paths (the top-K ones of phase 9 included), its error and
   mismatches against the plain version, and its time beside its bound and
   the plain version's time (the lane kernel at the eight-key batch's
   state, at B = 1 against the single kernel, and at B = 1, 2, 4, 8 on the
   first lanes of that state; the record packing alone; the blocked kernel
   at full width, single and at the eight-key state, beside the resident
   kernel on the same inputs, the layout's build and its plain fold, over
   a few slice budgets and lane groups (the choice of the package's
   constants), and at its scale-16 shape);
12. last line: {"ok": true, "device": {...}}.

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


MINPLUS_KERNELS = ("minplus_resident_kernel", "minplus_resident_lanes_kernel",
                   "minplus_blocked_kernel", "minplus_blocked_lanes_kernel")


def device_profile(fn, wall_s):
    """Device activity of one run of ``fn`` under torch.profiler.

    Sums the device-side events (kernels, copies, fills; one stream, so they
    do not overlap): ``busy_share`` is that time over ``wall_s``, an
    unprofiled run's host time, and ``top_device_ms`` groups it by kernel.
    ``minplus_ms_per_launch`` is each min-plus kernel's device time
    a launch inside the loop (L2 as the loop leaves it, not warmed by the
    launch before), with ``minplus_launches`` beside it.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    by_name = {}  # kernel families: names cut to 70 characters
    minplus = {}  # kernel -> (launches, us)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name[:70]
            us = e.time_range.elapsed_us()
            by_name[key] = by_name.get(key, 0.0) + us
            for k in MINPLUS_KERNELS:
                if k + "<" in e.name or k + "(" in e.name:
                    n, t = minplus.get(k, (0, 0.0))
                    minplus[k] = (n + 1, t + us)
    total_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:8]
    return {
        "device_ms": total_us / 1e3,
        "nccl_ms": sum(v for k, v in by_name.items() if "nccl" in k.lower()) / 1e3,
        "busy_share": total_us / 1e6 / wall_s,
        "top_device_ms": {k: round(v / 1e3, 3) for k, v in top},
        "minplus_ms_per_launch": {k: t / 1e3 / n for k, (n, t) in minplus.items()},
        "minplus_launches": {k: n for k, (n, _) in minplus.items()},
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


def tie_inputs(R, K, N, seed, B=None):
    """The tie-heavy tiles of tests/_minplus_inputs.py (numpy): integer
    weights 1..3, integer distances and labels 0..2."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, N, (R, K)).astype(np.int32)
    wgt = rng.integers(1, 4, (R, K)).astype(np.float32)
    wgt[rng.random((R, K)) < 0.25] = np.inf
    shape = (N,) if B is None else (B, N)
    dist = rng.integers(0, 3, shape).astype(np.float32)
    dist[rng.random(shape) < 0.2] = np.inf
    lab = rng.integers(0, 3, shape).astype(np.int32)
    return nbr, wgt, dist, lab


def lane_inputs(R, K, N, B, seed):
    """ell_inputs with B lanes of dist/lab (B = None: one (N,) query)."""
    import numpy as np

    nbr, wgt, dist, lab = ell_inputs(R, K, N, seed=seed)
    if B is None:
        return nbr, wgt, dist, lab
    lanes = [ell_inputs(R, K, N, seed=seed + 1 + b)[2:] for b in range(B)]
    return nbr, wgt, np.stack([d for d, _ in lanes]), np.stack([lb for _, lb in lanes])


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


def ptxas_lines(log_text):
    """One line per min-plus kernel from nvcc's ``-Xptxas -v`` output: its
    (demangled) name, registers and shared memory, and spills."""
    import re
    import shutil

    entries, cur = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"entry": m.group(1), "used": "", "spill": ""}
            entries.append(cur)
        elif cur is not None and "spill" in line:
            cur["spill"] = line.strip()
        elif cur is not None and "Used" in line:
            cur["used"] = line.split(":", 1)[1].strip()
    entries = [e for e in entries if "minplus" in e["entry"]]
    if entries and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(e["entry"] for e in entries),
                               capture_output=True, text=True, timeout=60).stdout.split("\n")
        for e, name in zip(entries, names):
            name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
            e["entry"] = name.split("(")[0]
    return [f"{e['entry']}: {e['used']}; {e['spill']}" for e in entries]


def blocked_key(dist):
    return "minplus_blocked_call (lanes)" if dist.dim() == 2 else "minplus_blocked_call"


def check_blocked(tally, t, SB, what, block_rows=256):
    """The blocked kernel on ``t`` against the plain version: through the
    layout its wrapper builds, and over a layout of one source block a
    slice (one launch a lane group and slice), which the plain fold over
    that layout must match as well."""
    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.kernels.minplus.ref import minplus_blocked_torch, minplus_torch

    nbr, wgt, dist, lab = t
    want = minplus_torch(*t)
    key = blocked_key(dist)
    tally[key].compare(kmod.minplus_blocked_call(*t, block_rows=block_rows, src_block=SB),
                       want, what)
    B = dist.shape[0] if dist.dim() == 2 else 1
    layout = kmod.blocked_layout(nbr, wgt, dist.shape[-1], SB, B > 1, budget=8 * SB)
    n0 = kmod.minplus_blocked_call.launches
    tally[key].compare(kmod.minplus_blocked_call(*t, block_rows=block_rows, src_block=SB,
                                                 layout=layout), want, what + ", a block a slice")
    groups = -(-B // kmod.blocked_stride(B))
    if kmod.minplus_blocked_call.launches - n0 != groups * len(layout.slices):
        raise AssertionError(f"{what}: {kmod.minplus_blocked_call.launches - n0} blocked "
                             f"launches for {groups} lane groups x {len(layout.slices)} slices")
    plain = minplus_blocked_torch(layout, dist, lab)
    if not all(bool(torch_equal(a, b)) for a, b in zip(plain, want)):
        raise AssertionError(f"{what}: the plain fold over the layout differs")


def torch_equal(a, b):
    import torch

    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b.to(a.device))


def phase2_kernels(dev, tally):
    import torch

    from repro_torch.kernels.minplus.minplus import (
        minplus_blocked_call,
        minplus_call,
        pack_records,
    )
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
            for br in (min(128, R), 256):
                check_blocked(tally, t, SB, f"blocked {R, K, N, SB} {dtype} br={br}", br)
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
        check_blocked(tally, t, 300, f"mixed {wd}/{dd}")
    # K sweep at a ragged R: narrower, equal to and wider than a warp; K = 33
    # ends the resident kernels' bulk copies off 16 bytes
    for K in (4, 8, 16, 32, 33, 48):
        t = on(torch.float32, *ell_inputs(1537, K, 3001, seed=K))
        want = minplus_torch(*t)
        tally["minplus_call"].compare(minplus_call(*t, block_rows=256), want, f"K={K}")
        check_blocked(tally, t, 1000, f"K={K}")
    for K in (4, 33, 48):
        for B in (3, 8):
            for dtype in (torch.float32, torch.bfloat16):
                t = on(dtype, *lane_inputs(1537, K, 3001, B, seed=K))
                tally["minplus_call (lanes)"].compare(
                    minplus_call(*t, block_rows=256), minplus_torch(*t), f"K={K} B={B} {dtype}")
                check_blocked(tally, t, 1000, f"K={K} B={B} {dtype}")
    # rows too wide for two stages of eight in shared memory: read in place
    for K in (1800, 2500):
        for B in (None, 8):
            for dtype in (torch.float32, torch.bfloat16):
                t = on(dtype, *lane_inputs(37, K, 4001, B, seed=K))
                key = "minplus_call" if B is None else "minplus_call (lanes)"
                tally[key].compare(minplus_call(*t), minplus_torch(*t),
                                   f"wide K={K} B={B} {dtype}")
                check_blocked(tally, t, 1024, f"wide K={K} B={B} {dtype}")
    # all-padding rows in eight lanes
    R, K, N, B = 203, 8, 64, 8
    empty8 = (torch.zeros((R, K), dtype=torch.int32, device=dev),
              torch.full((R, K), float("inf"), device=dev),
              torch.zeros((B, N), device=dev), torch.zeros((B, N), dtype=torch.int32, device=dev))
    ident8 = (torch.full((B, R), float("inf"), device=dev),
              torch.full((B, R), IMAX, dtype=torch.int32, device=dev),
              torch.full((B, R), IMAX, dtype=torch.int32, device=dev))
    tally["minplus_call (lanes)"].compare(minplus_call(*empty8), ident8, "empty rows, 8 lanes")
    tally["minplus_blocked_call (lanes)"].compare(
        minplus_blocked_call(*empty8, src_block=16), ident8, "empty rows, 8 lanes")
    # mixed input types with lanes
    for B in (2, 8):
        nbr, wgt, dist, lab = lane_inputs(500, 32, 2000, B, seed=9)
        for wd, dd in ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
            t = (torch.from_numpy(nbr).to(dev), torch.from_numpy(wgt).to(dev, wd),
                 torch.from_numpy(dist).to(dev, dd), torch.from_numpy(lab).to(dev))
            tally["minplus_call (lanes)"].compare(
                minplus_call(*t), minplus_torch(*t), f"mixed {wd}/{dd} B={B}")
            check_blocked(tally, t, 300, f"mixed {wd}/{dd} B={B}")
    # the record table the resident kernels gather from: the card's pack
    # equals the plain version's (checked here, its time is in the kernels')
    for B in (None, 1, 2, 3, 8, 9, 17):
        for dtype in (torch.float32, torch.bfloat16):
            _, _, dist, lab = lane_inputs(16, 4, 3001, B, seed=11)
            d, lb = torch.from_numpy(dist).to(dtype), torch.from_numpy(lab)
            got = pack_records(d.to(dev), lb.to(dev)).cpu()
            if not torch.equal(got, pack_records(d, lb)):
                raise AssertionError(f"pack_records B={B} {dtype}: card and plain differ")
    # tie-heavy: most minima decided on the label or the neighbor id
    for B in (None, 1, 2, 5, 8):
        for dtype in (torch.float32, torch.bfloat16):
            t = on(dtype, *tie_inputs(1000, 32, 50, seed=3, B=B))
            want = minplus_torch(*t)
            key = "minplus_call" if B is None else "minplus_call (lanes)"
            tally[key].compare(minplus_call(*t, block_rows=64), want, f"ties B={B} {dtype}")
            check_blocked(tally, t, 16, f"ties B={B} {dtype}")


def phase2_lanes(dev, tally):
    """The lane axis of both min-plus kernels: (B, N) distances, one launch
    for all lanes, against the plain version; the last lane (or, for B = 1,
    a second case) is entirely unreached.  Odd B pads the resident kernel's
    record stride."""
    import numpy as np
    import torch

    from repro_torch.kernels.minplus.minplus import minplus_call
    from repro_torch.kernels.minplus.ref import minplus_torch

    shapes = [(1000, 32, 777, 96), (4099, 16, 70000, 4096), (300, 48, 1000, 1000)]
    for dtype in (torch.float32, torch.bfloat16):
        for R, K, N, SB in shapes:
            nbr, wgt, _, _ = ell_inputs(R, K, N, seed=R)
            for B in (1, 2, 3, 4, 5, 8, 9, 16, 17):
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
                    check_blocked(tally, t, SB, "blocked " + what, 128)


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


# The scale-10 answers of every single-device schedule: (total distance, edges,
# rounds, relaxations, messages).  547.0 is BENCH_steiner.json's total for
# every mode; the counters are the JAX package's (tests/test_torch_schedules.py
# holds both packages to them).
SCALE10_ANSWERS = {
    "pallas": (547.0, 44, 10, 2638, 45912),
    "dense": (547.0, 44, 10, 2638, 45912),
    "bucket": (547.0, 44, 17, 2550, 45677),
    "frontier": (547.0, 44, 10, 2638, 46109),
    "pallas_frontier": (547.0, 44, 13, 1770, 141311),
}


def schedule_config(name, **kw):
    """The SolverConfig of one schedule of SCALE10_ANSWERS."""
    from repro_torch.solver import SolverConfig

    if name == "pallas_frontier":
        return SolverConfig(backend="single", mode="pallas", pallas_frontier=True, **kw)
    return SolverConfig(backend="single", mode=name, **kw)


def phase3_fixed_answers(dev):
    from repro_torch.core.graph import from_edges
    from repro_torch.data.graphs import rmat_edges, select_seeds
    from repro_torch.solver import SteinerSolver

    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    seeds = select_seeds(n, src, dst, 16, strategy="uniform", seed=1000)
    g = from_edges(src, dst, w, n, pad_to=8, device=dev)
    for name, want in SCALE10_ANSWERS.items():
        for sb in ((None, 256) if name.startswith("pallas") else (None,)):
            cfg = schedule_config(name, src_block=sb)
            out = SteinerSolver(cfg, device=dev).prepare(g).solve(seeds)
            t = out.telemetry
            got = (out.total_distance, out.num_edges, t.iterations, t.relaxations, t.messages)
            log(f"phase 3: {name} src_block={sb} -> {got}")
            if got != want:
                raise AssertionError(f"scale-10 fixed answers of {name} differ: {got} != {want}")


def _bitwise(a, b, what):
    import torch

    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
        raise AssertionError(f"{what}: card and CPU differ")


PHASE4_RUNS = (("pallas", None), ("pallas", 4096), ("dense", None), ("bucket", None),
               ("frontier", None), ("pallas_frontier", None), ("pallas_frontier", 4096))


def phase4_card_vs_cpu(dev, counters):
    """Card vs CPU at scale 16, every single-device schedule (PHASE4_RUNS).
    Fills ``counters[(schedule, src_block)]`` with the (resident, blocked)
    launches of the card's solve, checks them against its rounds, and
    returns the blocked "pallas" solve's handle and converged state (its
    kernel's timing inputs)."""
    from repro_torch.core import distance_graph as dgmod
    from repro_torch.core.graph import from_edges
    from repro_torch.data.graphs import rmat_edges, select_seeds
    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.solver import SteinerSolver

    src, dst, w, n = rmat_edges(16, 8, max_weight=100, seed=0)
    seeds = select_seeds(n, src, dst, 64, strategy="uniform", seed=1000)
    graphs = {str(d): from_edges(src, dst, w, n, pad_to=8, device=d) for d in (dev, "cpu")}
    out = {}
    for name, sb in PHASE4_RUNS:
        cfg = schedule_config(name, src_block=sb)
        runs = {}
        for d in (dev, "cpu"):
            h = SteinerSolver(cfg, device=d).prepare(graphs[str(d)])
            if d == dev:
                kmod.minplus_call.launches = kmod.minplus_blocked_call.launches = 0
                b0 = kmod.blocked_layout.builds
            res, secs = timed(h.solve, seeds)
            if d == dev:
                counters[name, sb] = (kmod.minplus_call.launches,
                                      kmod.minplus_blocked_call.launches)
                builds = kmod.blocked_layout.builds - b0
            runs[str(d)] = (h, res, secs)
        (hg, rg, tg), (hc, rc, tc) = runs[str(dev)], runs["cpu"]
        a, b = rg.raw, rc.raw
        what = f"{name} src_block={sb}"
        for f in ("dist", "lab", "pred"):
            _bitwise(getattr(a.state, f), getattr(b.state, f), f"{what} state.{f}")
        for x_name, x, y in zip(("dmat", "umat", "vmat"),
                                dgmod.distance_graph(hg.graph, a.state, len(seeds)),
                                dgmod.distance_graph(hc.graph, b.state, len(seeds))):
            _bitwise(x, y, f"{what} {x_name}")
        _bitwise(a.dmat, b.dmat, f"{what} result.dmat")
        _bitwise(a.parent, b.parent, f"{what} parent")
        for f in ("in_tree_vertex", "path_edge", "bridge_u", "bridge_v", "bridge_w",
                  "bridge_valid", "total_distance", "num_edges"):
            _bitwise(getattr(a.tree, f), getattr(b.tree, f), f"{what} tree.{f}")
        for f in ("iterations", "relaxations", "messages", "history"):
            _bitwise(getattr(a.stats, f), getattr(b.stats, f), f"{what} stats.{f}")
        ta, tb = rg.telemetry, rc.telemetry
        if (ta.iterations, ta.relaxations, ta.messages) != (
                tb.iterations, tb.relaxations, tb.messages) or not (
                ta.per_round == tb.per_round).all():
            raise AssertionError(f"{what} telemetry: card and CPU differ")
        if (rg.total_distance, rg.num_edges) != (rc.total_distance, rc.num_edges):
            raise AssertionError(f"{what} solve output: card and CPU differ")
        resident, blocked = counters[name, sb]
        rounds = ta.iterations
        if name == "pallas" and sb is not None:
            slices = len(hg.artifact("blocked_layout").slices)
            ok = (resident, blocked) == (0, rounds * slices)
        elif name == "pallas_frontier" and sb is not None:
            # the wrapper builds each round's tile layout: a launch a slice
            ok = resident == 0 and builds == rounds and blocked >= rounds
        elif name.startswith("pallas"):
            ok = (resident, blocked) == (rounds, 0)
        else:
            ok = (resident, blocked) == (0, 0)
        if not ok:
            raise AssertionError(f"{what}: launches (resident, blocked) {counters[name, sb]}, "
                                 f"{builds} layout builds for {rounds} rounds")
        ell = hg.artifact("ell")
        log(f"phase 4: scale 16 {what} ELL {None if ell is None else tuple(ell.nbr.shape)}: "
            f"bit-identical; D={rg.total_distance} edges={rg.num_edges} rounds={rounds} "
            f"relax={ta.relaxations} msgs={ta.messages}; launches (resident, blocked) "
            f"{counters[name, sb]}; card {tg:.3f} s, cpu {tc:.3f} s")
        out[name, sb] = (hg, a.state)
    return out["pallas", 4096]


def phase5_server_card_vs_cpu(dev):
    """RMAT scale 16: the same query stream through the server on the card
    and on the CPU, in mode "pallas" and with the default ServeConfig()
    (mode "bucket"); then one (8, 16) batch through the batch backend with
    src_block=4096 and in modes "dense", "bucket" and "pallas" with
    pallas_frontier, card vs CPU bit for bit.  Returns the launches of each
    kernel on the card: the lane kernels' on the pallas stream and the
    blocked batch, the single kernel's on the top-K batch."""
    import numpy as np
    import torch

    from repro_torch.core.graph import from_edges
    from repro_torch.data.graphs import rmat_edges
    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.serve import ServeConfig, SteinerServer, pad_seed_set
    from repro_torch.solver import SolverConfig, SteinerSolver

    src, dst, w, n = rmat_edges(16, 8, max_weight=100, seed=0)
    graphs = {str(d): from_edges(src, dst, w, n, pad_to=8, device=d) for d in (dev, "cpu")}
    buckets = (8, 16, 32)
    rng = np.random.default_rng(0)
    pool = build_query_pool(n, rng, 10, buckets)
    queries = [pool[i] for i in zipf_stream(rng, 10, 24, 1.1)]
    launches = {}
    for cfg in (ServeConfig(mode="pallas", buckets=buckets, max_batch=8), ServeConfig()):
        runs = {}
        for d in (dev, "cpu"):
            srv = SteinerServer(graphs[str(d)], cfg, device=d)
            kmod.minplus_call.launches = kmod.minplus_call.lane_launches = 0
            kmod.minplus_blocked_call.launches = 0
            results, secs = serve_stream(srv, queries, 8)
            if d == dev:
                got = (kmod.minplus_call.lane_launches, kmod.minplus_call.launches,
                       kmod.minplus_blocked_call.launches)
            runs[str(d)] = ([(r.key, r.bucket, r.total_distance, r.num_edges, r.from_cache)
                             for r in results], srv.stats(), secs)
        (rg, sg, tg), (rc, sc, tc) = runs[str(dev)], runs["cpu"]
        if rg != rc:
            raise AssertionError(f"server mode={cfg.mode} results: card and CPU differ")
        untimed = [{k: v for k, v in st.items() if k not in TIMED_STATS} for st in (sg, sc)]
        if untimed[0] != untimed[1]:
            raise AssertionError(f"server mode={cfg.mode} stats: card {untimed[0]} vs CPU "
                                 f"{untimed[1]}")
        if cfg.mode == "pallas":
            launches["minplus_call (lanes)"] = got[0]
        elif got != (0, 0, 0):
            raise AssertionError(f"the mode={cfg.mode} server launched kernels: {got}")
        log(f"phase 5: scale 16 server mode={cfg.mode}, {len(queries)} queries: card and CPU "
            f"identical; batches {sg['batches_per_bucket']}, hits {sg['cache_hits']}; lane "
            f"launches {got[0]}; card {tg:.3f} s, cpu {tc:.3f} s")

    rows = np.stack([pad_seed_set(sorted(set(q))[:16], 16) for q in pool[:8]])
    for kw in (dict(mode="pallas", src_block=4096), dict(mode="dense"), dict(mode="bucket"),
               dict(mode="pallas", pallas_frontier=True)):
        bcfg = SolverConfig(backend="batch", **kw)
        outs, secs = {}, {}
        for d in (dev, "cpu"):
            h = SteinerSolver(bcfg, device=d).prepare(graphs[str(d)])
            kmod.minplus_call.launches = kmod.minplus_call.lane_launches = 0
            kmod.minplus_blocked_call.launches = kmod.minplus_blocked_call.lane_launches = 0
            outs[str(d)], secs[str(d)] = timed(h.solve, rows)
            if d == dev:
                got = (kmod.minplus_call.launches, kmod.minplus_call.lane_launches,
                       kmod.minplus_blocked_call.launches, kmod.minplus_blocked_call.lane_launches)
                if kw.get("src_block"):
                    per_round = blocked_launches_per_call(h, len(rows))
        a, b = outs[str(dev)], outs["cpu"]
        rounds = a.telemetry.iterations
        if kw.get("src_block"):
            launches["minplus_blocked_call (lanes)"] = got[3]
            ok = got == (0, 0, rounds * per_round, rounds * per_round)
        elif kw.get("pallas_frontier"):
            # every active lane's rows in one single-query launch a round
            launches["minplus_call (top-K batch)"] = got[0]
            ok = got == (rounds, 0, 0, 0)
        else:
            ok = got == (0, 0, 0, 0)
        if not ok:
            raise AssertionError(f"batch {kw}: launches (resident, lanes, blocked, blocked "
                                 f"lanes) {got} for {rounds} rounds")
        for part, fields in RAW_FIELDS:
            for f in fields:
                _bitwise(getattr(getattr(a.raw, part), f), getattr(getattr(b.raw, part), f),
                         f"batch {kw} {part}.{f}")
        _bitwise(a.raw.parent, b.raw.parent, f"batch {kw} parent")
        _bitwise(a.raw.dmat, b.raw.dmat, f"batch {kw} dmat")
        ta, tb = a.telemetry, b.telemetry
        if not (torch.equal(torch.from_numpy(a.total_distance),
                            torch.from_numpy(b.total_distance))
                and (ta.iterations, ta.relaxations, ta.messages) == (
                    tb.iterations, tb.relaxations, tb.messages)
                and (ta.per_round == tb.per_round).all()):
            raise AssertionError(f"batch {kw} solve output: card and CPU differ")
        log(f"phase 5: scale 16 batch (8, 16) {kw}: bit-identical; lane rounds "
            f"{a.raw.stats.iterations.tolist()}; launches (resident, lanes, blocked, blocked "
            f"lanes) {got}; card {secs[str(dev)]:.3f} s, cpu {secs['cpu']:.3f} s")
    return launches


def delta_records(rng, n, src, dst, adds, deletes, reweights):
    """Edge-delta records in a shuffled order: ``adds`` between uniform
    vertices with weights 1..100, ``deletes`` and ``reweights`` of existing
    edges (the host edge list ``src``/``dst``)."""
    recs = []
    for _ in range(adds):
        u, v = (int(x) for x in rng.integers(0, n, size=2))
        recs.append(("add", u, v if u != v else (v + 1) % n, float(rng.integers(1, 101))))
    for i, j in enumerate(rng.integers(0, len(src), size=deletes + reweights)):
        u, v = int(src[j]), int(dst[j])
        recs.append(("delete", u, v) if i < deletes
                    else ("reweight", u, v, float(rng.integers(1, 101))))
    return [recs[i] for i in rng.permutation(len(recs))]


def recording_solve(server, batches):
    """Wraps the server's batch handle so each batch appends its (bucket,
    seconds, rounds) to ``batches``; the wrapper stays across refreshes."""
    solve = server._handle.solve

    def recorded(seed_batch):
        t0 = time.perf_counter()
        out = solve(seed_batch)
        sync()
        batches.append((seed_batch.shape[1], time.perf_counter() - t0,
                        out.telemetry.iterations))
        return out

    server._handle.solve = recorded


def phase5b_store_card_vs_cpu(dev):
    """RMAT scale 16 from a graph store written by the port's build_store,
    card against CPU bit for bit: prepare(store) in mode "pallas" with
    ell_pad_rows=4096 (resident and src_block=4096) against the in-memory
    solve; a store-backed server in modes "pallas" and "bucket" through two
    apply_deltas epochs (answers, reports and counters equal; lane launches
    = rounds on the padded ELL); an IncrementalSession through three epochs
    with Prim and with Borůvka; boruvka_dense's parent on a tie-heavy
    integer pair table.  Returns the card's kernel launches by path."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import distance_graph as dgmod
    from repro_torch.core.graph import from_edges
    from repro_torch.core.mst import boruvka_dense
    from repro_torch.data.graphs import rmat_edges, select_seeds
    from repro_torch.delta import IncrementalSession
    from repro_torch.graphstore import ArraySource, build_store, open_store
    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.serve import ServeConfig, SteinerServer
    from repro_torch.solver import SolverConfig, SteinerSolver

    src, dst, w, n = rmat_edges(16, 8, max_weight=100, seed=0)
    seeds = select_seeds(n, src, dst, 64, strategy="uniform", seed=1000)
    S = len(seeds)
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_s16_") as tmp:
        def fresh_store(name):
            return open_store(build_store(ArraySource(src, dst, w, n),
                                          Path(tmp) / f"{name}.gstore")[0])

        store = fresh_store("base")
        for sb in (None, 4096):
            cfg = SolverConfig(backend="single", mode="pallas", ell_pad_rows=4096, src_block=sb)
            runs = {}
            for d in (dev, "cpu"):
                h = SteinerSolver(cfg, device=d).prepare(store)
                kmod.minplus_call.launches = kmod.minplus_blocked_call.launches = 0
                res = h.solve(seeds)
                got = (kmod.minplus_call.launches, kmod.minplus_blocked_call.launches)
                runs[str(d)] = (h, res, got)
            (h, a, got), (hc, b, _) = runs[str(dev)], runs["cpu"]
            hm = SteinerSolver(cfg, device=dev).prepare(
                from_edges(src, dst, w, n, pad_to=8, device=dev))
            mem = hm.solve(seeds)
            what = f"store pallas src_block={sb} ell_pad_rows=4096"
            same_raw(a.raw, b.raw, f"{what}: card vs CPU")
            same_raw(a.raw, mem.raw, f"{what}: store vs in-memory graph")
            for x_name, x, y in zip(("dmat", "umat", "vmat"),
                                    dgmod.distance_graph(h.graph, a.raw.state, S),
                                    dgmod.distance_graph(hc.graph, b.raw.state, S)):
                _bitwise(x, y, f"{what} {x_name}")
            ell, rounds = h.artifact("ell"), a.telemetry.iterations
            if sb is None:
                ok = got == (rounds, 0)
            else:
                layout = h.artifact("blocked_layout")
                ok = layout.rows == ell.nbr.shape[0] and got == (0, rounds * len(layout.slices))
            if not ok or ell.nbr.shape[0] % 4096:
                raise AssertionError(f"{what}: launches (resident, blocked) {got} for {rounds} "
                                     f"rounds, ELL {tuple(ell.nbr.shape)}")
            launches[f"store pallas src_block={sb}"] = got
            log(f"phase 5b: scale 16 {what}: ELL {tuple(ell.nbr.shape)} (in memory "
                f"{tuple(hm.artifact('ell').nbr.shape)}); card = CPU = in-memory bit for bit; "
                f"D={a.total_distance} rounds={rounds}; launches (resident, blocked) {got}")

        # the lane kernel on the padded ELL: a batch prepared from the store
        rng = np.random.default_rng(1)
        rows = np.stack([rng.choice(n, 16, replace=False) for _ in range(8)]).astype(np.int32)
        bcfg = SolverConfig(backend="batch", mode="pallas", ell_pad_rows=4096)
        outs = {}
        for d in (dev, "cpu"):
            kmod.minplus_call.launches = kmod.minplus_call.lane_launches = 0
            outs[str(d)] = SteinerSolver(bcfg, device=d).prepare(store).solve(rows)
            if d == dev:
                lane = kmod.minplus_call.lane_launches
        a, b = outs[str(dev)], outs["cpu"]
        same_raw(a.raw, b.raw, "store batch pallas ell_pad_rows=4096: card vs CPU")
        if lane != a.telemetry.iterations:
            raise AssertionError(f"store batch: {lane} lane launches for "
                                 f"{a.telemetry.iterations} rounds")
        launches["store batch lanes"] = lane
        log(f"phase 5b: scale 16 (8, 16) batch from the store, ell_pad_rows=4096: card = CPU "
            f"bit for bit; lane launches {lane} = rounds")

        buckets = (8, 16, 32)
        rng = np.random.default_rng(0)
        pool = build_query_pool(n, rng, 6, buckets)
        queries = [pool[i] for i in zipf_stream(rng, 6, 12, 1.1)]
        epochs = [delta_records(np.random.default_rng(10 + e), n, src, dst, 30, 10, 10)
                  for e in range(2)]
        for mode in ("pallas", "bucket"):
            # four lanes a batch: the CPU's side solves every padding lane too
            cfg = ServeConfig(mode=mode, buckets=buckets, max_batch=4)
            runs = {}
            for i, d in enumerate((dev, "cpu")):
                t0 = time.perf_counter()
                srv = SteinerServer(fresh_store(f"srv_{mode}_{i}"), cfg, device=d)
                batches = []
                recording_solve(srv, batches)
                kmod.minplus_call.launches = kmod.minplus_call.lane_launches = 0
                served = [serve_stream(srv, queries, 4)[0]]
                reports = []
                for recs in epochs:
                    reports.append(srv.apply_deltas(recs))
                    served.append(serve_stream(srv, queries, 4)[0])
                lane = kmod.minplus_call.lane_launches
                runs[str(d)] = ([[(r.key, r.total_distance, r.num_edges, r.from_cache)
                                  for r in part] for part in served], reports,
                                {k: v for k, v in srv.stats().items() if k not in TIMED_STATS},
                                lane, sum(r for _, _, r in batches), time.perf_counter() - t0)
            (ra, pa, sa, lane, rounds, tg), (rb, pb, sb_, _, _, tc) = runs[str(dev)], runs["cpu"]
            if (ra, pa, sa) != (rb, pb, sb_):
                raise AssertionError(f"store server mode={mode}: card and CPU differ")
            if mode == "pallas" and lane != rounds:
                raise AssertionError(f"store server: {lane} lane launches for {rounds} rounds")
            if mode == "bucket" and lane:
                raise AssertionError(f"the mode=bucket store server launched {lane} lane kernels")
            if mode == "pallas":
                launches["store server lanes"] = lane
            log(f"phase 5b: scale 16 store-backed server mode={mode}, {len(queries)} queries "
                f"before and after each of 2 epochs of {len(epochs[0])} records: card and CPU "
                f"identical; reports " + ", ".join(
                    f"(epoch {r['epoch']}, invalidated {r['invalidated']}, revalidated "
                    f"{r['revalidated']})" for r in pa)
                + f"; warm re-solves {sa['warm_resolves']}; lane launches {lane} = rounds; "
                f"card {tg:.3f} s, cpu {tc:.3f} s")

        for algo in ("prim", "boruvka"):
            sess, cold_s = {}, {}
            for i, d in enumerate((dev, "cpu")):
                store_i = fresh_store(f"inc_{algo}_{i}")
                sess[str(d)], cold_s[str(d)] = timed(lambda: IncrementalSession(
                    store_i, seeds, ell_pad_rows=4096, frontier_size=1024, mst_algo=algo,
                    device=d))
            a, b = sess[str(dev)], sess["cpu"]
            rows = []
            for e in range(3):
                recs = delta_records(np.random.default_rng(20 + e), n, src, dst, 30, 10, 10)
                (ra, ta), (rb, tb) = timed(a.apply_deltas, recs), timed(b.apply_deltas, recs)
                if dataclasses.asdict(ra) != dataclasses.asdict(rb):
                    raise AssertionError(f"session {algo} epoch {e}: {ra} vs {rb}")
                for f in ("dist", "lab", "pred"):
                    _bitwise(getattr(a.state, f), getattr(b.state, f), f"session {algo} {f}")
                if not (np.array_equal(a.parent, b.parent) and np.array_equal(a.dmat, b.dmat)):
                    raise AssertionError(f"session {algo} epoch {e}: MST or pair tables differ")
                rows.append((ra.epoch, ra.affected_cells, ra.vertices_reset, ra.iterations,
                             round(ta, 3), round(tb, 3)))
            cold = SteinerSolver(SolverConfig(mode="frontier", mst_algo=algo), device=dev
                                 ).prepare(a.store).solve(seeds)
            if (cold.total_distance, cold.num_edges) != (ra.total_distance, ra.num_edges) or not (
                    np.array_equal(cold.raw.parent.cpu().numpy(), a.parent)):
                raise AssertionError(f"session {algo}: the last epoch differs from a cold solve")
            log(f"phase 5b: scale 16 IncrementalSession mst_algo={algo}: 3 epochs card = CPU bit "
                f"for bit and = a cold frontier solve; cold construction card "
                f"{cold_s[str(dev)]:.3f} s, cpu {cold_s['cpu']:.3f} s; (epoch, cells, reset, "
                f"rounds, card s, cpu s) {rows}")

    rng = np.random.default_rng(3)
    W = rng.integers(1, 5, (1024, 1024)).astype(np.float32)
    W[rng.random(W.shape) < 0.2] = np.inf
    W = np.minimum(W, W.T)
    np.fill_diagonal(W, np.inf)
    want = boruvka_dense(torch.from_numpy(W))
    _bitwise(boruvka_dense(torch.from_numpy(W).to(dev)), want, "boruvka_dense parent (ties)")
    log("phase 5b: boruvka_dense on a (1024, 1024) tie-heavy integer table: card = CPU")
    return launches


def blocked_launches_per_call(h, lanes):
    """Blocked launches of one relaxation of ``lanes`` lanes on the prepared
    handle ``h``: one a lane group and slice of its layout."""
    from repro_torch.kernels.minplus.minplus import blocked_stride
    from repro_torch.solver.backends import blocked_layout_cached

    layout = blocked_layout_cached(h.artifact("ell"), h.config, lanes)
    return -(-lanes // blocked_stride(lanes)) * len(layout.slices)


def seeds_dev(seeds, dev):
    import torch

    return torch.as_tensor(seeds, dtype=torch.int32, device=dev)


def bound_ms(R, K, N, dist_bytes=4, wgt_bytes=4):
    """Least time of one relaxation: each input read once, each output
    written once, over the device memory rate (the operations, ~2 a lane,
    are far below the card's rate)."""
    nbytes = R * K * (4 + wgt_bytes) + N * (dist_bytes + 4) + R * 12
    return nbytes / HBM_BYTES_PER_S * 1e3


def layout_bound_ms(layout, B, dist_bytes=4):
    """Least time of one blocked relaxation of B lanes over ``layout``: its
    live slots (neighbor and weight) and its run table (row and offset)
    read once, each lane's dist and lab read once, each lane's output
    triple written once, over the device memory rate.  The layout is the
    blocked kernel's input in place of the ELL, whose padding slots it
    never reads."""
    slots = int(layout.run_off[layout.num_runs])
    nbytes = (slots * (4 + layout.slot_wgt.element_size()) + layout.num_runs * 12
              + B * layout.n * (dist_bytes + 4) + B * layout.rows * 12)
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
    kmod.pack_records.launches = 0
    solves = []
    for i in range(4):
        out, secs = timed(h.solve, seeds)
        solves.append((out, secs))
    launches = (kmod.minplus_call.launches, kmod.minplus_blocked_call.launches)
    iters = [o.telemetry.iterations for o, _ in solves]
    if launches != (sum(iters), 0) or kmod.pack_records.launches != sum(iters):
        raise AssertionError(f"launches {launches} (record packs "
                             f"{kmod.pack_records.launches}) != rounds {iters}")
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
    log(f"phase 6: in-loop device ms a launch {json.dumps(rec['minplus_ms_per_launch'])} "
        f"over {json.dumps(rec['minplus_launches'])} launches")

    # the kernel at the converged state: equal to the plain version, and the
    # fixpoint is stable under one more relaxation
    args = (ell.nbr, ell.wgt, st.dist, st.lab)
    want = minplus_torch(*args)
    tally["minplus_call"].compare(kmod.minplus_call(*args), want, "full width")
    _, upd = kops.relax_ell(ell, st)
    if bool(upd.any()):
        raise AssertionError("one more relaxation of the fixpoint improved a vertex")
    del want
    return rec, h, st, (seeds, first), g_host


RAW_FIELDS = (("state", ("dist", "lab", "pred")),
              ("tree", ("in_tree_vertex", "path_edge", "bridge_u", "bridge_v", "bridge_w",
                        "bridge_valid", "total_distance", "num_edges")),
              ("stats", ("iterations", "relaxations", "messages", "history")))


def same_raw(a, b, what):
    """Two SteinerResults (raw solve outputs) equal bit for bit."""
    for part, fields in RAW_FIELDS:
        for f in fields:
            if not torch_equal(getattr(getattr(a, part), f), getattr(getattr(b, part), f)):
                raise AssertionError(f"{what}: {part}.{f} differs")
    for f in ("parent", "dmat"):
        if not torch_equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"{what}: {f} differs")


def phase8_blocked_full_width(dev, h, single_in, batch_in):
    """The source-blocked path at full width, against the resident solves of
    phases 6 and 7.  Returns the record, the blocked single handle and the
    launches of its solves and of the blocked batch."""
    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.kernels.minplus import ops as kops
    from repro_torch.solver import SteinerSolver

    seeds, resident = single_in
    distinct, out8, bcfg = batch_in
    cfg = h.config.replace(src_block=4096)
    b0 = kmod.blocked_layout.builds
    hb, prep_s = timed(lambda: SteinerSolver(cfg, device=dev).prepare(h.graph))
    layout = hb.artifact("blocked_layout")
    rec = {"prepare_s": prep_s, "slices": len(layout.slices), "slice_width": layout.slice_width,
           "runs": layout.num_runs, "live_slots": int(layout.run_off[-1])}
    kmod.minplus_call.launches = kmod.minplus_blocked_call.launches = 0
    kmod.minplus_blocked_call.lane_launches = 0
    solves = [timed(hb.solve, seeds) for _ in range(3)]
    launches = kmod.minplus_blocked_call.launches
    rounds = sum(o.telemetry.iterations for o, _ in solves)
    if launches != rounds * len(layout.slices) or kmod.minplus_call.launches:
        raise AssertionError(f"blocked launches {launches} (resident "
                             f"{kmod.minplus_call.launches}) != {rounds} rounds x "
                             f"{len(layout.slices)} slices")
    for i, (o, _) in enumerate(solves):
        same_raw(o.raw, resident.raw, f"blocked solve {i} vs the resident solve")
        t, r = o.telemetry, resident.telemetry
        if (t.iterations, t.relaxations, t.messages) != (r.iterations, r.relaxations,
                                                         r.messages) or not (
                t.per_round == r.per_round).all():
            raise AssertionError(f"blocked solve {i}: telemetry differs")
    rec.update(cold_solve_s=solves[0][1], warm_solve_s=[s for _, s in solves[1:]],
               launches=launches, rounds=rounds)
    log(f"phase 8: src_block=4096 prepare {prep_s:.3f} s (layout: {len(layout.slices)} slices "
        f"of {layout.slice_width} vertices, {layout.num_runs} runs, {rec['live_slots']} live "
        f"slots); cold {solves[0][1]:.3f} s, warm "
        + ", ".join(f"{s:.3f}" for _, s in solves[1:])
        + f" s; bit-identical to the resident solve; {launches} launches = {rounds} rounds x "
        f"{len(layout.slices)} slices")
    # warm solves and their Voronoi stage alone (the kernels' loop; the
    # tail is the same), the two paths in turns: resident, blocked, blocked,
    # resident
    ell, sd = h.artifact("ell"), seeds_dev(seeds, dev)
    turns = {"resident": [], "blocked": []}
    loops = {"resident": [], "blocked": []}
    for path in ("resident", "blocked", "blocked", "resident"):
        sb, lay = (4096, layout) if path == "blocked" else (None, None)
        turns[path].append(timed((hb if sb else h).solve, seeds)[1])
        _, secs = timed(kops.voronoi_cells_pallas, ell, sd, src_block=sb, layout=lay,
                        max_iters=cfg.max_iters, telemetry_rounds=cfg.telemetry_rounds)
        loops[path].append(secs)
    rec["solve_in_turns_s"], rec["t_voronoi_s"] = turns, loops
    log("phase 8: in turns, warm solve (s): resident " + ", ".join(
        f"{x:.3f}" for x in turns["resident"]) + "; blocked " + ", ".join(
        f"{x:.3f}" for x in turns["blocked"]) + "; its Voronoi stage: resident " + ", ".join(
        f"{x:.4f}" for x in loops["resident"]) + "; blocked " + ", ".join(
        f"{x:.4f}" for x in loops["blocked"]))
    prof = device_profile(lambda: kops.voronoi_cells_pallas(
        ell, sd, src_block=4096, layout=layout, max_iters=cfg.max_iters,
        telemetry_rounds=cfg.telemetry_rounds), min(loops["blocked"]))
    rec.update({f"profile_{k}": v for k, v in prof.items()})
    log(f"phase 8: device busy {prof['busy_share']:.3f} of the blocked Voronoi stage; in-loop "
        f"device ms a launch {json.dumps(prof['minplus_ms_per_launch'])} over "
        f"{json.dumps(prof['minplus_launches'])} launches")

    hbb = SteinerSolver(bcfg.replace(src_block=4096), device=dev).prepare(h.graph)
    kmod.minplus_blocked_call.lane_launches = 0
    outb, rec["batch_s"] = timed(hbb.solve, distinct)
    lane_launches = kmod.minplus_blocked_call.lane_launches
    per_round = blocked_launches_per_call(hbb, len(distinct))
    if lane_launches != outb.telemetry.iterations * per_round:
        raise AssertionError(f"blocked lane launches {lane_launches} != rounds "
                             f"{outb.telemetry.iterations} x {per_round}")
    same_raw(outb.raw, out8.raw, "blocked batch vs the resident batch")
    if kmod.blocked_layout.builds != b0 + 2:  # one lane, and a lane axis
        raise AssertionError(f"{kmod.blocked_layout.builds - b0} layout builds for two "
                             "prepared handles (one lane and a lane axis), not 2")
    rec.update(batch_lane_launches=lane_launches, batch_rounds=outb.telemetry.iterations,
               batch_launches_per_round=per_round)
    log(f"phase 8: the {len(distinct)}-key bucket-{distinct.shape[1]} batch with src_block=4096 "
        f"in {rec['batch_s']:.3f} s: bit-identical to the resident batch; {lane_launches} lane "
        f"launches = {outb.telemetry.iterations} rounds x {per_round}; "
        f"{kmod.blocked_layout.builds - b0} layout builds")
    return rec, hb, launches, lane_launches


FULL_WIDTH_K = 8192  # frontier_size of the repo's mesh_frontier preset
# frontier_size of the top-K kernel schedule at full width: at K = 8192 it
# needs 62,848 rounds here (~4 min a solve; PERF.md), so its four solves
# run at the smallest power of two that keeps the phase near 90 s
# (--topk-kernel-k 8192 runs them at 8192)
TOPK_KERNEL_K = 131072
FULL_WIDTH_RUNS = (("dense", None), ("bucket", None), ("frontier", None),
                   ("pallas_frontier", None), ("pallas_frontier", 4096))
PROFILE_ROUNDS = 400  # the window of the top-K kernel loop under the profiler


def same_fixpoint(a, b, what):
    """Two SteinerResults with the same Voronoi state, MST and tree."""
    for part, fields in RAW_FIELDS[:2]:
        for f in fields:
            if not torch_equal(getattr(getattr(a, part), f), getattr(getattr(b, part), f)):
                raise AssertionError(f"{what}: {part}.{f} differs")
    for f in ("parent", "dmat"):
        if not torch_equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"{what}: {f} differs")


def frontier_tile(dev, ell, st, tally, K):
    """One (K, k) tile of ELL rows (drawn uniformly, seed 0)
    against the full-width fixpoint, as the top-K schedules hand it to the
    kernels: both kernels against the plain version, their times beside the
    tile's bound, the record packing alone (a full (N,) table every call),
    and the blocked kernel's layout build, which its wrapper repeats every
    round of a top-K solve with src_block."""
    import torch

    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.kernels.minplus.ref import minplus_torch

    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = torch.randperm(ell.nbr.shape[0], generator=gen)[:K].to(dev)
    tnbr, twgt = ell.nbr[rows], ell.wgt[rows]
    K, k = tnbr.shape
    N = st.dist.shape[0]
    args = (tnbr, twgt, st.dist, st.lab)
    want = minplus_torch(*args)
    tally["minplus_call"].compare(kmod.minplus_call(*args), want, "frontier tile")
    tally["minplus_blocked_call"].compare(
        kmod.minplus_blocked_call(*args, src_block=4096), want, "frontier tile, blocked")
    live = torch.isfinite(twgt)
    slots, nbrs = int(live.sum()), int(tnbr[live].unique().numel())
    # each slot (id and weight) read once, the dist and lab of each distinct
    # neighbor once, the (K,) output triple written once
    nbytes = K * k * 8 + nbrs * 8 + K * 12
    lay = kmod.blocked_layout(tnbr, twgt, N, 4096)
    return dict(
        shape=[K, k, N], live_slots=slots, distinct_neighbors=nbrs,
        ms=event_ms(lambda: kmod.minplus_call(*args), 20),
        pack_ms=event_ms(lambda: kmod.pack_records(st.dist, st.lab), 20),
        plain_ms=event_ms(lambda: minplus_torch(*args), 5),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        blocked_ms=event_ms(lambda: kmod.minplus_blocked_call(*args, src_block=4096), 10),
        blocked_slices=len(lay.slices),
        blocked_prebuilt_ms=event_ms(
            lambda: kmod.minplus_blocked_call(*args, src_block=4096, layout=lay), 20),
        layout_build_ms=event_ms(lambda: kmod.blocked_layout(tnbr, twgt, N, 4096), 10))


def stage(name, cfg, handle, sd):
    """The Voronoi stage alone of a "dense", "bucket" or "frontier" solve."""
    from repro_torch.core import voronoi as vmod

    if name == "frontier":
        return vmod.voronoi_cells_frontier(
            handle.artifact("ell"), sd, frontier_size=cfg.frontier_size,
            max_rounds=cfg.max_iters, telemetry_rounds=cfg.telemetry_rounds)
    return vmod.voronoi_cells(handle.graph, sd, mode=name, delta=cfg.delta,
                              max_iters=cfg.max_iters, telemetry_rounds=cfg.telemetry_rounds)


def phase9_schedules_full_width(dev, h, single_in, tally, topk_k=TOPK_KERNEL_K):
    """Phase 6's graph and seeds through every other single-device schedule
    (FULL_WIDTH_RUNS; the frontier at K = FULL_WIDTH_K, the top-K kernel
    schedule at K = ``topk_k``): a cold and a
    warm solve each, both at phase 6's fixpoint bit for bit (state, MST,
    tree); rounds, counters, seconds and the Voronoi stage (the warm solve
    less its tail, timed alone on the same state); kernel launches against
    the rounds; a (K, 32) tile's times; a profiler pass over the first
    PROFILE_ROUNDS rounds of the resident top-K loop.  Returns the record
    and the kernels' launches by path."""
    import math

    from repro_torch.core import steiner as smod
    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.kernels.minplus import ops as kops
    from repro_torch.solver import SteinerSolver

    seeds, ref = single_in
    g, S = h.graph, len(seeds)
    rec, launches = {}, {}
    t_phase = time.perf_counter()
    for name, sb in FULL_WIDTH_RUNS:
        # the top-K kernel schedule needs more than phase 6's 10,000 rounds
        # at this width (its cap is then the schedule's own, 16n + 64)
        max_iters = None if name == "pallas_frontier" else h.config.max_iters
        K = topk_k if name == "pallas_frontier" else FULL_WIDTH_K
        cfg = schedule_config(name, src_block=sb, ell_width=h.config.ell_width,
                              max_iters=max_iters, frontier_size=K)
        hs, prep_s = timed(lambda: SteinerSolver(cfg, device=dev).prepare(g))
        kmod.minplus_call.launches = kmod.minplus_blocked_call.launches = 0
        b0 = kmod.blocked_layout.builds
        cold, cold_s = timed(hs.solve, seeds)
        warm, warm_s = timed(hs.solve, seeds)
        got = (kmod.minplus_call.launches, kmod.minplus_blocked_call.launches)
        builds = kmod.blocked_layout.builds - b0
        what = f"{name} src_block={sb}"
        t, tw = cold.telemetry, warm.telemetry
        if (t.iterations, t.relaxations, t.messages) != (
                tw.iterations, tw.relaxations, tw.messages) or not (
                t.per_round == tw.per_round).all():
            raise AssertionError(f"{what}: the warm solve's telemetry differs from the cold's")
        for o, when in ((cold, "cold"), (warm, "warm")):
            same_fixpoint(o.raw, ref.raw, f"{what} {when} solve vs phase 6's fixpoint")
        rounds = t.iterations
        if max_iters is not None and rounds >= max_iters:
            raise AssertionError(f"{what}: {rounds} rounds reach the cap {max_iters}")
        if name == "pallas_frontier" and sb is not None:
            most = math.ceil(g.n / kmod.slice_width(g.n, sb, kmod.L2_BUDGET))
            ok = got[0] == 0 and builds == 2 * rounds and 2 * rounds <= got[1] <= 2 * rounds * most
            launches[f"minplus_blocked_call ({name})"] = got[1]
        elif name == "pallas_frontier":
            ok = got == (2 * rounds, 0)
            launches[f"minplus_call ({name})"] = got[0]
        else:
            ok = got == (0, 0)
        if not ok:
            raise AssertionError(f"{what}: launches (resident, blocked) {got}, {builds} layout "
                                 f"builds for 2 x {rounds} rounds")
        _, tail_s = timed(smod.finish_pipeline, g, warm.raw.state, warm.raw.stats, S)
        if name == "pallas_frontier":
            # the warm solve less its tail (the stage is ~100x the tail here;
            # a third run would double the phase)
            voronoi_s, how = warm_s - tail_s, "the warm solve less its tail"
        else:
            _, voronoi_s = timed(stage, name, cfg, hs, seeds_dev(seeds, dev))
            how = "timed alone"
        key = name if sb is None else f"{name} src_block={sb}"
        rec[key] = dict(K=K, max_iters=max_iters, prepare_s=prep_s, cold_solve_s=cold_s,
                        warm_solve_s=warm_s, tail_s=tail_s, voronoi_s=voronoi_s,
                        voronoi_how=how, iterations=rounds, relaxations=t.relaxations,
                        messages=t.messages, launches=got, layout_builds=builds)
        log(f"phase 9: {what} (K={K}, max_iters={max_iters}): phase 6's fixpoint "
            f"bit for bit; rounds={rounds} relax={t.relaxations} msgs={t.messages}; cold "
            f"{cold_s:.3f} s, warm {warm_s:.3f} s; tail {tail_s:.3f} s; Voronoi stage "
            f"{voronoi_s:.3f} s ({how}; {voronoi_s / rounds * 1e3:.3f} ms a round); launches "
            f"(resident, blocked) {got}, layout builds {builds}")
        del hs, cold, warm
    ell, st = h.artifact("ell"), ref.raw.state
    for K in (FULL_WIDTH_K, topk_k):
        rec[f"tile_{K}"] = frontier_tile(dev, ell, st, tally, K)
        log(f"phase 9: a ({K}, {ell.nbr.shape[1]}) tile: {json.dumps(rec[f'tile_{K}'])}")
    sd = seeds_dev(seeds, dev)

    def window():
        return kops.voronoi_cells_pallas_frontier(ell, sd, frontier_size=topk_k,
                                                  max_iters=PROFILE_ROUNDS)

    _, wall = timed(window)
    prof = device_profile(window, wall)
    rec["profile"] = dict(rounds=PROFILE_ROUNDS, wall_s=wall, **prof)
    log(f"phase 9: the first {PROFILE_ROUNDS} rounds of the top-K kernel loop (K={topk_k}): "
        f"{wall:.3f} s, "
        f"device busy {prof['busy_share']:.3f}; top device time (ms): "
        f"{json.dumps(prof['top_device_ms'])}; in-loop device ms a launch "
        f"{json.dumps(prof['minplus_ms_per_launch'])} over "
        f"{json.dumps(prof['minplus_launches'])} launches")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 9: {rec['phase_s']:.1f} s")
    return rec, launches


def mst_weight(W, parent):
    """Total weight of an MST parent array over the symmetric (S, S) table
    ``W`` (host f64 sum; the root row adds nothing)."""
    import numpy as np

    kids = np.nonzero(parent != np.arange(len(parent)))[0]
    return float(W[kids, parent[kids]].astype(np.float64).sum())


SERVED = 50  # queries of phase 7's stream served before and after the deltas


def span_sums(tracer):
    """Seconds and count of the recorded spans by name (the synthetic round
    spans, which subdivide their solve span, left out), longest first."""
    sums = {}
    for e in tracer.events():
        if e["ph"] == "X" and not e.get("args", {}).get("synthetic_timing"):
            s, k = sums.get(e["name"], (0.0, 0))
            sums[e["name"]] = (s + e["dur"] / 1e6, k + 1)
    return dict(sorted(sums.items(), key=lambda kv: -kv[1][0]))


def compact_full_width(dev, store, path, seeds, pad_rows):
    """Phase 9b's compaction: the store with its four segments (the
    server's epoch and the session's three) folded by ``compact``; the
    compacted CSR equal to the effective CSR taken just before, bit for bit;
    ``verify_store``; and ``prepare`` of the compacted store with the same
    ``ell_pad_rows`` plus a warm pallas solve, bit-identical to the overlay
    store's.  Returns the record and the min-plus launches."""
    import numpy as np

    from repro_torch.delta import compact
    from repro_torch.graphstore import verify_store
    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.solver import SolverConfig, SteinerSolver

    rec = {}
    cfg = SolverConfig(backend="single", mode="pallas", ell_width=32, max_iters=10_000,
                       ell_pad_rows=pad_rows)
    n0 = kmod.minplus_call.launches
    ho, rec["overlay_prepare_s"] = timed(lambda: SteinerSolver(cfg, device=dev).prepare(store))
    timed(ho.solve, seeds)
    overlay, rec["overlay_warm_s"] = timed(ho.solve, seeds)
    eff = store.effective_csr()  # folded by the prepare above (cached on the store)
    segments = len(store.manifest.get("deltas", ()))
    del ho
    stats, rec["compact_s"] = timed(compact, store)
    rec["stats"] = {k: getattr(stats, k) for k in (
        "epoch", "segments_folded", "records_folded", "m_before", "m_after", "seconds")}
    if not (stats.segments_folded == segments == 4 and stats.records_folded == 400
            and stats.m_after == eff[1].shape[0] == store.m and stats.seconds > 0
            and store.overlay is None and stats.epoch == store.epoch):
        raise AssertionError(f"compact: {rec['stats']} ({segments} segments, effective m "
                             f"{eff[1].shape[0]}, store m {store.m})")
    for name, want in zip(("indptr", "indices", "weights"), eff):
        got = np.asarray(store.array(name))
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"compacted {name} differs from the effective CSR")
    del eff
    _, rec["verify_s"] = timed(verify_store, path)
    hc, rec["compacted_prepare_s"] = timed(lambda: SteinerSolver(cfg, device=dev).prepare(store))
    timed(hc.solve, seeds)
    compacted, rec["compacted_warm_s"] = timed(hc.solve, seeds)
    same_raw(compacted.raw, overlay.raw, "the compacted store's warm solve vs the overlay's")
    rows = hc.artifact("ell").nbr.shape[0]
    log(f"phase 9b: compact {rec['compact_s']:.3f} s ({stats.segments_folded} segments, "
        f"{stats.records_folded} records folded, m {stats.m_before} -> {stats.m_after}, epoch "
        f"{stats.epoch}); the compacted CSR = the effective CSR bit for bit; verify_store "
        f"{rec['verify_s']:.3f} s; prepare (ELL {rows} rows) overlay "
        f"{rec['overlay_prepare_s']:.3f} s, compacted {rec['compacted_prepare_s']:.3f} s; warm "
        f"pallas solve overlay {rec['overlay_warm_s']:.3f} s, compacted "
        f"{rec['compacted_warm_s']:.3f} s: state, MST, tree, counters and rows bit for bit")
    return rec, kmod.minplus_call.launches - n0


def phase9b_store_full_width(dev, h, single_in, g_host):
    """Phase 6's graph through a graph store at full width: build_store from
    phase 6's host edges into a temporary directory (removed at the end),
    open_store with CRC verification, prepare with ell_pad_rows=65536 and a
    warm solve bit-identical to phase 6's; a store-backed server over the
    first SERVED queries of phase 7's stream, one apply_deltas of 100
    records (60 adds, 20 deletes, 20 reweights), the next SERVED queries,
    each distinct post-bump answer equal to a cold single solve of the
    mutated store; an IncrementalSession (K = 8192) through three such epochs, the
    last bit-identical to a cold frontier solve; Borůvka beside Prim on
    phase 6's pair table.  Returns the record and the kernels' launches."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core import steiner as smod
    from repro_torch.delta import IncrementalSession
    from repro_torch.graphstore import ArraySource, build_store, open_store
    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.serve import ServeConfig, SteinerServer
    from repro_torch.serve.plan import plan_query
    from repro_torch.solver import SolverConfig, SteinerSolver

    seeds, ref = single_in
    src, dst, w, n = g_host
    S = len(seeds)
    rec, launches = {}, {}
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    obs.enable()  # the phase's spans: where the epoch path's time goes
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as tmp:
        path = Path(tmp) / "rmat23.gstore"
        (_, ingest), rec["build_store_s"] = timed(
            build_store, ArraySource(src, dst, w, n, chunk_edges=1 << 22), path)
        rec["store_bytes"] = sum(f.stat().st_size for f in path.iterdir())
        rec["ingest_edges_per_s"] = ingest.edges_per_sec
        store, rec["open_verify_s"] = timed(open_store, path)
        rec["store_m"] = store.m
        log(f"phase 9b: build_store {rec['build_store_s']:.3f} s ({ingest.edges_in} input "
            f"edges, {ingest.edges_per_sec:.0f} edges/s, peak chunk "
            f"{ingest.peak_chunk_bytes} B), {rec['store_bytes']} bytes on disk; open_store "
            f"with CRC verification {rec['open_verify_s']:.3f} s; m={store.m} directed edges "
            f"(phase 6's COO: {h.graph.num_edges}, padded to a multiple of 8)")

        cfg = h.config.replace(ell_pad_rows=65536)
        hs, rec["prepare_s"] = timed(lambda: SteinerSolver(cfg, device=dev).prepare(store))
        R0, R = h.artifact("ell").nbr.shape[0], hs.artifact("ell").nbr.shape[0]
        kmod.minplus_call.launches = 0
        cold, rec["cold_solve_s"] = timed(hs.solve, seeds)
        warm, rec["warm_solve_s"] = timed(hs.solve, seeds)
        launches["minplus_call (pallas from a store)"] = kmod.minplus_call.launches
        same_fixpoint(warm.raw, ref.raw, "the store's warm solve vs phase 6's")
        t, t6 = warm.telemetry, ref.telemetry
        counters = (t.iterations, t.relaxations, t.messages)
        if counters != (t6.iterations, t6.relaxations, t6.messages):
            raise AssertionError(f"the store's counters {counters} differ from phase 6's")
        if kmod.minplus_call.launches != 2 * t.iterations:
            raise AssertionError(f"{kmod.minplus_call.launches} launches for 2 x {t.iterations}")
        rec.update(ell_rows=R, spare_rows=R - R0, iterations=t.iterations,
                   relaxations=t.relaxations, messages=t.messages)
        log(f"phase 9b: prepare from the store {rec['prepare_s']:.3f} s, ELL ({R}, "
            f"{hs.artifact('ell').nbr.shape[1]}): {R - R0} spare rows; cold "
            f"{rec['cold_solve_s']:.3f} s, warm {rec['warm_solve_s']:.3f} s; phase 6's state, "
            f"MST and tree bit for bit; counters {counters} = phase 6's (the same real edges: "
            f"phase 6's padding edges are +inf and count in no counter)")
        del hs, cold, warm

        buckets = (8, 16, 32)
        rng = np.random.default_rng(0)  # phase 7's pool and stream
        pool = build_query_pool(n, rng, 40, buckets)
        queries = [pool[i] for i in zipf_stream(rng, 40, 200, 1.1)]
        srv, rec["server_boot_s"] = timed(lambda: SteinerServer(
            graph_path=str(path), config=ServeConfig(mode="pallas", buckets=buckets, max_batch=8),
            device=dev))
        batches, warm_s = [], []
        recording_solve(srv, batches)
        warm_resolve = srv._warm_resolve

        def timed_warm(plan):  # each warm re-solve's seconds
            out, secs = timed(warm_resolve, plan)
            if out is not None:
                warm_s.append(secs)
            return out

        srv._warm_resolve = timed_warm
        kmod.minplus_call.lane_launches = 0
        # the first 50 queries of the stream, then the next 50 (cut from 100
        # and 100 to keep the phase near 180 s; PERF.md §4)
        _, rec["served_before_s"] = serve_stream(srv, queries[:SERVED], 8)
        recs = delta_records(np.random.default_rng(100), n, src, dst, 60, 20, 20)
        report, rec["apply_deltas_s"] = timed(srv.apply_deltas, recs)
        after, rec["served_after_s"] = serve_stream(srv, queries[SERVED:2 * SERVED], 8)
        lane = kmod.minplus_call.lane_launches
        if lane != sum(r for _, _, r in batches):
            raise AssertionError(f"store server: {lane} lane launches for the batches' rounds")
        launches["minplus_call (lanes, store-backed server)"] = lane
        st = srv.stats()
        rec["server"] = dict(report={k: v for k, v in report.items() if k != "refreshed"},
                             refreshed=list(report["refreshed"]), batches=len(batches),
                             rounds=sum(r for _, _, r in batches), lane_launches=lane,
                             **{k: st[k] for k in ("cache_hits", "cache_invalidations",
                                                   "cache_revalidations", "warm_resolves",
                                                   "retained_states", "epoch")})
        log(f"phase 9b: store-backed server: boot {rec['server_boot_s']:.3f} s; first {SERVED} "
            f"queries {rec['served_before_s']:.3f} s; apply_deltas of {len(recs)} records "
            f"(append + refresh + revalidation) {rec['apply_deltas_s']:.3f} s: epoch "
            f"{report['epoch']}, invalidated {report['invalidated']}, revalidated "
            f"{report['revalidated']}, refreshed {report['refreshed']}; next {SERVED} queries "
            f"{rec['served_after_s']:.3f} s, {st['warm_resolves']} warm re-solves; "
            f"{len(batches)} batches, {lane} lane launches = their rounds")
        cold_h, rec["cold_prepare_s"] = timed(lambda: SteinerSolver(
            SolverConfig(backend="single", mode="pallas"), device=dev).prepare(
            srv._handle.artifact("store")))
        distinct, cold_s = {}, []
        for r in after:
            distinct.setdefault(r.key, r)
        for key, r in distinct.items():
            c, secs = timed(cold_h.solve, plan_query(key, buckets).padded)
            cold_s.append(secs)
            if (c.total_distance, c.num_edges) != (r.total_distance, r.num_edges):
                raise AssertionError(f"post-bump answer for {key[:4]}...: served "
                                     f"{r.total_distance}/{r.num_edges}, cold "
                                     f"{c.total_distance}/{c.num_edges}")
        rec["server"].update(checked_keys=len(distinct), warm_resolve_s=warm_s,
                             cold_single_s=cold_s)
        log(f"phase 9b: {len(distinct)} distinct post-bump answers = cold single solves of "
            f"the mutated store (prepare {rec['cold_prepare_s']:.3f} s); a warm re-solve "
            f"(mode dense) {min(warm_s, default=0):.3f}-{max(warm_s, default=0):.3f} s, "
            f"median {float(np.median(warm_s)) if warm_s else 0:.3f} s; a cold single pallas "
            f"solve {min(cold_s):.3f}-{max(cold_s):.3f} s, median {float(np.median(cold_s)):.3f} s")
        store = srv._handle.artifact("store")
        del srv, cold_h

        sess, rec["session_cold_s"] = timed(lambda: IncrementalSession(
            store, seeds, ell_pad_rows=65536, frontier_size=8192, device=dev))
        log(f"phase 9b: IncrementalSession (K = 8192, ell_pad_rows=65536) cold construction "
            f"{rec['session_cold_s']:.3f} s: {sess.last.iterations} rounds, "
            f"{sess.patcher.free_rows} free rows")
        rec["epochs"] = []
        for e in range(3):
            recs = delta_records(np.random.default_rng(200 + e), n, src, dst, 60, 20, 20)
            res, secs = timed(sess.apply_deltas, recs)
            row = dict(seconds=secs, free_rows=sess.patcher.free_rows, **dataclasses.asdict(res))
            rec["epochs"].append(row)
            log(f"phase 9b: epoch {res.epoch}: {secs:.3f} s; changed {res.changed_vertices}, "
                f"affected cells {res.affected_cells}, reset {res.vertices_reset}, cells "
                f"recomputed {res.cells_recomputed} ({res.member_vertices} members), rounds "
                f"{res.iterations}, free rows {sess.patcher.free_rows}; D={res.total_distance}")
        fcfg = SolverConfig(backend="single", mode="frontier", frontier_size=8192)
        cold, rec["frontier_cold_s"] = timed(
            lambda: SteinerSolver(fcfg, device=dev).prepare(store).solve(seeds))
        for f in ("dist", "lab", "pred"):
            _bitwise(getattr(sess.state, f), getattr(cold.raw.state, f), f"last epoch {f}")
        if not (np.array_equal(sess.parent, cold.raw.parent.cpu().numpy())
                and (sess.total_distance, sess.num_edges) == (cold.total_distance,
                                                               cold.num_edges)):
            raise AssertionError("the last epoch differs from a cold frontier solve")
        log(f"phase 9b: the last epoch = a cold mode=\"frontier\" solve of the mutated store "
            f"(state, parent, D={cold.total_distance}, {cold.num_edges} edges; prepare + cold "
            f"solve {rec['frontier_cold_s']:.3f} s, {cold.telemetry.iterations} rounds)")
        del sess, cold
        rec["compact"], launches["minplus_call (pallas, compacted and overlay stores)"] = (
            compact_full_width(dev, store, path, seeds, 65536))

    # Borůvka beside Prim on phase 6's pair table
    dmat = ref.raw.dmat
    parents, times = {}, {}
    for algo in ("prim", "boruvka", "prim", "boruvka"):
        parents[algo], t_s = timed(smod.mst_parent, dmat, S, algo)
        times.setdefault(algo, []).append(t_s)
    W = dmat.view(S, S).cpu().numpy()
    W = np.minimum(W, W.T)
    np.fill_diagonal(W, np.inf)
    weights = {a: mst_weight(W, p.cpu().numpy()) for a, p in parents.items()}
    if weights["prim"] != weights["boruvka"]:
        raise AssertionError(f"MST weights differ: {weights}")
    if not torch.equal(parents["prim"], ref.raw.parent):
        raise AssertionError("Prim's parent differs from phase 6's")
    rec["mst"] = dict(prim_s=times["prim"], boruvka_s=times["boruvka"], weight=weights["prim"],
                      same_tree=bool(torch.equal(parents["prim"], parents["boruvka"])))
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["spans"] = span_sums(obs.tracer())
    obs.reset()
    log("phase 9b: spans by name (seconds, count): " + json.dumps(
        {k: [round(v[0], 6), v[1]] for k, v in rec["spans"].items()}))
    log(f"phase 9b: MST of phase 6's pair table (S={S}): Prim {times['prim']} s, Borůvka "
        f"{times['boruvka']} s, equal weight {weights['prim']}, same tree "
        f"{rec['mst']['same_tree']}; peak {rec['peak_mem_gb']:.1f} GB; phase "
        f"{rec['phase_s']:.1f} s")
    return rec, launches


def phase7_serving(dev, h):
    """The perf_serve stream through SteinerServer on phase 6's graph.

    Returns the record, the lane launches of the stream, and a batch of
    eight distinct pool keys with its resident solve (the lane kernels'
    comparison and timing inputs; phase 8 solves it blocked)."""
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
    kmod.pack_records.launches = 0
    results, stream_s = serve_stream(server, queries, flush_every)
    lane_launches = kmod.minplus_call.lane_launches
    single_launches = kmod.minplus_call.launches - lane_launches
    rounds = sum(b["rounds"] for b in batches)
    if lane_launches != rounds or single_launches or kmod.pack_records.launches != rounds:
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
    log(f"phase 7: in-loop device ms a launch {json.dumps(prof['minplus_ms_per_launch'])} "
        f"over {json.dumps(prof['minplus_launches'])} launches")
    return rec, lane_launches, (distinct, out8, server._handle.config)


# Phase 10's configurations: the repo's paper presets
# (src/repro/configs/steiner.py) cut from a (16, 16) mesh to one rank
MESH_PRESET = dict(backend="mesh1d", mode="bucket", mst_algo="prim", max_iters=10_000,
                   mesh_shape=(1, 1), fuse_gather=True)
MESH_RUNS = (
    ("lvj_1k", {}),
    ("dense", dict(mode="dense")),
    ("mesh_frontier", dict(mode="frontier", ell_width=32, frontier_size=8192)),
    ("clw_10k knobs", dict(pair_chunks=8, lab_i16=True)),
    ("boruvka", dict(mst_algo="boruvka")),
    ("per-rank telemetry", dict(telemetry_rounds=64, telemetry_per_rank=True)),
    ("mesh2d", dict(backend="mesh2d")),
)
MESH_FIELDS = ("dist", "lab", "pred", "marked", "path_edge", "bridge_u", "bridge_v",
               "bridge_w", "bridge_valid", "total_distance", "num_edges", "iterations",
               "relaxations", "messages", "history", "per_rank")
# BENCH_steiner.json's mesh rows at scale 10: (total, rounds, relaxations,
# messages); the frontier row runs at frontier_size=256
MESH_SCALE10 = {"bucket": (547.0, 17, 2550, 257061), "frontier": (547.0, 10, 2248, 31047)}


def mesh_config(name, **kw):
    from repro_torch.solver import SolverConfig

    return SolverConfig(**{**MESH_PRESET, **dict(MESH_RUNS)[name], **kw})


def same_mesh(a, b, what, fields=MESH_FIELDS):
    """Two DistSteinerResults equal bit for bit in ``fields``."""
    import numpy as np

    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None) or (x is not None and not (
                np.asarray(x).dtype == np.asarray(y).dtype
                and np.array_equal(np.asarray(x), np.asarray(y)))):
            raise AssertionError(f"{what}: {f} differs")


def same_as_single(res, single, what):
    """A mesh result against a single solve's SteinerResult: the state and
    tree bit for bit, the total within f32 summation tolerance."""
    import math

    import numpy as np

    st, tree = single.state, single.tree
    pairs = {"dist": st.dist, "lab": st.lab, "pred": st.pred, "marked": tree.in_tree_vertex,
             "path_edge": tree.path_edge, "bridge_u": tree.bridge_u, "bridge_v": tree.bridge_v,
             "bridge_w": tree.bridge_w, "bridge_valid": tree.bridge_valid}
    for f, t in pairs.items():
        want = t.cpu().numpy()
        got = getattr(res, f)
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"{what}: {f} differs from the single solve's")
    if res.num_edges != int(tree.num_edges):
        raise AssertionError(f"{what}: {res.num_edges} edges, the single solve {tree.num_edges}")
    if not math.isclose(res.total_distance, float(tree.total_distance), rel_tol=1e-6,
                        abs_tol=1e-4):
        raise AssertionError(f"{what}: total {res.total_distance} vs {float(tree.total_distance)}")


def phase10_mesh(dev, h, single_in, in_shard_dir=None):
    """The paper's distributed engine on one NCCL rank: every MESH_RUNS
    config at full width on phase 6's graph and seeds (a cold and a warm
    solve, each state and tree = phase 6's single solve; Borůvka's = the
    single Borůvka tree of phase 6's state), a profiler pass over the bucket
    solve with the NCCL share of device time; the scale-10 fixed answers;
    scale 16 card against CPU in every config and from a store with all
    three shard flavours; then ``in_shard_dir(directory)`` (phase 10b's CLI
    runs) before the shard directory goes.  Launches no kernel.  Returns the
    record."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.core import steiner as smod
    from repro_torch.core.graph import from_edges
    from repro_torch.core.mesh import backend_name
    from repro_torch.data.graphs import rmat_edges, select_seeds
    from repro_torch.graphstore import (ArraySource, build_store, open_store,
                                        partition_ell_store, partition_store,
                                        partition_store_2d)
    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.obs import flight
    from repro_torch.solver import SolverConfig, SteinerSolver

    seeds, ref = single_in
    S = len(seeds)
    rec = {"runs": {}}
    t_phase = time.perf_counter()
    launches0 = (kmod.minplus_call.launches, kmod.minplus_blocked_call.launches)
    torch.cuda.reset_peak_memory_stats()
    boruvka_ref = smod.finish_pipeline(h.graph, ref.raw.state, ref.raw.stats, S, "boruvka")
    bucket_handle = None
    for name, _ in MESH_RUNS:
        cfg = mesh_config(name)
        hm, prep_s = timed(lambda: SteinerSolver(cfg, device=dev).prepare(h.graph))
        cold, cold_s = timed(hm.solve, seeds)
        warm, warm_s = timed(hm.solve, seeds)
        same_mesh(warm.raw, cold.raw, f"{name}: warm vs cold")
        same_as_single(cold.raw, boruvka_ref if cfg.mst_algo == "boruvka" else ref.raw,
                       f"{name} at full width")
        t = cold.telemetry
        if cfg.telemetry_per_rank:
            flight.check_consistency(t.per_rank, t.per_round, label=name)
            report = flight.analyze(t.per_rank, label=name)
            if report.n_ranks != 1 or report.rounds != t.per_round.shape[0]:
                raise AssertionError(f"{name}: flight report {report.n_ranks} ranks, "
                                     f"{report.rounds} rounds")
        run = dict(prepare_s=prep_s, cold_s=cold_s, warm_s=warm_s, rounds=t.iterations,
                   relaxations=t.relaxations, messages=t.messages,
                   total_distance=cold.total_distance, num_edges=cold.num_edges,
                   shard_rows=int(hm.artifact("edges")[0].shape[0]))
        rec["runs"][name] = run
        log(f"phase 10: {name} ({cfg.backend} {cfg.mode}, mesh {cfg.mesh_shape}) at full "
            f"width: prepare {prep_s:.3f} s (shard of {run['shard_rows']} rows), cold "
            f"{cold_s:.3f} s, warm {warm_s:.3f} s; rounds {t.iterations}, relaxations "
            f"{t.relaxations}, messages {t.messages}; D={cold.total_distance} edges="
            f"{cold.num_edges}: state and tree = phase 6's single solve"
            + (" (Borůvka's tree of phase 6's state)" if cfg.mst_algo == "boruvka" else ""))
        if name == "lvj_1k":
            bucket_handle = hm
        del hm, cold, warm
    rec["nccl"] = backend_name(dev)
    if rec["nccl"] != "nccl" or backend_name("cpu") != "gloo":
        raise AssertionError(f"collectives of CUDA tensors go through {rec['nccl']}")
    prof = device_profile(lambda: bucket_handle.solve(seeds), rec["runs"]["lvj_1k"]["warm_s"])
    rec["profile"] = {k: prof[k] for k in ("device_ms", "nccl_ms", "busy_share",
                                           "top_device_ms")}
    rec["nccl_share"] = prof["nccl_ms"] / max(prof["device_ms"], 1e-9)
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase 10: collectives of CUDA tensors through {rec['nccl']} (one rank, mesh "
        f"(1, 1)); lvj_1k warm solve: device busy {prof['busy_share']:.3f}, NCCL "
        f"{prof['nccl_ms']:.3f} of {prof['device_ms']:.3f} device ms (share "
        f"{rec['nccl_share']:.4f}); top device time (ms): {json.dumps(prof['top_device_ms'])}; "
        f"peak {rec['peak_mem_gb']:.1f} GB")
    del bucket_handle

    # the scale-10 fixed answers
    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    sd10 = select_seeds(n, src, dst, 16, strategy="uniform", seed=1000)
    g10 = from_edges(src, dst, w, n, pad_to=8, device=dev)
    for mode, want in MESH_SCALE10.items():
        cfg = SolverConfig(backend="mesh1d", mode=mode, mesh_shape=(1, 1), frontier_size=256)
        out = SteinerSolver(cfg, device=dev).prepare(g10).solve(sd10)
        t = out.telemetry
        got = (out.total_distance, t.iterations, t.relaxations, t.messages)
        log(f"phase 10: scale 10 mesh {mode} -> {got}")
        if got != want:
            raise AssertionError(f"scale-10 mesh {mode}: {got} != {want}")

    # scale 16, card against CPU (gloo), every config, then from a store
    src, dst, w, n = rmat_edges(16, 8, max_weight=100, seed=0)
    sd16 = select_seeds(n, src, dst, 64, strategy="uniform", seed=1000)
    graphs = {str(d): from_edges(src, dst, w, n, pad_to=8, device=d) for d in (dev, "cpu")}
    card = {}
    for name, _ in MESH_RUNS:
        cfg = mesh_config(name)
        res, secs = {}, {}
        for d in (dev, "cpu"):
            out, secs[str(d)] = timed(
                lambda: SteinerSolver(cfg, device=d).prepare(graphs[str(d)]).solve(sd16))
            res[str(d)] = out.raw
        same_mesh(res[str(dev)], res["cpu"], f"scale 16 {name}: card vs CPU")
        card[name] = res[str(dev)]
        log(f"phase 10: scale 16 {name}: card = CPU bit for bit (rounds "
            f"{res[str(dev)].iterations}); card {secs[str(dev)]:.3f} s, cpu {secs['cpu']:.3f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shards_") as tmp:
        path, _ = build_store(ArraySource(src, dst, w, n), Path(tmp) / "rmat16.gstore")
        partition_store(open_store(path, verify=False), n_replica=1, n_blocks=1)
        partition_ell_store(open_store(path, verify=False), k=32)
        flavours = (("lvj_1k", "1d edge shards"), ("mesh_frontier", "1d ELL shards"),
                    ("mesh2d", "2d shards"))
        for name, flavour in flavours:
            if name == "mesh2d":
                partition_store_2d(open_store(path, verify=False), R=1, C=1)
            res = {}
            for d in (dev, "cpu"):
                hs = SteinerSolver(mesh_config(name), device=d).prepare(open_store(path))
                if hs.artifact("from_shards") is not True:
                    raise AssertionError(f"scale 16 {name}: the store's {flavour} were not "
                                         f"loaded")
                res[str(d)] = hs.solve(sd16).raw
            same_mesh(res[str(dev)], res["cpu"], f"scale 16 {name} from {flavour}: card vs CPU")
            # the in-memory graph's +inf padding edges give vertex 0 other ELL
            # rows, so the frontier's order (not its fixpoint) may differ
            same_mesh(res["cpu"], card[name], f"scale 16 {name} from {flavour} vs in memory",
                      fields=MESH_FIELDS[:11])
            log(f"phase 10: scale 16 {name} from the store's {flavour} (loaded per shard): "
                f"card = CPU bit for bit, state and tree = the in-memory solve's (rounds "
                f"{res['cpu'].iterations} against {card[name].iterations})")
        if in_shard_dir is not None:
            t0 = time.perf_counter()
            rec["in_shard_dir"] = in_shard_dir(Path(tmp))
            rec["in_shard_dir_s"] = time.perf_counter() - t0
    if (kmod.minplus_call.launches, kmod.minplus_blocked_call.launches) != launches0:
        raise AssertionError("the mesh path launched a min-plus kernel")
    dist.destroy_process_group()  # the world of one the backend made
    rec["phase_s"] = time.perf_counter() - t_phase - rec.get("in_shard_dir_s", 0.0)
    log(f"phase 10: {rec['phase_s']:.1f} s; no kernel launched (the mesh path runs the plain "
        f"ops)")
    return rec


def cli_scale16(workdir):
    """The two CLIs as processes at scale 16 in ``workdir``: build with
    --trace and --metrics, partition into 4 blocks, append records local to
    block 0, compact (fewer shard files rewritten than there are), verify,
    and ``python -m repro_torch.obs validate`` of the build's trace.  Every
    one must exit 0.  Returns the record."""
    import os

    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}
    store, trace, metrics = "cli16.gstore", "cli16_trace.json", "cli16_metrics.txt"
    steps = (
        ("repro_torch.graphstore", "--json", "--trace", trace, "--metrics", metrics, "build",
         store, "--source", "rmat", "--scale", "16", "--edge-factor", "8"),
        ("repro_torch.graphstore", "--json", "partition", store, "--blocks", "4"),
        ("repro_torch.graphstore", "--json", "append", store, "--add", "1", "2", "3.5",
         "--add", "100", "4000", "2.0", "--reweight", "1", "2", "4.5", "--delete", "7", "9"),
        ("repro_torch.graphstore", "--json", "compact", store, "--verify"),
        ("repro_torch.graphstore", "--json", "verify", store),
        ("repro_torch.obs", "validate", trace, "--metrics", metrics, "--require-span",
         "ingest:build_store"),
    )
    rec = {}
    for module, *argv in steps:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", module, *argv], cwd=workdir, env=env,
                           capture_output=True, text=True, timeout=300)
        secs = time.perf_counter() - t0
        cmd = f"{module} {argv[argv.index(store) - 1] if store in argv else argv[0]}"
        if p.returncode != 0:
            raise AssertionError(f"python -m {' '.join([module, *argv])} exited "
                                 f"{p.returncode}: {p.stderr[-2000:]}")
        doc = json.loads(p.stdout) if "--json" in argv else p.stdout.strip()
        rec[cmd] = {"s": secs, "out": doc}
        log(f"phase 10b: python -m {' '.join([module, *argv])}: exit 0 in {secs:.2f} s")
    comp = rec["repro_torch.graphstore compact"]["out"]
    if not 0 < comp["shard_files_rewritten"] < comp["shard_files_total"]:
        raise AssertionError(f"the CLI's compact rewrote {comp['shard_files_rewritten']} of "
                             f"{comp['shard_files_total']} shard files")
    log(f"phase 10b: CLI compact: {comp['records_folded']} records folded, "
        f"{comp['shard_files_rewritten']} of {comp['shard_files_total']} shard files "
        f"rewritten; obs validate: {rec['repro_torch.obs validate']['out']!r}")
    return rec


def phase10b_obs(dev, h, single_in, lanes_in, mesh_rec):
    """Observability on the card, with obs on (reset and off at the end): a
    traced prepare and warm solve on phase 6's graph (mode "pallas",
    resident) bit-identical to phase 6's with as many launches, its trace
    validated and holding the prepare, solve, 20 synthetic round spans and
    convergence samples, the messages counter = telemetry.messages, the
    solve span beside the host clock of the same solve, and warm solves
    with obs off and on in turns; phase 7's eight distinct keys through a
    traced server (the serve spans; the answers = phase 7's); the lvj_1k
    mesh preset with per-rank telemetry (its rank track; state and tree =
    phase 6's single solve, counters = phase 10's).  Returns the record and
    the min-plus launches (single, lanes)."""
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.serve import ServeConfig, SteinerServer
    from repro_torch.solver import SteinerSolver

    seeds, ref = single_in
    distinct, out8, bcfg = lanes_in
    rec = {}
    t_phase = time.perf_counter()
    launches = {"single": 0, "lanes": 0}
    obs.reset()
    obs.enable()
    # the traced prepare (phase 6's graph and ELL view, memoized) and solve
    ht = SteinerSolver(h.config, device=dev).prepare(h.graph)
    n0 = kmod.minplus_call.launches
    traced, rec["traced_solve_s"] = timed(ht.solve, seeds)
    grew = kmod.minplus_call.launches - n0
    launches["single"] += grew
    same_raw(traced.raw, ref.raw, "the traced solve vs phase 6's")
    t, t6 = traced.telemetry, ref.telemetry
    if grew != t.iterations or not np.array_equal(t.per_round, t6.per_round):
        raise AssertionError(f"traced solve: {grew} launches for {t.iterations} rounds; "
                             f"rows equal {np.array_equal(t.per_round, t6.per_round)}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        if not obs.export_chrome_trace(str(Path(tmp) / "trace.json")):
            raise AssertionError("no trace was recorded")
        doc = json.loads((Path(tmp) / "trace.json").read_text())
    n_events = obs.validate_chrome_trace(doc)
    names = [e["name"] for e in doc["traceEvents"]]
    rounds = [e for e in doc["traceEvents"] if e["name"] == "round[single/pallas]"]
    if not ({"prepare", "prepare:ell_build", "solve"} <= set(names)
            and len(rounds) == t.iterations == 20
            and all(e["args"]["synthetic_timing"] for e in rounds)
            and names.count("convergence[single/pallas]") == t.iterations):
        raise AssertionError(f"the traced solve's trace: {sorted(set(names))}, "
                             f"{len(rounds)} round spans")
    samples = obs.parse_prometheus(obs.prometheus_text())
    msgs = samples['solver_messages_total{backend="single",mode="pallas"}']
    if msgs != t.messages:
        raise AssertionError(f"solver_messages_total {msgs} != telemetry {t.messages}")
    span = [e for e in doc["traceEvents"] if e["name"] == "solve"][-1]
    rec.update(trace_events=n_events, solve_span_s=span["dur"] / 1e6, messages=msgs)
    log(f"phase 10b: traced pallas solve = phase 6's bit for bit (state, MST, tree, counters, "
        f"{t.iterations} rows), {grew} launches = its rounds; trace valid ({n_events} events: "
        f"prepare, prepare:ell_build, solve, {len(rounds)} synthetic round spans, "
        f"{names.count('convergence[single/pallas]')} convergence samples); "
        f"solver_messages_total {msgs:.0f} = telemetry; solve span {rec['solve_span_s']:.6f} s "
        f"beside host clock + sync {rec['traced_solve_s']:.6f} s")
    # warm solves with obs off and on, in turns
    turns = []
    for on in (False, True, True, False):
        (obs.enable if on else obs.disable)()
        n0 = kmod.minplus_call.launches
        out, secs = timed(ht.solve, seeds)
        grew = kmod.minplus_call.launches - n0
        launches["single"] += grew
        if grew != t.iterations or out.total_distance != traced.total_distance:
            raise AssertionError(f"obs {'on' if on else 'off'}: {grew} launches")
        turns.append((on, secs))
    off = [s for on, s in turns if not on]
    on_ = [s for on, s in turns if on]
    rec.update(turns=turns, overhead=sum(on_) / sum(off) - 1.0)
    log(f"phase 10b: warm solves in turns (obs, s): " + ", ".join(
        f"({'on' if on else 'off'}, {s:.6f})" for on, s in turns)
        + f"; overhead {100 * rec['overhead']:+.3f} %")
    obs.enable()
    del ht, traced

    # phase 7's eight distinct keys through a traced server
    keys = [sorted(set(int(x) for x in row)) for row in distinct]
    srv = SteinerServer(h.graph, ServeConfig(mode="pallas", buckets=(8, 16, 32),
                                             max_batch=bcfg.batch_size), device=dev)
    batches = []
    recording_solve(srv, batches)
    n0 = kmod.minplus_call.lane_launches
    res, rec["served_s"] = timed(srv.query_many, keys)
    launches["lanes"] += kmod.minplus_call.lane_launches - n0
    want = [(float(out8.total_distance[i]), int(out8.num_edges[i])) for i in range(len(keys))]
    got = [(r.total_distance, r.num_edges) for r in res]
    if got != want or launches["lanes"] != sum(r for _, _, r in batches):
        raise AssertionError(f"traced server: {got} vs phase 7's {want}; "
                             f"{launches['lanes']} lane launches")
    names = {e["name"] for e in obs.tracer().events()}
    serve = ("serve:assemble", "serve:queue_wait", "serve:solve", "serve:stash")
    if not set(serve) <= names:
        raise AssertionError(f"traced server: spans {sorted(names)}")
    log(f"phase 10b: phase 7's {len(keys)} distinct keys through a traced server in "
        f"{rec['served_s']:.3f} s ({len(batches)} batches, {launches['lanes']} lane launches = "
        f"their rounds): answers = phase 7's; spans {', '.join(serve)} recorded")
    del srv

    # the lvj_1k mesh preset with per-rank telemetry on the one NCCL rank
    cfg = mesh_config("lvj_1k", telemetry_per_rank=True)
    hm = SteinerSolver(cfg, device=dev).prepare(h.graph)
    out, rec["mesh_solve_s"] = timed(hm.solve, seeds)
    same_as_single(out.raw, ref.raw, "the traced lvj_1k mesh solve")
    m10 = mesh_rec["runs"]["lvj_1k"]
    t = out.telemetry
    if (t.iterations, t.relaxations, t.messages) != (m10["rounds"], m10["relaxations"],
                                                     m10["messages"]):
        raise AssertionError("the traced mesh solve's counters differ from phase 10's")
    names = {e["name"] for e in obs.tracer().events()}
    track = [e for e in obs.tracer().events() if e["name"] == "rank[mesh1d/bucket/0]"]
    if len(track) != t.per_rank.shape[0] or not {"prepare:partition", "prepare:place"} <= names:
        raise AssertionError(f"the traced mesh solve: {len(track)} rank samples for "
                             f"{t.per_rank.shape[0]} rows; spans {sorted(names)}")
    log(f"phase 10b: lvj_1k mesh1d with per-rank telemetry, traced: {rec['mesh_solve_s']:.3f} "
        f"s, state and tree = phase 6's single solve, counters = phase 10's; "
        f"rank[mesh1d/bucket/0] track of {len(track)} samples")
    del hm, out
    dist.destroy_process_group()
    rec["spans"] = span_sums(obs.tracer())
    obs.reset()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 10b: {rec['phase_s']:.1f} s; spans by name (seconds, count): " + json.dumps(
        {k: [round(v[0], 6), v[1]] for k, v in rec["spans"].items()}))
    return rec, launches


def kernel_times(dev, ell, st, blocked_in, lanes_in, seg_in, tally):
    """ms of each kernel and of the plain version at its path's shape (the
    blocked and the lane kernels are also held against the plain version
    here)."""
    import torch

    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.kernels.minplus.ref import minplus_blocked_torch, minplus_torch
    from repro_torch.kernels.segmin.ref import segmin_bucketed_torch
    from repro_torch.kernels.segmin.segmin import segmin_bucketed_call

    R, K = ell.nbr.shape
    N = st.dist.shape[0]
    args = (ell.nbr, ell.wgt, st.dist, st.lab)
    # the lane entry at B = 1 on the same state (it launches the single
    # kernel's body): equal to the single kernel, and as fast
    args1 = (ell.nbr, ell.wgt, st.dist[None], st.lab[None])
    tally["minplus_call (lanes)"].compare(
        kmod.minplus_call(*args1), tuple(x[None] for x in kmod.minplus_call(*args)),
        "lanes at B=1 vs the single kernel, full width")
    res = {"minplus_call": dict(
        shape=[R, K, N], ms=event_ms(lambda: kmod.minplus_call(*args), 20),
        plain_ms=event_ms(lambda: minplus_torch(*args), 3), bound_ms=bound_ms(R, K, N),
        lanes_b1_ms=event_ms(lambda: kmod.minplus_call(*args1), 20),
        pack_ms=event_ms(lambda: kmod.pack_records(st.dist, st.lab), 20))}

    # the lane kernel at its serving shape: one served batch's (B, N) state;
    # its plain version runs lane by lane (the (B, R, K) temporaries of one
    # vectorised call would not fit beside the graph)
    _, out8, _ = lanes_in
    lanes_st = out8.raw.state
    B = lanes_st.dist.shape[0]
    largs = (ell.nbr, ell.wgt, lanes_st.dist, lanes_st.lab)

    def plain_lanes():
        outs = [minplus_torch(ell.nbr, ell.wgt, lanes_st.dist[b], lanes_st.lab[b])
                for b in range(B)]
        return tuple(torch.stack(x) for x in zip(*outs))

    want8 = plain_lanes()
    tally["minplus_call (lanes)"].compare(kmod.minplus_call(*largs), want8,
                                          "lanes at the serving shape")
    lanes_bound = (R * K * 8 + B * (N * 8 + R * 12)) / HBM_BYTES_PER_S * 1e3
    res["minplus_call (lanes)"] = dict(
        shape=[R, K, N, B], ms=event_ms(lambda: kmod.minplus_call(*largs), 20),
        plain_ms=event_ms(plain_lanes, 2),
        single_lane_launches_ms=event_ms(lambda: [
            kmod.minplus_call(ell.nbr, ell.wgt, lanes_st.dist[b], lanes_st.lab[b])
            for b in range(B)], 5),
        bound_ms=lanes_bound,
        pack_ms=event_ms(lambda: kmod.pack_records(lanes_st.dist, lanes_st.lab), 20))
    # the lane kernel on the first b lanes of the same state, b = 1, 2, 4, 8
    res["minplus_call (lanes)"]["b_sweep"] = {
        b: dict(ms=event_ms(lambda: kmod.minplus_call(
            ell.nbr, ell.wgt, lanes_st.dist[:b], lanes_st.lab[:b]), 10),
            bound_ms=(R * K * 8 + b * (N * 8 + R * 12)) / HBM_BYTES_PER_S * 1e3)
        for b in (1, 2, 4, 8) if b <= B}

    # the blocked kernel at full width on the same inputs as the resident
    # ones: its layout's build, its plain fold, and a few slice budgets
    # (single) and lane groups (B lanes) beside the constants in use
    SB = 4096
    hb = blocked_in["full"]
    layout = hb.artifact("blocked_layout")
    want = minplus_torch(*args)

    def blocked(a, lay):
        return lambda: kmod.minplus_blocked_call(*a, src_block=SB, layout=lay)

    tally["minplus_blocked_call"].compare(blocked(args, layout)(), want, "blocked, full width")
    plain_fold, fold_s = timed(minplus_blocked_torch, layout, st.dist, st.lab)
    if not all(torch_equal(a, b) for a, b in zip(plain_fold, want)):
        raise AssertionError("the plain fold over the full-width layout differs")
    del plain_fold
    budgets = {}
    for mb in (16, 24, 32, 48, 1024):  # 1024 MB: one slice
        lay = kmod.blocked_layout(ell.nbr, ell.wgt, N, SB, budget=mb << 20)
        budgets[mb] = dict(slices=len(lay.slices), runs=lay.num_runs,
                           ms=event_ms(blocked(args, lay), 10))
        del lay
    res["minplus_blocked_call"] = dict(
        shape=[R, K, N, SB], slices=len(layout.slices), runs=layout.num_runs,
        live_slots=int(layout.run_off[layout.num_runs]),
        ms=event_ms(blocked(args, layout), 20),
        resident_ms=event_ms(lambda: kmod.minplus_call(*args), 20),
        plain_ms=res["minplus_call"]["plain_ms"],  # the same function on the same inputs
        plain_fold_ms=fold_s * 1e3,
        layout_build_ms=event_ms(lambda: kmod.blocked_layout(ell.nbr, ell.wgt, N, SB), 2),
        bound_ms=layout_bound_ms(layout, 1), ell_bound_ms=bound_ms(R, K, N),
        budgets_mb=budgets)
    layout8 = kmod.blocked_layout(ell.nbr, ell.wgt, N, SB, True)
    tally["minplus_blocked_call (lanes)"].compare(blocked(largs, layout8)(), want8,
                                                  "blocked lanes at the serving shape")

    def in_groups(g, lay):  # the B lanes in calls of g lanes each
        return lambda: [kmod.minplus_blocked_call(
            ell.nbr, ell.wgt, lanes_st.dist[g0:g0 + g], lanes_st.lab[g0:g0 + g],
            src_block=SB, layout=lay) for g0 in range(0, B, g)]

    groups = {}  # (lanes a group, MB of one lane's records a slice)
    for g, mb in ((1, 24), (2, 12), (2, 24), (4, 24), (8, 3), (8, 24), (8, 1024)):
        lay = kmod.blocked_layout(ell.nbr, ell.wgt, N, SB, budget=mb << 20)
        groups[f"{g}/{mb}"] = dict(slices=len(lay.slices), runs=lay.num_runs,
                                   ms=event_ms(in_groups(g, lay), 5))
        del lay
    res["minplus_blocked_call (lanes)"] = dict(
        shape=[R, K, N, B, SB], slices=len(layout8.slices), lane_group=kmod.blocked_stride(B),
        ms=event_ms(blocked(largs, layout8), 20),
        resident_ms=event_ms(lambda: kmod.minplus_call(*largs), 20),
        plain_ms=res["minplus_call (lanes)"]["plain_ms"],  # the same function and inputs
        layout_build_ms=event_ms(lambda: kmod.blocked_layout(
            ell.nbr, ell.wgt, N, SB, True), 2),
        bound_ms=layout_bound_ms(layout8, B), ell_bound_ms=lanes_bound,
        lane_groups_mb=groups)
    del layout8, want, want8

    # the blocked kernel at its scale-16 shape (phase 4's converged state)
    h16, st16 = blocked_in["scale16"]
    e16 = h16.artifact("ell")
    R, K = e16.nbr.shape
    bargs = (e16.nbr, e16.wgt, st16.dist, st16.lab)
    N = st16.dist.shape[0]
    lay16 = h16.artifact("blocked_layout")
    tally["minplus_blocked_call"].compare(blocked(bargs, lay16)(), minplus_torch(*bargs),
                                          "blocked at the scale-16 shape")
    res["minplus_blocked_call"]["scale16"] = dict(
        shape=[R, K, N, SB], slices=len(lay16.slices),
        ms=event_ms(blocked(bargs, lay16), 20),
        plain_ms=event_ms(lambda: minplus_torch(*bargs), 5),
        resident_ms=event_ms(lambda: kmod.minplus_call(*bargs), 20),
        bound_ms=layout_bound_ms(lay16, 1), ell_bound_ms=bound_ms(R, K, N))

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
    ap.add_argument("--topk-kernel-k", type=int, default=TOPK_KERNEL_K,
                    help="frontier_size of the top-K kernel schedule in phase 9")
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
    ptxas = ptxas_lines(_build.build_log("minplus"))
    for line in ptxas or ["no nvcc log (the library was built before this run)"]:
        log(f"phase 1: ptxas {line}")

    names = ("minplus_call", "minplus_call (lanes)", "minplus_blocked_call",
             "minplus_blocked_call (lanes)", "segmin_bucketed_call")
    tally = {k: Tally() for k in names}
    # ---- phase 2
    t0 = time.perf_counter()
    phase2_kernels(dev, tally)
    phase2_lanes(dev, tally)
    seg_in, seg_launches = phase2_segmin(dev, tally)
    log("phase 2: kernels equal the plain version in "
        + ", ".join(f"{k} {t.cases}" for k, t in tally.items())
        + f" cases ({time.perf_counter() - t0:.1f} s)")
    seconds = {}  # each phase's seconds, for the log

    def done(phase):
        seconds[phase] = round(time.perf_counter() - t_start - sum(seconds.values()), 1)

    done("1-2")
    # ---- phase 3
    phase3_fixed_answers(dev)
    done("3")
    # ---- phase 4 (the blocked kernel's single-query path)
    counters = {}
    blocked16 = phase4_card_vs_cpu(dev, counters)
    if counters["pallas", None][0] == 0 or counters["pallas", None][1] != 0:
        raise AssertionError(f"resident solve launched {counters['pallas', None]}")
    if counters["pallas", 4096][1] == 0 or counters["pallas", 4096][0] != 0:
        raise AssertionError(f"blocked solve launched {counters['pallas', 4096]}")
    done("4")
    # ---- phase 5 (both lane kernels' serving path at scale 16)
    lanes16 = phase5_server_card_vs_cpu(dev)
    if min(lanes16.values()) == 0:
        raise AssertionError(f"scale-16 serving launched {lanes16}")
    done("5")
    # ---- phase 5b (graph stores, deltas and the incremental re-solve at scale 16)
    store16 = phase5b_store_card_vs_cpu(dev)
    done("5b")
    # ---- phase 6 (the resident kernel's main path, full width)
    rec, h, st, single_in, g_host = phase6_full_width(dev, args.scale, args.seeds, tally)
    done("6")
    # ---- phase 7 (the lane kernel's serving path, full width)
    serve_rec, lane_launches, lanes_in = phase7_serving(dev, h)
    if lane_launches == 0:
        raise AssertionError("the served stream launched no lane kernel")
    done("7")
    # ---- phase 8 (the blocked kernels' main path, full width)
    blocked_rec, hb, blocked_launches, blocked_lane_launches = phase8_blocked_full_width(
        dev, h, single_in, lanes_in)
    done("8")
    # ---- phase 9 (the other schedules and the top-K kernel path, full width)
    sched_rec, sched_launches = phase9_schedules_full_width(dev, h, single_in, tally,
                                                            args.topk_kernel_k)
    done("9")
    # ---- phase 9b (the store-backed path at full width)
    store_rec, store_launches = phase9b_store_full_width(dev, h, single_in, g_host)
    del g_host
    done("9b")
    # ---- phase 10 (the mesh backends on one NCCL rank; the CLIs of phase 10b
    # run in its shard directory)
    mesh_rec = phase10_mesh(dev, h, single_in, in_shard_dir=cli_scale16)
    done("10")
    # ---- phase 10b (observability on the card)
    obs_rec, obs_launches = phase10b_obs(dev, h, single_in, lanes_in, mesh_rec)
    obs_rec["cli"] = mesh_rec.pop("in_shard_dir")
    obs_rec["cli_s"] = mesh_rec.pop("in_shard_dir_s")
    del single_in
    done("10b")
    times = kernel_times(dev, h.artifact("ell"), st, {"full": hb, "scale16": blocked16},
                         lanes_in, seg_in, tally)
    done("11")
    log(f"kernel times: {json.dumps(times)}")
    log("tolerance: exact (every output of every kernel equals the plain version's; "
        + ", ".join(f"{k}: {t.cases} cases, {t.mismatches} mismatches"
                    for k, t in tally.items()) + ")")

    # ---- phase 11
    by_path = {"minplus_call (pallas, phase 6)": rec["launches_per_solve"] * 4,
               "minplus_call (lanes, phase 7)": lane_launches,
               "minplus_blocked_call (pallas, phase 8)": blocked_launches,
               "minplus_blocked_call (lanes, phase 8)": blocked_lane_launches,
               "segmin_bucketed_call (phase 2)": seg_launches,
               **{f"{k[:-1]}, phase 9)": v for k, v in sched_launches.items()},
               **{f"{k[:-1]}, phase 9b)": v for k, v in store_launches.items()},
               "minplus_call (traced pallas, phase 10b)": obs_launches["single"],
               "minplus_call (lanes, traced server, phase 10b)": obs_launches["lanes"]}
    log(f"launches by path: {json.dumps(by_path)}")
    launches = {"minplus_call": rec["launches_per_solve"] * 4
                + sched_launches["minplus_call (pallas_frontier)"]
                + store_launches["minplus_call (pallas from a store)"]
                + store_launches["minplus_call (pallas, compacted and overlay stores)"]
                + obs_launches["single"],
                "minplus_call (lanes)": lane_launches
                + store_launches["minplus_call (lanes, store-backed server)"]
                + obs_launches["lanes"],
                "minplus_blocked_call": blocked_launches
                + sched_launches["minplus_blocked_call (pallas_frontier)"],
                "minplus_blocked_call (lanes)": blocked_lane_launches,
                "segmin_bucketed_call": seg_launches}
    minplus_src = "src/repro_torch/kernels/minplus/csrc/minplus.cu"
    sources = {name: minplus_src for name in names}
    sources["segmin_bucketed_call"] = "src/repro_torch/kernels/segmin/csrc/segmin.cu"
    replaces = {"minplus_call": "src/repro/kernels/minplus/minplus.py:77",
                "minplus_call (lanes)": "src/repro/kernels/minplus/minplus.py:77",
                "minplus_blocked_call": "src/repro/kernels/minplus/minplus.py:159",
                "minplus_blocked_call (lanes)": "src/repro/kernels/minplus/minplus.py:159",
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
    log(f"script {total_s:.1f} s after the imports; by phase {json.dumps(seconds)}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"device": smi, "torch": torch.__version__, "build_s": build_s, "ptxas": ptxas,
             "full_width": rec, "serving": serve_rec, "blocked_full_width": blocked_rec,
             "schedules_full_width": sched_rec, "scale16_lane_launches": lanes16,
             "scale16_store_launches": store16, "store_full_width": store_rec,
             "mesh": mesh_rec, "obs": obs_rec, "launches_by_path": by_path,
             "kernel_times": times, "kernels": kernels, "seconds": total_s}, indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    # ---- phase 12
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
