#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # full width: RMAT scale 23, 1024 seeds
    python3 chip_smoke.py --scale 18 # a shorter rehearsal of phases 6 to 9
    python3 chip_smoke.py --scale 18 --only-models  # phases 1, 6 and 12 alone
    python3 chip_smoke.py --scale 18 --only-models --trainer  # and phase 11 with 13
    python3 chip_smoke.py --only-kg      # phases 1, 2, 6 and 10c alone
    python3 chip_smoke.py --only-dryrun  # phase 14 alone
    python3 chip_smoke.py --scale 18 --only-analysis  # phases 1 and 15 alone
    python3 chip_smoke.py --only-gate    # phases 1 and 16 alone
    python3 chip_smoke.py --only-prim    # phases 1, 2's Prim check, Prim's times by cluster size

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
   2048, 256), through its public wrapper; Prim's one-launch kernel
   against its plain loop (core.mst.prim_loop) on the tables of
   tests/_prim_inputs.py at S in PRIM_CHECKED, one block and clusters;
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
   max_batch=8)), 12 queries, and its first 6 through SteinerServer(g,
   ServeConfig()) (mode "bucket") on the card and on the CPU, with identical results and
   non-latency counters; then one (4, 16) seed batch through the batch
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
   warm solve each (the top-K kernel schedule one solve) at phase 6's
   fixpoint bit for bit; rounds, counters,
   seconds and the Voronoi stage; launches = rounds on the top-K kernel
   path (a layout built each round with src_block); one (8192, 32) tile's
   kernel times beside its bound and its layout build; a profiler pass
   over the first rounds of the top-K kernel loop;
9b. the store-backed path at full width on phase 6's graph: build_store
   from phase 6's host edges into a temporary directory (removed at the
   end; ~1.3 GB), open_store with CRC verification, prepare with
   ell_pad_rows=65536 (28,045 spare rows) and a warm solve bit-identical
   to phase 6's; a store-backed server over phase 7's stream, 25 queries,
   one apply_deltas of 100 records (60 adds, 20 deletes, 20 reweights),
   25 more, every distinct post-bump answer equal to a cold single solve
   of the mutated store; an IncrementalSession (K = 8192) through one
   epoch of 100 records, bit-identical to a cold frontier solve; then
   compact of the store (2 segments, 200 records): the compacted CSR
   equal to the effective CSR taken just before, verify_store, and prepare
   of the compacted store (ell_pad_rows=65536) with a warm pallas solve
   bit-identical to the overlay store's; Borůvka beside Prim on phase 6's
   pair table (equal MST weight); peak device memory; obs is on through the
   phase, and its spans are summed by name (the epoch path's breakdown);
10. the paper's distributed engine on one NCCL rank (mesh (1, 1)), its
   configs built from repro_torch.configs.steiner's SOLVER_PRESETS: the
   lvj_1k preset (mesh1d, bucket, max_iters=10_000, fuse_gather), mode
   "dense", the mesh_frontier preset (K = 8192, ell_width=32), clw_10k's
   knobs at S = 1024 (pair_chunks=8, lab_i16), Borůvka, per-rank telemetry
   (64 rounds; its flight report checked) and mesh2d bucket, each prepared
   from phase 6's graph with a cold solve (and lvj_1k a warm one) whose
   state and tree equal phase 6's single solve (Borůvka's: the single
   Borůvka tree of that state); rounds, counters, prepare, cold and warm
   seconds; a profiler pass
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
   its trace validated (prepare, prepare:ell_build, solve, 20 measured
   round spans, convergence samples; solver_messages_total = the
   telemetry's), its span beside the host clock, and warm solves with obs
   off and on in turns (the overhead); phase 7's eight distinct keys
   through a traced server (the serve spans; phase 7's answers); the
   lvj_1k mesh preset with per-rank telemetry (its rank track; phase 6's
   state and tree, phase 10's counters);
10c. the paper's knowledge-graph workflow
   (examples/torch_steiner_knowledge_graph.py: mesh1d, bucket,
   local_steps=2, Prim) at full width on one NCCL rank: prepared on phase
   6's graph (phase 10's partition reused; knobs.build_count says so), the
   example's queries over phase 6's host edges (|S| = 8, 64 and 256,
   drawn uniformly where the example draws 64 and 256 by BFS level, see
   KG_QUERIES; the |S| = 64 repeat with nothing rebuilt), then phase
   6's 1,024 seeds cold and warm and under local_steps=1; each answer's
   state and tree = a single-device pallas solve of its seeds on phase 6's
   handle (resident kernel launches = rounds), no kernel launched by the
   mesh path; rounds, relaxations, messages, seconds and peak GB; then each kernel timed against
   its plain version (the lane kernel at the eight-key batch's state, at
   B = 1 against the single kernel, and at B = 1, 2, 4, 8 on the first
   lanes of that state; the record packing alone; the blocked kernel at
   full width, single and at the eight-key state, beside the resident
   kernel on the same inputs, the layout's build and its plain fold, over a
   few slice budgets and lane groups (the choice of the package's
   constants), and at its scale-16 shape);
11. the trainer (repro_torch.launch.train and the LM stack under it), with
   the Steiner phases' state freed: starcoder2-3b at full width and all 30
   layers (4.31B params, bf16, f32 AdamW moments, initialized on the card
   from a seed), three steps on one repeated (8, 64) batch (train.py's
   defaults; the loss falls at every step), three on TokenStream batches,
   a breakdown of one step (forward, forward + recomputed forward +
   backward, the update, a profiler pass) and one step at (1, 4096)
   (train_4k's length, its global batch cut from 256 to 1), each with its
   seconds, tokens/s, peak memory and model-FLOPs share of the bf16 peak;
   decode of 8 tokens with a (2, 64) cache against forward's logits (in
   f32 and in bf16 against the model's bf16 noise floor); train() at
   examples/torch_train_lm.py's 100m preset, 24 steps, crashed at step 17
   and relaunched, its final loss equal to an uninterrupted run's (rtol
   1e-4); the five reduced LM configs (f32) card against CPU (a train
   step's loss and gradients, two decode steps, an 8-bit AdamW step); no
   kernel launched;
12. the GNN family and MIND (repro_torch.models.gnn, models.recsys and
   their data) at full width, f32 as configured, each with its steps'
   seconds, losses (falling over three AdamW steps on one batch) and peak
   memory: 12a graphsage-reddit x minibatch_lg on an RMAT graph at Reddit's
   size (scale 18, edge factor 437; build_csr on the host, 1024 batch
   vertices with fanout (15, 10) through sample_neighbors, 602-wide
   features; the graph built on the host in a worker process while
   phase 11 runs); 12b gatedgcn and graphcast x full_graph_sm; 12c schnet x
   molecule (the batched path); 12d graphsage-reddit x ogb_products on the
   full graph; 12e examples/torch_gnn_steiner_sampling.py's loop at full
   width on phase 6's graph (8 steps of 12 seeds, each subgraph from phase
   6's prepared mode="pallas" handle, minplus launches = rounds, the first
   tree = steiner_tree's bit for bit); 12f mind's train_batch (B 65,536),
   serve_p99 (p50 and p99 over 120 calls), serve_bulk (B 262,144) and
   retrieval_cand (10^6 candidates), data from BehaviorStream; 12g the
   reduced configs card vs CPU; no kernel launched by a model;
13. sharded training on a device mesh (repro_torch.distributed,
   launch/mesh.py, every family's param, optimizer and input specs) on a
   (1, 1) DeviceMesh of one NCCL rank: 13a (inside phase 11) starcoder2-3b
   at full width through param_specs, one (8, 64) step on DTensor views of
   phase 11's own parameters and moments against its unsharded step 0
   from the same state (loss and parameters within phase 11's tolerance,
   bit-identical expected), its seconds and peak beside the unsharded
   step's; 13b (inside phase 12) the same for graphsage-reddit x
   ogb_products and mind x train_batch against a step of phase 12's state;
   13c compress_tree over starcoder2-3b's gradient tree (seconds; a slice
   of 2^24 + 37 values bit for bit against the CPU) and compressed_psum on
   the world of one; 13d train()'s checkpoint at the 100m preset restored
   with shardings= equal to the unsharded restore; 13e a table of
   per-device parameter and optimizer-state GB of every train cell of the
   registry on (16, 16) and (2, 16, 16) from shard_shape, beside the
   card's memory (state only: each cell's activations, peak and fit
   verdict come from the dry-run, phase 14 and launch/dryrun.py); 13f (inside phase 11) starcoder2-3b at full width: a
   grad_accum=2 step on DTensor tokens bit for bit the plain grad_accum=2
   step from the same state, a batch_chunks=2 prefill = the plain prefill,
   8 decode tokens through the sharded decode with DTensor caches = phase
   11's decode bit for bit; 13g granite-moe-1b-a400m at full width with
   the 8-bit AdamW: the sharded step (payloads by opt_state_specs) bit for
   bit the plain step; 13h (inside phase 12) schnet x molecule and graphcast
   x full_graph_sm sharded steps against the plain ones (13b's bounds); 13i
   (inside 12f) mind's serve_p99 and retrieval_cand through sharded serving
   = the plain scores within 1e-5 of max, p50 beside the plain p50; every
   part's seconds and peak GB beside the plain path's;
14. the dry-run (repro_torch.launch.dryrun, launch/roofline.py) and the
   examples, as processes of their own (a fake world cannot be made beside
   this process's NCCL world): 14a the dry-run CLI on fake CUDA tensors of
   fake 256- and 512-rank worlds for starcoder2-3b x decode_32k and steiner
   x lvj_1k, each record ok; 14b the dry-run's prediction for phase 13a's
   cell (starcoder2-3b at full width, one (8, 64) sharded step on a (1, 1)
   mesh) held against a real step of it in this process: matmul FLOPs
   (FlopCounterMode around the step) and the bytes of the parameters and
   optimizer state equal exactly, the predicted peak printed beside
   max_memory_allocated (not gated); 14c examples/torch_quickstart.py,
   torch_serve_queries.py, torch_build_store.py and
   torch_steiner_knowledge_graph.py (one NCCL rank) on the card, each
   asserting its own checks;
15. the trace-safety analyzer and the runtime sanitizer
   (src/repro_torch/analysis/, knobs.py), once phase 14's processes are
   started: the ast gate over src/repro_torch against
   ANALYSIS_BASELINE_TORCH.json (exit 0) and the six `--seed-violation`
   spmd programs (exit 1 each, naming their rule), as processes started
   together; a solve at scale 16 on the card and on the CPU under
   `sanitizer()` with equal host-read counts; phase 6's graph prepared anew
   from its host edges (its handle cannot stay on the card through phase
   12f) and its warm full-width pallas solve (= phase 6's D and rounds) and
   phase 7's 8-key batch, each under `sanitizer()`: bit for bit the
   unguarded solve timed just before it, zero rebuilds, launches = rounds,
   and the host reads (by kind), H2D copies and sync_debug_mode warnings
   printed, the dispatch mode's count equal to the function mode's; each
   process of phase 14 is timed to its own end, 14b's step alone;
16. the perf-regression gate (src/repro_torch/obs/regress.py and
   `python -m repro_torch.obs bench`), once phase 14's processes have ended
   so that nothing shares the card with its timings, as processes (its
   mesh1d metric makes a world of its own): 16a `bench --quick --device
   cuda --update-baseline` into a temporary directory, its medians printed
   with the card's name and power limit from the baseline's env; 16b the
   same under REPRO_BENCH_SLOWDOWN=2.5 against that baseline: exit 1 and
   steiner_frontier_messages "ok" and equal to the CPU port's count on the
   same pinned graph (every metric's verdict printed), then under
   REPRO_BENCH_SLOWDOWN=5: exit 1 with every time-derived metric "regress"
   (GATE_FACTOR_WIDE: the card's host moves these metrics by up to 1.6x
   between processes, more than the 1.39x margin that 2.5x leaves over the
   1.8x ratio); 16c a plain re-run against the baseline, its verdicts and
   exit code printed (not gated); then run_bench(["steiner"], k=3,
   quick=True) in this process with the resident kernel's launches counted
   (= rounds x 4 pallas solves);
17. Prim's kernel timed alone (CUDA events over 20 launches) beside its
   plain loop at the paper's |S| = 1024 and clw_10k's 10,240, held equal
   to it there (with --only-prim also at every cluster size its entry
   point takes over PRIM_SWEEP, the sizes behind kernels/mst/prim.py's
   BLOCK_MAX rule); then a line of launches by path, then one JSON line with each kernel's
   launches on its paths (the top-K ones of phase 9 and the gate's
   included), its error and mismatches against the plain version, and its
   time beside its bound and the plain version's time;
18. last line: {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.  Needs one card.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
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


def ptxas_lines(log_text, match="minplus"):
    """One line per kernel named with ``match`` from nvcc's ``-Xptxas -v``
    output: its (demangled) name, registers and shared memory, and spills."""
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
    entries = [e for e in entries if match in e["entry"]]
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


# Prim's kernel against its plain loop: the sizes checked in phase 2 (one
# block and clusters, ragged slices), those timed beside the loop (the
# paper's |S| and clw_10k's), and those of the sweep over cluster sizes.
PRIM_CHECKED = (1, 2, 33, 1025, 4096, 5000, 10240, 12289)
PRIM_TIMED = (1024, 10240)
PRIM_SWEEP = (1024, 2048, 4096, 6144, 8192, 10240, 16384)


def prim_card_table(S, kind, dev):
    """tests/_prim_inputs.py's (S, S) table of ``kind`` on the card."""
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from _prim_inputs import prim_table

    return torch.from_numpy(prim_table(S, kind, seed=S)).to(dev)


def phase2_prim(dev, tally):
    """Prim's kernel against its plain loop on the card, every kind of
    tests/_prim_inputs.py at each S of PRIM_CHECKED."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from _prim_inputs import PRIM_KINDS
    from repro_torch.core.mst import prim_loop
    from repro_torch.kernels.mst import prim as kprim

    for S in PRIM_CHECKED:
        for kind in PRIM_KINDS:
            w = prim_card_table(S, kind, dev)
            tally["prim_call"].compare((kprim.prim_call(w),), (prim_loop(w),),
                                       f"prim {kind} S={S}")


def prim_times(dev, tally, sweep=False):
    """ms of Prim's kernel (CUDA events over 20 launches) on the tie-heavy
    table at each S of PRIM_TIMED, the wrapper's own cluster size, beside
    the plain loop's (2 calls), the kernel held equal to it; with ``sweep``
    also at each S of PRIM_SWEEP and each cluster size the entry point
    takes there.  ``bound_ms`` is the S*S*4 bytes read once at 3.35 TB/s;
    the step chain, S - 1 dependent steps, is what bounds it in fact."""
    from repro_torch.core.mst import prim_loop
    from repro_torch.kernels.mst import prim as kprim

    res = {}
    for S in sorted(set(PRIM_TIMED) | (set(PRIM_SWEEP) if sweep else set())):
        w = prim_card_table(S, "ties", dev)
        row = dict(shape=[S, S], blocks=kprim.cluster_blocks(S),
                   bound_ms=S * S * 4 / HBM_BYTES_PER_S * 1e3)
        if sweep:
            row["blocks_ms"] = {b: event_ms(lambda: kprim._launch(w, b), 20)
                                for b in (1, 2, 4, 8, 12, 16)
                                if -(-S // b) <= kprim.BLOCK_MAX}
        if S in PRIM_TIMED:
            tally["prim_call"].compare((kprim.prim_call(w),), (prim_loop(w),),
                                       f"prim timed S={S}")
            row.update(ms=event_ms(lambda: kprim.prim_call(w), 20),
                       plain_ms=event_ms(lambda: prim_loop(w), 2))
        log(f"prim S={S}: the wrapper's {row['blocks']} block(s)"
            + (f": {row['ms']:.3f} ms, plain loop {row['plain_ms']:.1f} ms"
               if "ms" in row else "")
            + (f"; ms by blocks {json.dumps(row['blocks_ms'])}" if sweep else "")
            + f"; bytes bound {row['bound_ms']:.4f} ms")
        res[S] = row
        del w
    return res


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
    (mode "bucket"); then one (4, 16) batch through the batch backend with
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
    # 12 queries, the default server (mode "bucket", lane by lane on the CPU)
    # the first 6, and 4-lane batches below (cut from 24, 12 and 8 to keep
    # the script in its time; PERF.md §4): the CPU's side takes most of the
    # phase
    queries = [pool[i] for i in zipf_stream(rng, 10, 12, 1.1)]
    launches = {}
    for cfg, stream in ((ServeConfig(mode="pallas", buckets=buckets, max_batch=8), queries),
                        (ServeConfig(), queries[:6])):
        runs = {}
        for d in (dev, "cpu"):
            srv = SteinerServer(graphs[str(d)], cfg, device=d)
            kmod.minplus_call.launches = kmod.minplus_call.lane_launches = 0
            kmod.minplus_blocked_call.launches = 0
            results, secs = serve_stream(srv, stream, 8)
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
        log(f"phase 5: scale 16 server mode={cfg.mode}, {len(stream)} queries: card and CPU "
            f"identical; batches {sg['batches_per_bucket']}, hits {sg['cache_hits']}; lane "
            f"launches {got[0]}; card {tg:.3f} s, cpu {tc:.3f} s")

    rows = np.stack([pad_seed_set(sorted(set(q))[:16], 16) for q in pool[:4]])
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
        log(f"phase 5: scale 16 batch {rows.shape} {kw}: bit-identical; lane rounds "
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
        # 6 queries a pass (cut from 12 to keep the script in its time;
        # PERF.md §4): the CPU's side takes most of the phase
        queries = [pool[i] for i in zipf_stream(rng, 6, 6, 1.1)]
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
    from repro_torch.kernels.mst import prim as kprim
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
    kprim.prim_call.launches = 0
    solves = []
    for i in range(4):
        out, secs = timed(h.solve, seeds)
        solves.append((out, secs))
    rec["prim_launches"] = kprim.prim_call.launches
    if rec["prim_launches"] != 4:
        raise AssertionError(f"4 solves made {rec['prim_launches']} Prim launches, not one each")
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
    warm solve each (the top-K kernel schedule, 10-20 s a solve, one solve),
    all at phase 6's fixpoint bit for bit (state, MST,
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
        # the top-K kernel schedule's solves take 10-20 s each here: one solve
        # (cut from a cold and a warm one to keep the script in its time;
        # PERF.md §4)
        solves = 1 if name == "pallas_frontier" else 2
        warm, warm_s = timed(hs.solve, seeds) if solves == 2 else (cold, cold_s)
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
            ok = (got[0] == 0 and builds == solves * rounds
                  and solves * rounds <= got[1] <= solves * rounds * most)
            launches[f"minplus_blocked_call ({name})"] = got[1]
        elif name == "pallas_frontier":
            ok = got == (solves * rounds, 0)
            launches[f"minplus_call ({name})"] = got[0]
        else:
            ok = got == (0, 0)
        if not ok:
            raise AssertionError(f"{what}: launches (resident, blocked) {got}, {builds} layout "
                                 f"builds for {solves} x {rounds} rounds")
        _, tail_s = timed(smod.finish_pipeline, g, warm.raw.state, warm.raw.stats, S)
        if name == "pallas_frontier":
            # the solve less its tail (the stage is ~100x the tail here;
            # a second run would double the phase)
            voronoi_s, how = cold_s - tail_s, "the solve less its tail"
        else:
            _, voronoi_s = timed(stage, name, cfg, hs, seeds_dev(seeds, dev))
            how = "timed alone"
        key = name if sb is None else f"{name} src_block={sb}"
        rec[key] = dict(K=K, max_iters=max_iters, prepare_s=prep_s, cold_solve_s=cold_s,
                        warm_solve_s=warm_s if solves == 2 else None, tail_s=tail_s,
                        voronoi_s=voronoi_s, voronoi_how=how, iterations=rounds,
                        relaxations=t.relaxations, messages=t.messages, launches=got,
                        layout_builds=builds)
        log(f"phase 9: {what} (K={K}, max_iters={max_iters}): phase 6's fixpoint "
            f"bit for bit; rounds={rounds} relax={t.relaxations} msgs={t.messages}; cold "
            f"{cold_s:.3f} s, " + (f"warm {warm_s:.3f} s" if solves == 2 else "no warm solve")
            + f"; tail {tail_s:.3f} s; Voronoi stage "
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


SERVED = 25  # queries of phase 7's stream served before and after the deltas
# epochs of 100 records through phase 9b's IncrementalSession (cut from 3 to
# keep the script in its time; PERF.md §4)
SESSION_EPOCHS = 1


def span_sums(tracer):
    """Seconds and count of the recorded spans by name (the round spans,
    which subdivide their solve span, left out), longest first."""
    sums = {}
    for e in tracer.events():
        if e["ph"] == "X" and not e["name"].startswith("round["):
            s, k = sums.get(e["name"], (0.0, 0))
            sums[e["name"]] = (s + e["dur"] / 1e6, k + 1)
    return dict(sorted(sums.items(), key=lambda kv: -kv[1][0]))


def compact_full_width(dev, store, path, seeds, pad_rows):
    """Phase 9b's compaction: the store with its segments (the server's
    epoch and the session's SESSION_EPOCHS) folded by ``compact``; the
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
    if not (stats.segments_folded == segments == 1 + SESSION_EPOCHS
            and stats.records_folded == 100 * (1 + SESSION_EPOCHS)
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
    mutated store; an IncrementalSession (K = 8192) through SESSION_EPOCHS
    such epochs, the last bit-identical to a cold frontier solve; Borůvka beside Prim on
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
        # the first SERVED queries of the stream, then the next SERVED (cut
        # from 100 and 100 to keep the script in its time; PERF.md §4)
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
        for e in range(SESSION_EPOCHS):
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


# Phase 10's configurations: the paper presets (repro_torch.configs.steiner,
# the reference's src/repro/configs/steiner.py) cut from a (16, 16) mesh to
# one rank, and beside them dense, Borůvka, per-rank telemetry and mesh2d
# over lvj_1k's: (name, preset, knobs)
MESH_RUNS = (
    ("lvj_1k", "lvj_1k", {}),
    ("dense", "lvj_1k", dict(mode="dense")),
    ("mesh_frontier", "mesh_frontier", {}),
    ("clw_10k knobs", "clw_10k", {}),
    ("boruvka", "lvj_1k", dict(mst_algo="boruvka")),
    ("per-rank telemetry", "lvj_1k", dict(telemetry_rounds=64, telemetry_per_rank=True)),
    ("mesh2d", "lvj_1k", dict(backend="mesh2d")),
)
MESH_FIELDS = ("dist", "lab", "pred", "marked", "path_edge", "bridge_u", "bridge_v",
               "bridge_w", "bridge_valid", "total_distance", "num_edges", "iterations",
               "relaxations", "messages", "history", "per_rank")
# BENCH_steiner.json's mesh rows at scale 10: (total, rounds, relaxations,
# messages); the frontier row runs at frontier_size=256
MESH_SCALE10 = {"bucket": (547.0, 17, 2550, 257061), "frontier": (547.0, 10, 2248, 31047)}


def mesh_config(name, **kw):
    from repro_torch.configs.steiner import solver_preset

    _, preset, knobs = next(run for run in MESH_RUNS if run[0] == name)
    return solver_preset(preset).replace(mesh_shape=(1, 1), **{**knobs, **kw})


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
    config at full width on phase 6's graph and seeds (a cold solve, and
    for lvj_1k a warm one, each state and tree = phase 6's single solve;
    Borůvka's = the single Borůvka tree of phase 6's state), a profiler
    pass over the bucket solve with the NCCL share of device time; the
    scale-10 fixed answers;
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
    for name, *_ in MESH_RUNS:
        cfg = mesh_config(name)
        hm, prep_s = timed(lambda: SteinerSolver(cfg, device=dev).prepare(h.graph))
        cold, cold_s = timed(hm.solve, seeds)
        # a warm solve of the lvj_1k preset only (the others' cut to keep the
        # script in its time; phase 10c solves mesh1d bucket warm too)
        warm, warm_s = timed(hm.solve, seeds) if name == "lvj_1k" else (cold, None)
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
            f"{cold_s:.3f} s" + (f", warm {warm_s:.3f} s" if warm_s else "")
            + f"; rounds {t.iterations}, relaxations "
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
    for name, *_ in MESH_RUNS:
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


# Phase 10c: examples/torch_steiner_knowledge_graph.py's queries at full width,
# (|S|, strategy, draw seed): the example's, but drawn uniformly.  A bfs_level
# draw builds a scipy CSR of 3.0e8 entries on the host at this width: its two
# draws took 67.4 s on the card's host (an H100 machine, 8 cores), more than
# the whole phase otherwise (the example's RMAT 13 keeps bfs_level)
KG_QUERIES = ((8, "uniform", 100), (64, "uniform", 101), (256, "uniform", 102))


def load_example(root, name):
    """An example of the repo loaded by path as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, root / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase10c_knowledge_graph(dev, h, single_in, g_host, root):
    """The paper's knowledge-graph workflow at full width on one NCCL rank:
    examples/torch_steiner_knowledge_graph.py's SolverConfig (mesh1d, bucket,
    local_steps=2, Prim) prepared on phase 6's graph (phase 10's partition
    reused where the memo still holds it), its query loop and repeat over
    phase 6's host edges, then phase 6's 1,024 seeds cold and warm, and the
    same seeds under local_steps=1 for their rounds.  Each answer's state
    and tree = a single-device pallas solve of its seeds on phase 6's handle
    (the resident kernel, launches = rounds; phase 6's own for the 1,024
    seeds); the mesh solves launch no kernel.  Returns the record and the
    reference solves' launches."""
    import torch
    import torch.distributed as dist

    from repro_torch import knobs
    from repro_torch.solver import SteinerSolver

    kg = load_example(root, "torch_steiner_knowledge_graph")
    seeds, ref = single_in
    src, dst, _, n = g_host
    rec = {}
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = kg.knowledge_graph_config((1, 1))
    builds = knobs.build_count("view")
    hm, rec["prepare_s"] = timed(lambda: SteinerSolver(cfg, device=dev).prepare(h.graph))
    rec["partition_rebuilt"] = knobs.build_count("view") - builds
    log(f"phase 10c: {cfg.backend} {cfg.mode} local_steps={cfg.local_steps} mst_algo="
        f"{cfg.mst_algo}, mesh {cfg.mesh_shape}: prepare {rec['prepare_s']:.3f} s, partition "
        + ("reused from phase 10" if rec["partition_rebuilt"] == 0 else "rebuilt"))

    zero_kernel_counts()
    t0 = time.perf_counter()
    recs = kg.answer_queries(hm, n, src, dst, KG_QUERIES, log=lambda m: log(f"phase 10c: {m}"))
    rec["draw_s"] = time.perf_counter() - t0 - sum(r["s"] for r in recs)
    recs.append(kg.repeat_query(hm, n, src, dst, log=lambda m: log(f"phase 10c: {m}")))
    cold, cold_s = timed(hm.solve, seeds)
    warm, warm_s = timed(hm.solve, seeds)
    if any(kernel_counts().values()):
        raise AssertionError(f"the mesh path launched {kernel_counts()}")
    one, one_s = timed(SteinerSolver(cfg.replace(local_steps=1), device=dev).prepare(
        h.graph).solve, seeds)
    same_mesh(warm.raw, cold.raw, "10c: |S|=1024 warm vs cold")
    same_as_single(cold.raw, ref.raw, "10c: |S|=1024")
    same_as_single(one.raw, ref.raw, "10c: |S|=1024 under local_steps=1")

    # each answer against a single-device pallas solve of its seeds
    rounds = 0
    for i, r in enumerate(recs):
        single = h.solve(r["seeds"])
        rounds += single.telemetry.iterations
        same_as_single(r["out"].raw, single.raw, f"10c: query {i} (|S|={len(r['seeds'])})")
    launches = kernel_counts()
    if (launches["minplus_call"], launches["pack_records"]) != (rounds, rounds) or any(
            v for k, v in launches.items() if k not in ("minplus_call", "pack_records")):
        raise AssertionError(f"10c's reference solves launched {launches} for {rounds} rounds")
    rec["queries"] = [dict(seeds=len(r["seeds"]), s=r["s"], rounds=r["out"].raw.iterations,
                           relaxations=r["out"].raw.relaxations, messages=r["out"].raw.messages,
                           total_distance=r["out"].total_distance, num_edges=r["out"].num_edges)
                      for r in recs]
    t, t1 = cold.telemetry, one.telemetry
    rec.update(cold_s=cold_s, warm_s=warm_s, rounds=t.iterations, relaxations=t.relaxations,
               messages=t.messages, local_steps_1=dict(rounds=t1.iterations, s=one_s,
                                                       messages=t1.messages),
               reference_launches=launches["minplus_call"],
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"phase 10c: |S|={len(seeds)} (phase 6's seeds): cold {cold_s:.3f} s, warm {warm_s:.3f} "
        f"s; rounds {t.iterations}, relaxations {t.relaxations}, messages {t.messages}; under "
        f"local_steps=1 rounds {t1.iterations}, messages {t1.messages} ({one_s:.3f} s); "
        f"D={cold.total_distance} edges={cold.num_edges}")
    log(f"phase 10c: each query's seeds, seconds, rounds, relaxations, messages, D and edges: "
        f"{json.dumps(rec['queries'])}")
    log(f"phase 10c: every answer's state and tree = a single pallas solve of its seeds "
        f"(phase 6's for |S|={len(seeds)}); the mesh solves launched no kernel, the "
        f"{len(recs)} reference solves {launches['minplus_call']} minplus_call (= rounds); seed "
        f"draws {rec['draw_s']:.1f} s; peak {rec['peak_mem_gb']:.1f} GB")
    del hm, cold, warm, one, recs
    dist.destroy_process_group()  # the world of one the backend made
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 10c: {rec['phase_s']:.1f} s")
    return rec, launches["minplus_call"]


def phase10b_obs(dev, h, single_in, lanes_in, mesh_rec):
    """Observability on the card, with obs on (reset and off at the end): a
    traced prepare and warm solve on phase 6's graph (mode "pallas",
    resident) bit-identical to phase 6's with as many launches, its trace
    validated and holding the prepare, solve, 20 measured round spans and
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
            and not any("synthetic_timing" in e["args"] for e in rounds)
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
        f"prepare, prepare:ell_build, solve, {len(rounds)} measured round spans, "
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


# ---- phase 13: sharded training on a device mesh (src/repro_torch/distributed/,
# launch/mesh.py and every family's param, optimizer and input specs), run
# inside phases 11 and 12 on one NCCL rank: a (1, 1) DeviceMesh

COMPRESS_SLICE = (1 << 24) + 37  # values held bit for bit against the CPU (13c)
PROD_MESHES = (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")))


_ONE_RANK = []


def one_rank_mesh(dev):
    """A (1, 1) ("data", "model") DeviceMesh on this card (a world of one,
    NCCL, made by launch/mesh.py if phase 10's is gone); one for the run."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    if not _ONE_RANK or not dist.is_initialized():
        _ONE_RANK[:] = [make_test_mesh((1, 1), ("data", "model"), device=dev.type)]
    return _ONE_RANK[0]


def wrap(tree, specs):
    """``tree``'s tensors as DTensors laid out by ``specs`` (a tree of
    ShapeDtypeStructs): ``DTensor.from_local`` views, no copy (on a (1, 1)
    mesh a rank's block is the whole tensor)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_map

    def one(t, s):
        sh = s.sharding
        if tuple(t.shape) != sh.shard_shape(s.shape):
            raise AssertionError(f"a {tuple(t.shape)} block for {s}")
        return DTensor.from_local(t, sh.mesh, sh.placements, run_check=False)

    return tree_map(one, tree, specs)


def params_vs(dev, got, want_host, lr=None, chunk=1 << 27):
    """Parameters (card) against a step's (host copies): (bit-identical,
    largest |diff| over max|want|, share of elements off rtol/atol 1e-5 of
    max).  Without ``lr``: fail above phase 11's gradient tolerance
    (GRADS_ATOL of max + 1e-5·|want|); with it (the card's atomic sums):
    fail above 2·lr + 1e-5·|want| or with more than 0.1 % of the elements
    off (tests/test_torch_sharded_steps.py's one-step bound).  Compared in
    chunks of ``chunk`` elements (f32 temporaries of a 1.1·10^9-element
    stack would not fit beside phase 11's state)."""
    same, worst, off, total = True, 0.0, 0, 0
    for a, h in zip(got, want_host):
        a, h = a.reshape(-1), h.reshape(-1)
        scale = max(float(h[i:i + chunk].to(dev).float().abs().max())
                    for i in range(0, h.numel(), chunk))
        for i in range(0, a.numel(), chunk):
            x, y = a[i:i + chunk], h[i:i + chunk].to(dev)
            same = same and bool((x == y).all())
            d = (x.float() - y.float()).abs()
            yf = y.float().abs()
            worst = max(worst, float(d.max()) / max(scale, 1e-30))
            tol = (2 * lr if lr else GRADS_ATOL * scale) + 1e-5 * yf
            if not bool((d <= tol).all()):
                raise AssertionError(f"sharded vs unsharded parameters off by {float(d.max())}")
            off += int((d > 1e-5 * scale + 1e-5 * yf).sum())
            total += y.numel()
            del y, d, yf
    if lr and off > 1e-3 * total:
        raise AssertionError(f"{off} of {total} parameters off after one step")
    return same, worst, off / max(total, 1)


def phase13a_sharded_lm(dev, cfg, params, opt_state, step, tok, opt_cfg, rec):
    """13a: starcoder2-3b at full width through ``param_specs`` on a (1, 1)
    mesh.  Phase 11's unsharded step 0 from the fresh state; the state it
    started from restored (parameters from a host copy, moments zeroed);
    one sharded step (``make_train_step(..., ("data",),
    param_shardings=...)``) on DTensor views of the same tensors and the
    batch placed by ``input_specs``; loss, parameters and moments against
    the unsharded step's.  Returns phase 11's step-0 row."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import opt_state_specs
    from repro_torch.tree import tree_leaves

    leaves, moments = tree_leaves(params), tree_leaves(opt_state["mu"])
    p0 = [t.to("cpu", copy=True) for t in leaves]
    row = train_step_row(step, params, opt_state, tok, cfg, "repeated batch, step 0")
    p1 = [t.to("cpu", copy=True) for t in leaves]
    msum = [float(t.sum(dtype=torch.float64)) for t in moments]
    with torch.no_grad():
        for t, h in zip(leaves, p0):
            t.copy_(h)
        for t in moments:
            t.zero_()
    del p0
    opt_state["count"] = torch.zeros((), dtype=torch.int32, device=dev)
    mesh = one_rank_mesh(dev)
    specs = tf.param_specs(cfg, mesh)
    ospecs = opt_state_specs(specs, opt_cfg, mesh)
    cell = ShapeSpec(name="phase11", kind="train", seq_len=tok.shape[1],
                     global_batch=tok.shape[0])
    dtok = tf.input_specs(cfg, cell, mesh)["tokens"].sharding.distribute(tok)
    sstep = tf.make_train_step(cfg, opt_cfg, ("data",), param_shardings=specs)
    torch.cuda.reset_peak_memory_stats()
    (_, dstate, loss), s = timed(sstep, wrap(params, specs), wrap(opt_state, ospecs), dtok)
    peak = torch.cuda.max_memory_allocated() / 1e9
    opt_state["count"] = dstate["count"].to_local()
    same, worst, _ = params_vs(dev, leaves, p1)
    del p1
    m_same = all(float(t.sum(dtype=torch.float64)) == m for t, m in zip(moments, msum))
    loss_err = abs(float(loss) - row["loss"]) / abs(row["loss"])
    rec["13a"] = {"loss": float(loss), "loss_unsharded": row["loss"], "loss_rel_err": loss_err,
                  "params_bit_identical": same, "params_max_err": worst,
                  "moment_sums_equal": m_same, "s": s, "s_unsharded_step0": row["s"],
                  "peak_gb": peak, "peak_gb_unsharded": row["peak_gb"]}
    log(f"phase 13a: {cfg.name} at full width through param_specs on a (1, 1) DeviceMesh "
        f"(one NCCL rank), one ({tok.shape[0]}, {tok.shape[1]}) step on phase 11's batch from "
        f"phase 11's fresh state: loss {float(loss):.6f} against the unsharded "
        f"{row['loss']:.6f} (rel {loss_err:.2e}); parameters bit-identical {same} (largest "
        f"diff {worst:.2e} of max, phase 11's tolerance {GRADS_ATOL} of max + rtol 1e-5), "
        f"moment sums equal {m_same}; sharded step {s:.3f} s against the unsharded step 0's "
        f"{row['s']:.3f} s; peak {peak:.2f} GB against {row['peak_gb']:.2f} GB")
    if loss_err > LOSS_RTOL:
        raise AssertionError(f"13a: the sharded step's loss differs: {rec['13a']}")
    return row


def phase13c_compress(dev, grads, rec):
    """13c: ``compress_tree`` over starcoder2-3b's full gradient tree (a
    leaf at a time: the whole tree's f32 residuals and int8 payload would
    not fit beside phase 11's state), a slice of COMPRESS_SLICE values of
    one leaf bit for bit against the CPU, and ``compressed_psum`` on the
    world of one (its mean = the dequantized payload)."""
    import torch

    from repro_torch.distributed.compression import _dequant, compress_tree, compressed_psum
    from repro_torch.tree import tree_leaves

    flat = [g for x in tree_leaves(grads) for g in (x if isinstance(x, list) else [x])]
    n = sum(g.numel() for g in flat)
    sync()
    t0 = time.perf_counter()
    q_bytes = 0
    for g in flat:
        q8, err = compress_tree({"g": g}, {"g": torch.zeros(g.shape, device=dev)})
        q_bytes += q8["g"][0].numel() + 4 * q8["g"][1].numel()
        del q8, err
    sync()
    whole_s = time.perf_counter() - t0
    big = next(g for g in flat if g.numel() >= COMPRESS_SLICE)
    part = big.reshape(-1)[:COMPRESS_SLICE].contiguous()
    e = torch.randn(part.shape, generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev) * 1e-3
    (qd, ed), slice_s = timed(compress_tree, {"g": part}, {"g": e})
    qc, ec = compress_tree({"g": part.cpu()}, {"g": e.cpu()})
    same = (torch.equal(qd["g"][0].cpu(), qc["g"][0]) and torch.equal(qd["g"][1].cpu(), qc["g"][1])
            and torch.equal(ed["g"].cpu(), ec["g"]))
    one_rank_mesh(dev)  # the world of one
    _, psum_first_s = timed(compressed_psum, {"g": part}, {"g": e})  # NCCL's setup
    (red, _), psum_s = timed(compressed_psum, {"g": part}, {"g": e})
    psum_ok = torch.equal(red["g"], _dequant(qd["g"][0], qd["g"][1], part.shape, torch.float32))
    rec["13c"] = {"values": n, "leaves": len(flat), "s": whole_s, "wire_gb": q_bytes / 1e9,
                  "slice": COMPRESS_SLICE, "slice_s": slice_s, "bit_identical_to_cpu": same,
                  "psum_first_s": psum_first_s, "psum_s": psum_s,
                  "psum_equals_dequant": psum_ok}
    log(f"phase 13c: compress_tree over starcoder2-3b's gradient tree ({n} values in "
        f"{len(flat)} leaves, a leaf at a time) {whole_s:.3f} s, int8 payload + scales "
        f"{q_bytes / 1e9:.2f} GB; a slice of {COMPRESS_SLICE} values bit-identical to the CPU "
        f"{same} ({slice_s * 1e3:.2f} ms on the card); compressed_psum of that slice on the world "
        f"of one {psum_s * 1e3:.2f} ms (the first call {psum_first_s * 1e3:.2f} ms), its mean = "
        f"the dequantized payload {psum_ok}")
    if not (same and psum_ok):
        raise AssertionError(f"13c: {rec['13c']}")


def phase13d_elastic_restore(dev, preset, ckpt_dir, rec):
    """13d: the newest checkpoint of train() at ``preset`` restored onto the
    (1, 1) mesh with ``shardings=`` (param_specs and opt_state_specs) and
    unsharded: every leaf equal."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import transformer as tf
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.optim.adamw import opt_state_specs
    from repro_torch.tree import tree_leaves

    params = tf.init_params(preset, torch.Generator(device=dev).manual_seed(0))
    opt = OptConfig(lr=3e-4)
    template = {"params": params, "opt": adamw_init(params, opt)}
    mesh = one_rank_mesh(dev)
    specs = tf.param_specs(preset, mesh)
    mgr = CheckpointManager(ckpt_dir)
    (step, sharded), s = timed(mgr.restore, template, shardings={
        "params": specs, "opt": opt_state_specs(specs, opt, mesh)})
    _, plain = mgr.restore(template)
    a, b = tree_leaves(sharded), tree_leaves(plain)
    same = len(a) == len(b) and all(torch.equal(x.to_local(), y) for x, y in zip(a, b))
    rec["13d"] = {"step": step, "leaves": len(a), "s": s, "equal": same}
    log(f"phase 13d: train()'s step-{step} checkpoint at {preset.name} restored onto the (1, 1) "
        f"mesh with shardings= in {s:.3f} s: {len(a)} DTensor leaves, equal to the unsharded "
        f"restore {same}")
    if not same:
        raise AssertionError("13d: the sharded restore differs")


def phase13b_sharded_vs_plain(dev, what, step, params, opt_state, batch, pspecs, ospecs,
                              ispecs, lr, tag="13b"):
    """13b: one unsharded step from a cell's current state, the state
    restored from copies on the card, one step on DTensor views through
    the cell's specs on a (1, 1) mesh; loss and parameters against the
    unsharded step's (the card's scatter-adds sum in atomic order: loss
    rtol 1e-5, parameters within ``params_vs``' one-step bound)."""
    import torch

    from repro_torch.tree import tree_leaves

    leaves, moments = tree_leaves(params), tree_leaves(opt_state["mu"])
    p0 = [t.clone() for t in leaves]
    m0 = [t.clone() for t in moments]
    c0 = opt_state["count"].clone()
    (_, _, loss_u), s_u = timed(step, params, opt_state, batch)
    p1 = [t.to("cpu", copy=True) for t in leaves]
    with torch.no_grad():
        for t, c in zip(leaves + moments, p0 + m0):
            t.copy_(c)
    opt_state["count"] = c0
    del p0, m0
    mesh = one_rank_mesh(dev)
    dbatch = {k: ispecs(mesh)[k].sharding.distribute(v) for k, v in batch.items()}
    torch.cuda.reset_peak_memory_stats()
    (_, dstate, loss), s = timed(step, wrap(params, pspecs(mesh)),
                                 wrap(opt_state, ospecs(mesh)), dbatch)
    peak = torch.cuda.max_memory_allocated() / 1e9
    opt_state["count"] = dstate["count"].to_local()
    same, worst, off = params_vs(dev, leaves, p1, lr=lr)
    loss_err = abs(float(loss) - float(loss_u)) / abs(float(loss_u))
    out = {"loss": float(loss), "loss_unsharded": float(loss_u), "loss_rel_err": loss_err,
           "params_bit_identical": same, "params_max_err": worst, "params_off_share": off,
           "s": s, "s_unsharded": s_u, "peak_gb": peak}
    log(f"phase {tag}: {what} on the (1, 1) mesh: loss {float(loss):.6f} against the "
        f"unsharded {float(loss_u):.6f} (rel {loss_err:.2e}, at most 1e-5); parameters "
        f"bit-identical {same}, largest diff {worst:.2e} of max, {off:.2e} of them off 1e-5 (at "
        f"most 2·lr and 1e-3); sharded step {s:.3f} s against {s_u:.3f} s unsharded; peak "
        f"{peak:.2f} GB")
    if loss_err > 1e-5:
        raise AssertionError(f"{tag} {what}: {out}")
    return out


def phase13f_lm_paths(dev, cfg, params, tok, rec):
    """13f: starcoder2-3b at full width through the specs on the (1, 1)
    mesh.  A grad_accum=2 step from fresh zero moments, plain and then on
    DTensor views with DTensor tokens from the same state restored (the
    parameters from a host copy): bit for bit.  A batch_chunks=2 prefill,
    plain and on DTensors: equal.  Returns the parameters as they were."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import full
    from repro_torch.models import transformer as tf
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.optim.adamw import opt_state_specs
    from repro_torch.tree import tree_leaves

    opt_cfg = OptConfig(lr=1e-3)
    mesh = one_rank_mesh(dev)
    specs = tf.param_specs(cfg, mesh)
    leaves = tree_leaves(params)
    p0 = [t.to("cpu", copy=True) for t in leaves]
    state = adamw_init(params, opt_cfg)
    torch.cuda.reset_peak_memory_stats()
    (_, _, loss_u), s_u = timed(tf.make_train_step(cfg, opt_cfg, grad_accum=2), params, state,
                                tok)
    peak_u = torch.cuda.max_memory_allocated() / 1e9
    p1 = [t.to("cpu", copy=True) for t in leaves]
    msum = [float(t.sum(dtype=torch.float64)) for t in tree_leaves(state["mu"])]
    with torch.no_grad():
        for t, h in zip(leaves, p0):
            t.copy_(h)
        for t in tree_leaves(state["mu"]):
            t.zero_()
    state["count"] = torch.zeros((), dtype=torch.int32, device=dev)
    cell = ShapeSpec(name="13f", kind="train", seq_len=tok.shape[1], global_batch=tok.shape[0])
    dtok = tf.input_specs(cfg, cell, mesh)["tokens"].sharding.distribute(tok)
    sstep = tf.make_train_step(cfg, opt_cfg, ("data",), grad_accum=2, param_shardings=specs)
    torch.cuda.reset_peak_memory_stats()
    (_, _, loss), s = timed(sstep, wrap(params, specs),
                            wrap(state, opt_state_specs(specs, opt_cfg, mesh)), dtok)
    peak = torch.cuda.max_memory_allocated() / 1e9
    same, worst, _ = params_vs(dev, leaves, p1)
    m_same = all(float(t.sum(dtype=torch.float64)) == m
                 for t, m in zip(tree_leaves(state["mu"]), msum))
    del state, p1
    with torch.no_grad():  # the parameters phase 11 left, for its decode
        for t, h in zip(leaves, p0):
            t.copy_(h)
    del p0
    torch.cuda.empty_cache()
    rec["13f_accum"] = {"loss": float(loss), "loss_plain": float(loss_u),
                        "params_bit_identical": same, "params_max_err": worst,
                        "moment_sums_equal": m_same, "s": s, "s_plain": s_u, "peak_gb": peak,
                        "peak_gb_plain": peak_u}
    log(f"phase 13f: {cfg.name} grad_accum=2 ({tok.shape[0]}, {tok.shape[1]}) step on DTensor "
        f"tokens: loss {float(loss):.6f} against the plain {float(loss_u):.6f}; parameters "
        f"bit-identical {same} (largest diff {worst:.2e} of max), moment sums equal {m_same}; "
        f"{s:.3f} s against {s_u:.3f} s plain; peak {peak:.2f} GB against {peak_u:.2f} GB")
    if not (same and m_same and float(loss) == float(loss_u)):
        raise AssertionError(f"13f: the sharded grad_accum step differs: {rec['13f_accum']}")
    # prefill in two chunks of the global rows
    from repro_torch.data.tokens import TokenStream

    ptok = torch.from_numpy(TokenStream(cfg.vocab, PREFILL_B, PREFILL_S, seed=3).batch_at(0)
                            ).to(dev)
    pcell = ShapeSpec(name="13f", kind="prefill", seq_len=PREFILL_S, global_batch=PREFILL_B)
    torch.cuda.reset_peak_memory_stats()
    want, s_u = timed(tf.make_prefill_step(cfg, batch_chunks=2), params, ptok)
    peak_u = torch.cuda.max_memory_allocated() / 1e9
    dp = tf.input_specs(cfg, pcell, mesh)["tokens"].sharding.distribute(ptok)
    torch.cuda.reset_peak_memory_stats()
    got, s = timed(tf.make_prefill_step(cfg, ("data",), batch_chunks=2), wrap(params, specs), dp)
    peak = torch.cuda.max_memory_allocated() / 1e9
    got = full(got)
    equal = bool(torch.equal(got, want))
    rec["13f_prefill"] = {"B": PREFILL_B, "S": PREFILL_S, "equal": equal,
                          "max_err": rel_err(got, want), "s": s, "s_plain": s_u,
                          "peak_gb": peak, "peak_gb_plain": peak_u}
    log(f"phase 13f: {cfg.name} batch_chunks=2 prefill ({PREFILL_B}, {PREFILL_S}) on DTensor "
        f"tokens: last-token logits {tuple(got.shape)} equal to the plain prefill's {equal}; "
        f"{s:.3f} s against {s_u:.3f} s plain; peak {peak:.2f} GB against {peak_u:.2f} GB")
    if not equal:
        raise AssertionError(f"13f: the sharded prefill differs: {rec['13f_prefill']}")


def phase13f_decode(dev, cfg, params, prompt, want, plain_s, rec):
    """13f: the prompt's tokens one at a time through the sharded decode
    (parameters by ``param_specs``, caches by ``_cache_specs``, tokens and
    ``cache_len`` by ``input_specs``) on the (1, 1) mesh: phase 11's bf16
    decode logits bit for bit."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import full
    from repro_torch.models import transformer as tf

    mesh = one_rank_mesh(dev)
    B, n = prompt.shape
    ispecs = tf.input_specs(cfg, ShapeSpec(name="13f", kind="decode", seq_len=64,
                                           global_batch=B), mesh)
    dparams = wrap(params, tf.param_specs(cfg, mesh))

    def decode():
        caches = tf.caches_from_specs(ispecs["caches"])
        step = tf.make_decode_step(cfg)
        out = []
        for i in range(n):
            clen = ispecs["cache_len"].sharding.distribute(
                torch.tensor(i, dtype=torch.int32, device=dev))
            lg, caches = step(dparams, caches, ispecs["tokens"].sharding.distribute(prompt[:, i]),
                              clen)
            out.append(full(lg))
        return torch.stack(out, 1)

    torch.cuda.reset_peak_memory_stats()
    got, s = timed(decode)
    peak = torch.cuda.max_memory_allocated() / 1e9
    equal = bool(torch.equal(got, want))
    rec["13f_decode"] = {"tokens": n, "B": B, "equal": equal, "max_err": rel_err(got, want),
                         "s": s, "s_plain": plain_s, "peak_gb": peak}
    log(f"phase 13f: {cfg.name} {n} decode tokens of a ({B}, 64) cache through the sharded "
        f"decode (DTensor caches by _cache_specs): logits equal to phase 11's bf16 decode "
        f"{equal}; {s:.3f} s against {plain_s:.3f} s plain; peak {peak:.2f} GB")
    if not equal:
        raise AssertionError(f"13f: the sharded decode differs: {rec['13f_decode']}")


def phase13g_q8(dev, rec):
    """13g: granite-moe-1b-a400m at full width with the 8-bit AdamW: one
    plain step from fresh moments, then the parameters restored and one
    step on DTensor views with 8-bit moments laid out by
    ``opt_state_specs`` (``zeros_from_specs``): parameters, payloads,
    scales and loss bit for bit."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import transformer as tf
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.distributed.sharding import zeros_from_specs
    from repro_torch.optim.adamw import opt_state_specs
    from repro_torch.tree import tree_leaves

    cfg = get_arch("granite-moe-1b-a400m").model
    q8 = OptConfig(lr=1e-3, quantized=True)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    leaves = tree_leaves(params)
    tok = torch.from_numpy(TokenStream(cfg.vocab, Q8_B, Q8_S, seed=4).batch_at(0)).to(dev)
    p0 = [t.clone() for t in leaves]
    state = adamw_init(params, q8)
    torch.cuda.reset_peak_memory_stats()
    (_, state, loss_u), s_u = timed(tf.make_train_step(cfg, q8), params, state, tok)
    peak_u = torch.cuda.max_memory_allocated() / 1e9
    p1 = [t.clone() for t in leaves]
    q1 = [(st.q.clone(), st.scale.clone()) for st in tree_leaves(state["mu"])]
    del state
    with torch.no_grad():
        for t, c in zip(leaves, p0):
            t.copy_(c)
    del p0
    mesh = one_rank_mesh(dev)
    specs = tf.param_specs(cfg, mesh)
    dstate = zeros_from_specs(opt_state_specs(specs, q8, mesh))
    cell = ShapeSpec(name="13g", kind="train", seq_len=Q8_S, global_batch=Q8_B)
    dtok = tf.input_specs(cfg, cell, mesh)["tokens"].sharding.distribute(tok)
    torch.cuda.reset_peak_memory_stats()
    (_, dstate, loss), s = timed(tf.make_train_step(cfg, q8, ("data",), param_shardings=specs),
                                 wrap(params, specs), dstate, dtok)
    peak = torch.cuda.max_memory_allocated() / 1e9
    p_same = all(bool(torch.equal(a, b)) for a, b in zip(leaves, p1))
    q_same = all(bool(torch.equal(st.q.to_local(), q)) and
                 bool(torch.equal(st.scale.to_local(), sc))
                 for st, (q, sc) in zip(tree_leaves(dstate["mu"]), q1))
    rec["13g"] = {"arch": cfg.name, "params": cfg.params_count(), "loss": float(loss),
                  "loss_plain": float(loss_u), "params_bit_identical": p_same,
                  "q8_bit_identical": q_same, "s": s, "s_plain": s_u, "peak_gb": peak,
                  "peak_gb_plain": peak_u}
    log(f"phase 13g: {cfg.name} at full width ({cfg.params_count()} params), one ({Q8_B}, "
        f"{Q8_S}) step with 8-bit AdamW moments: sharded (payloads by opt_state_specs) against "
        f"plain: loss {float(loss):.6f} / {float(loss_u):.6f}, parameters bit-identical "
        f"{p_same}, payloads and scales bit-identical {q_same}; {s:.3f} s against {s_u:.3f} s "
        f"plain; peak {peak:.2f} GB against {peak_u:.2f} GB")
    if not (p_same and q_same and float(loss) == float(loss_u)):
        raise AssertionError(f"13g: the sharded 8-bit step differs: {rec['13g']}")
    del params, dstate, p1, q1
    torch.cuda.empty_cache()


def phase13e_state_table(dev):
    """13e: per-device bytes of the parameters and optimizer state
    (``shard_shape`` of ``param_specs`` and ``opt_state_specs``, host
    arithmetic only) of every train cell of the registry on the two
    production meshes, beside this card's memory.  State only: each
    cell's activations, peak and fit verdict come from the dry-run
    (phase 14, ``launch/dryrun.py``)."""
    import math as _m

    import torch

    from repro_torch.configs import ARCH_IDS, get_arch
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.models import gnn, recsys, transformer
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import opt_state_specs
    from repro_torch.tree import tree_leaves

    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9

    def gb(tree):
        out = 0
        for s in tree_leaves(tree):
            parts = [s.q, s.scale] if hasattr(s, "q") else [s]
            for p in parts:
                item = torch.empty((), dtype=p.dtype).element_size()
                out += _m.prod(p.sharding.shard_shape(p.shape)) * item
        return out / 1e9

    rows = []
    for arch in ARCH_IDS:
        spec = get_arch(arch)
        cfg = spec.model
        for shape in spec.shapes:
            if shape.kind not in ("train", "gnn_full", "gnn_sampled", "gnn_batched",
                                  "recsys_train"):
                continue
            for dims, axes in PROD_MESHES:
                mesh = AbstractMesh(dims, axes)
                if spec.family == "lm":
                    ps = transformer.param_specs(cfg, mesh)
                    opt = OptConfig(quantized=cfg.params_count() > 1e11)
                elif spec.family == "gnn":
                    ps = gnn.param_specs(cfg, gnn.effective_graph(shape)[2], mesh)
                    opt = OptConfig()
                else:
                    ps = recsys.param_specs(cfg, mesh)
                    opt = OptConfig()
                p_gb, o_gb = gb(ps), gb(opt_state_specs(ps, opt, mesh))
                rows.append({"arch": arch, "shape": shape.name, "mesh": list(dims),
                             "params_gb": p_gb, "opt_gb": o_gb, "state_gb": p_gb + o_gb,
                             "quantized_moments": opt.quantized,
                             "share_of_card": (p_gb + o_gb) / card_gb})
    log(f"phase 13e: per-device parameters + optimizer state from shard_shape (host "
        f"arithmetic; state only: each cell's activations, peak and fit verdict come from the "
        f"dry-run, phase 14 and python -m repro_torch.launch.dryrun; "
        f"the port's sharded step also holds one layer gathered over the ZeRO axes at a time, "
        f"its shard of 'model' kept split), beside this card's {card_gb:.1f} GB:")
    for r in rows:
        log(f"phase 13e:   {r['arch']} x {r['shape']} on {tuple(r['mesh'])}: params "
            f"{r['params_gb']:.4f} GB + optimizer {r['opt_gb']:.4f} GB"
            f"{' (8-bit moments)' if r['quantized_moments'] else ''} = {r['state_gb']:.4f} GB, "
            f"{r['share_of_card']:.4f} of the card")
    return {"card_gb": card_gb, "rows": rows}


# ---- phase 11: the trainer (src/repro_torch/launch/train.py and the LM stack)

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak (data sheet, 700 W)
TRAIN_B, TRAIN_S = 8, 64  # train.py's defaults
LONG_S = 4096  # LM_SHAPES train_4k's sequence length (its global batch 256 cut to 1)
# card vs CPU of the reduced configs (f32 variants): |card - cpu| <= atol +
# rtol·|cpu|, atol a fraction of max|cpu| (tests/test_torch_lm.py's)
LOSS_RTOL, LOGITS_ATOL, GRADS_ATOL = 1e-5, 5e-5, 2e-4
PREFILL_B, PREFILL_S = 4, 512  # 13f's prefill: two chunks of two rows
Q8_B, Q8_S = 4, 256  # 13g's batch
# full-width decode vs forward at the same positions (the max over logits,
# over max|forward|).  The reference's init draws wq and wk with fan_in =
# heads (24 and 2), so attention scores have std ~400 and the softmax is a
# near-hard max that rounding flips: on these weights (on an H100) the f32
# decode sat 4.3 % of max|logits| from the f32 forward, and the bf16
# forward 24 % from the f32 one.  So in f32 the weights are the same with
# wq and wk scaled by QK_SCALE (scores of std ~2), and decode must equal
# forward within DECODE_F32; in bf16, on the weights as they are, decode
# must stay within DECODE_BF16 x the bf16 forward's distance from the f32
# forward (the model's bf16 noise floor, measured in the same run) plus one
# bf16 step
QK_SCALE, DECODE_F32, DECODE_BF16 = 1 / 16, 1e-3, 2.0


def model_flops(cfg, B, S):
    """Model FLOPs of one train step: 6·P·T for the weights (P =
    params_count()) plus 12·L·H·hd·S·T for the attention scores and values
    (forward and backward, the causal half not subtracted), T = B·S; the
    recomputed forward is not counted."""
    T = B * S
    return 6 * cfg.params_count() * T + 12 * cfg.n_layers * cfg.n_heads * cfg.hd * S * T


def kernel_counts():
    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.kernels.segmin import segmin as kseg

    return {"minplus_call": kmod.minplus_call.launches,
            "minplus_call (lanes)": kmod.minplus_call.lane_launches,
            "minplus_blocked_call": kmod.minplus_blocked_call.launches,
            "minplus_blocked_call (lanes)": kmod.minplus_blocked_call.lane_launches,
            "pack_records": kmod.pack_records.launches,
            "segmin_bucketed_call": kseg.segmin_bucketed_call.launches}


def zero_kernel_counts():
    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.kernels.segmin import segmin as kseg

    kmod.minplus_call.launches = kmod.minplus_call.lane_launches = 0
    kmod.minplus_blocked_call.launches = kmod.minplus_blocked_call.lane_launches = 0
    kmod.pack_records.launches = kseg.segmin_bucketed_call.launches = 0


def rel_err(a, b):
    """max |a - b| over max |b|, both as f32."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def train_step_row(step, params, opt_state, tok, cfg, what):
    """One timed train step: loss, seconds, tokens/s, peak memory, FLOPs share."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    (params, opt_state, loss), s = timed(step, params, opt_state, tok)
    B, S = tok.shape
    row = {"loss": float(loss), "s": s, "tokens_per_s": B * S / s,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "flops_share": model_flops(cfg, B, S) / s / H100_BF16_FLOPS}
    if not math.isfinite(row["loss"]):
        raise AssertionError(f"{what}: loss {row['loss']}")
    log(f"phase 11: {what} ({B}, {S}): loss {row['loss']:.6f}, {s:.3f} s, "
        f"{row['tokens_per_s']:.0f} tokens/s, peak {row['peak_gb']:.2f} GB, model FLOPs "
        f"{row['flops_share']:.4f} of the bf16 peak")
    return row


def full_width_training(dev, cfg, rec):
    """starcoder2-3b at full width and depth: init on the card, three steps
    on one repeated batch (the loss falls at every step), three on the token
    stream, a breakdown of one step (forward, backward with the recomputed
    forward, the update, a profiler pass), one step at (1, LONG_S)."""
    import torch

    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import transformer as tf
    from repro_torch.optim import OptConfig, adamw_init, adamw_update

    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    params, rec["init_s"] = timed(tf.init_params, cfg, gen)
    opt_cfg = OptConfig(lr=1e-3)  # train()'s
    opt_state = adamw_init(params, opt_cfg)
    sync()
    rec["state_gb"] = torch.cuda.memory_allocated() / 1e9
    log(f"phase 11: {cfg.name} at full width: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads ({cfg.n_kv_heads} KV), head_dim {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}, {cfg.dtype}, {cfg.params_count()} params; init {rec['init_s']:.3f}"
        f" s; params + f32 moments {rec['state_gb']:.2f} GB; model FLOPs of a (B, S) step = "
        f"6·P·B·S + 12·L·H·hd·S·B·S (P = params_count(); the attention's causal half not "
        f"subtracted, the recomputed forward not counted), over {H100_BF16_FLOPS:.3g} FLOP/s")
    step = tf.make_train_step(cfg, opt_cfg)
    stream = TokenStream(cfg.vocab, TRAIN_B, TRAIN_S, seed=0)
    tok = torch.from_numpy(stream.batch_at(0)).to(dev)
    # step 0 runs inside 13a, which holds the sharded step against it
    rec["repeated"] = [phase13a_sharded_lm(dev, cfg, params, opt_state, step, tok, opt_cfg,
                                           rec)]
    rec["repeated"] += [train_step_row(step, params, opt_state, tok, cfg,
                                       f"repeated batch, step {i}") for i in (1, 2)]
    losses = [r["loss"] for r in rec["repeated"]]
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"the loss on one repeated batch does not fall: {losses}")
    rec["stream"] = [train_step_row(step, params, opt_state,
                                    torch.from_numpy(stream.batch_at(i)).to(dev), cfg,
                                    f"TokenStream step {i}") for i in range(1, 4)]
    # where a step's time goes: the pieces of train_step, each timed alone
    with torch.no_grad():
        _, fwd_s = timed(tf.loss_fn, cfg, params, tok)
    (_, grads), fb_s = timed(tf.loss_and_grads, cfg, params, tok, stacked=False)
    phase13c_compress(dev, grads, rec)
    _, upd_s = timed(adamw_update, params, grads, opt_state, opt_cfg)
    del grads
    step_s = rec["stream"][-1]["s"]
    prof = device_profile(lambda: step(params, opt_state, tok), step_s)
    rec["breakdown"] = {"forward_s": fwd_s, "forward_recompute_backward_s": fb_s,
                        "backward_est_s": fb_s - 2 * fwd_s, "update_s": upd_s, "step_s": step_s,
                        "device_ms": prof["device_ms"], "busy_share": prof["busy_share"],
                        "top_device_ms": prof["top_device_ms"]}
    log(f"phase 11: one ({TRAIN_B}, {TRAIN_S}) step {step_s:.3f} s: forward alone "
        f"{fwd_s:.3f} s, forward + recomputed forward + backward {fb_s:.3f} s (backward ~"
        f"{fb_s - 2 * fwd_s:.3f} s), AdamW update {upd_s:.3f} s; under the profiler device "
        f"busy {prof['busy_share']:.3f} ({prof['device_ms']:.1f} device ms); top device time "
        f"(ms): {json.dumps(prof['top_device_ms'])}")
    log(f"phase 13a: the sharded step {rec['13a']['s']:.3f} s against phase 11's unsharded "
        f"steps: repeated batch {[round(r['s'], 3) for r in rec['repeated']]} s, TokenStream "
        f"{[round(r['s'], 3) for r in rec['stream']]} s")
    long_tok = torch.from_numpy(TokenStream(cfg.vocab, 1, LONG_S, seed=0).batch_at(0)).to(dev)
    rec["long"] = train_step_row(step, params, opt_state, long_tok, cfg,
                                 f"one step at train_4k's sequence length, {LONG_S // 1024} KV "
                                 f"chunks of 1024 under recompute")
    del opt_state
    rec["tok"] = tok
    return params


def full_width_decode(dev, cfg, params, rec):
    """make_decode_step with a (2, 64) cache over the first 8 tokens of a
    prompt, one at a time, against forward's logits at the same positions:
    in bf16 (the config's dtype) and on f32 copies of the same weights
    (their wq and wk scaled by QK_SCALE)."""
    import dataclasses

    import torch

    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map

    prompt = torch.from_numpy(TokenStream(cfg.vocab, 2, 8, seed=1).batch_at(0)).to(dev)

    def decode(c, p):
        caches = tf.init_caches(c, 2, 64, device=dev)
        step = tf.make_decode_step(c)
        out = []
        for i in range(prompt.shape[1]):
            logits, caches = step(p, caches, prompt[:, i], i)
            out.append(logits)
        return torch.stack(out, 1)

    with torch.no_grad():
        fwd16 = tf.forward(cfg, params, prompt)
    dec16, dec_s = timed(decode, cfg, params)
    phase13f_decode(dev, cfg, params, prompt, dec16, dec_s, rec)
    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    with torch.no_grad():
        fwd32 = tf.forward(c32, p32, prompt)
        for name in ("wq", "wk"):
            p32["dense"]["attn"][name].mul_(QK_SCALE)
        fwd32s = tf.forward(c32, p32, prompt)
    dec32s = decode(c32, p32)
    del p32
    rec["decode"] = {"s": dec_s, "tokens_per_s": prompt.numel() / dec_s,
                     "f32_err": rel_err(dec32s, fwd32s), "bf16_err": rel_err(dec16, fwd16),
                     "bf16_floor": rel_err(fwd16, fwd32),
                     "argmax_agree_bf16": float((dec16.argmax(-1) == fwd16.argmax(-1))
                                                .float().mean())}
    d = rec["decode"]
    log(f"phase 11: decode at full width, (2, 64) cache, 8 tokens one at a time in "
        f"{dec_s:.3f} s; |decode - forward| / max|forward|: f32 (wq, wk x {QK_SCALE}) "
        f"{d['f32_err']:.2e} (at most {DECODE_F32}); bf16 {d['bf16_err']:.4f} against the "
        f"bf16 forward's {d['bf16_floor']:.4f} from the f32 forward (at most {DECODE_BF16}x "
        f"+ 2^-7); bf16 argmax agrees on {d['argmax_agree_bf16']:.3f}")
    if not (d["f32_err"] <= DECODE_F32
            and d["bf16_err"] <= DECODE_BF16 * d["bf16_floor"] + 2.0 ** -7):
        raise AssertionError(f"decode differs from forward: {d}")


def train_crash_resume(dev, preset, rec):
    """train() end to end: 24 steps with a checkpoint every 8, an injected
    failure at step 17 and a relaunch, against an uninterrupted run
    (tests/test_substrate.py's test, at examples/train_lm.py's preset,
    batch, length and lr); checkpoints in a temporary directory."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import TrainConfig, train

    base = dict(steps=24, batch=4, seq_len=128, ckpt_every=8, lr=3e-4, device=str(dev),
                model=preset)
    with tempfile.TemporaryDirectory() as d:
        (_, _, ref), ref_s = timed(train, TrainConfig(ckpt_dir=f"{d}/ref", **base),
                                   log=lambda *_: None)
        try:
            train(TrainConfig(ckpt_dir=f"{d}/crash", failure_at_step=17, **base),
                  log=lambda *_: None)
            raise AssertionError("train() ran past its injected failure")
        except RuntimeError as e:
            if "injected failure at step 17" not in str(e):
                raise
        logs = []
        (_, _, resumed), resume_s = timed(train, TrainConfig(ckpt_dir=f"{d}/crash", **base),
                                          log=logs.append)
        ckpt_bytes = sum(f.stat().st_size for f in Path(d, "ref").rglob("state.npz"))
        n_ckpts = len(CheckpointManager(f"{d}/ref").steps())
        phase13d_elastic_restore(dev, preset, f"{d}/ref", rec)
    rec["train"] = {"params": preset.params_count(), "ref_s": ref_s, "resume_s": resume_s,
                    "losses_ref": ref, "losses_resumed": resumed,
                    "ckpt_gb": ckpt_bytes / n_ckpts / 1e9}
    log(f"phase 11: train() at {preset.name} ({preset.params_count()} params), 24 steps of "
        f"(4, 128): uninterrupted {ref_s:.2f} s, loss {ref[0]:.6f} -> {ref[-1]:.6f}; crashed at "
        f"step 17 and relaunched ({logs[0]!r}) {resume_s:.2f} s, final loss {resumed[-1]:.6f}; "
        f"a checkpoint {rec['train']['ckpt_gb']:.3f} GB")
    if "resumed from checkpoint at step 15" not in logs[0] or len(resumed) != 8:
        raise AssertionError(f"the relaunch did not resume at step 16: {logs[:1]}")
    if not math.isclose(resumed[-1], ref[-1], rel_tol=1e-4):
        raise AssertionError(f"resumed final loss {resumed[-1]} vs {ref[-1]}")


def close(got, want, atol_frac, rtol, what):
    import torch

    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    tol = atol_frac * float(want.abs().max()) + rtol * want.abs()
    if not bool(((got - want).abs() <= tol).all()):
        raise AssertionError(f"{what}: card vs CPU off by {float((got - want).abs().max())}")
    return rel_err(got, want)


def reduced_card_vs_cpu(dev, rec):
    """The five reduced LM configs (f32 variants) on the card against the
    same weights and tokens on the CPU: one train step's loss and gradients,
    two decode steps' logits, and one 8-bit AdamW step's moments."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import transformer as tf
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.tree import tree_leaves, tree_map

    rec["reduced"] = {}
    for arch in ("starcoder2-3b", "qwen1.5-32b", "stablelm-12b", "granite-moe-1b-a400m",
                 "deepseek-v3-671b"):
        cfg = dataclasses.replace(get_arch(arch).reduced, dtype="float32")
        cpu = tf.init_params(cfg, torch.Generator().manual_seed(0))
        card = tree_map(lambda t: t.to(dev, copy=True), cpu)
        tok = torch.from_numpy(TokenStream(cfg.vocab, 4, 32, seed=2).batch_at(0))
        lc, gc = tf.loss_and_grads(cfg, cpu, tok)
        ld, gd = tf.loss_and_grads(cfg, card, tok.to(dev))
        if not math.isclose(float(ld), float(lc), rel_tol=LOSS_RTOL):
            raise AssertionError(f"{arch}: loss {float(ld)} on the card, {float(lc)} on the CPU")
        grad_err = max(close(a, b, GRADS_ATOL, 1e-5, f"{arch} grads")
                       for a, b in zip(tree_leaves(gd), tree_leaves(gc)))
        caches = [tf.init_caches(cfg, 2, 16, device=d) for d in ("cpu", dev)]
        logit_err = 0.0
        for i in range(2):
            t = tok[:2, i].contiguous()
            lc_i, caches[0] = tf.make_decode_step(cfg)(cpu, caches[0], t, i)
            ld_i, caches[1] = tf.make_decode_step(cfg)(card, caches[1], t.to(dev), i)
            logit_err = max(logit_err, close(ld_i, lc_i, LOGITS_ATOL, 1e-5, f"{arch} decode"))
        q8 = OptConfig(lr=1e-3, quantized=True)
        states = [adamw_init(p, q8) for p in (cpu, card)]
        tf.make_train_step(cfg, q8)(cpu, states[0], tok)
        tf.make_train_step(cfg, q8)(card, states[1], tok.to(dev))
        # every m and v as stored (v through its square root): card and CPU
        # within one quantization step of the block (a value on a rounding
        # boundary) plus the gradients' tolerance
        q8_steps = 0.0
        for a, b in zip(tree_leaves(states[1]["mu"]), tree_leaves(states[0]["mu"])):
            step = b.scale[:, None] / 127
            xa = a.q.cpu().float().reshape(-1, 128) * a.scale.cpu()[:, None] / 127
            xb = b.q.float().reshape(-1, 128) * step
            off = (xa - xb).abs() - GRADS_ATOL * float(xb.abs().max())
            q8_steps = max(q8_steps, float((off / step.clamp(min=1e-30)).max()))
        if q8_steps > 1:
            raise AssertionError(f"{arch}: 8-bit moments differ by {q8_steps} steps")
        rec["reduced"][arch] = {"loss": float(lc), "grad_err": grad_err, "logit_err": logit_err,
                                "q8_steps": q8_steps}
        log(f"phase 11: {cfg.name} (f32) card vs CPU: loss {float(ld):.7f} / {float(lc):.7f}, "
            f"grads {grad_err:.2e}, decode logits {logit_err:.2e} of max (atol {GRADS_ATOL} and "
            f"{LOGITS_ATOL} of max, rtol 1e-5); 8-bit AdamW moments within "
            f"{max(q8_steps, 0.0):.3f} of a quantization step")


def phase11_trainer(dev, root):
    """The trainer on the card: the full-width steps, decode, train()'s crash
    and resume at the 100m preset, the reduced configs card vs CPU.  Returns
    the record and the kernel launches counted while it ran (none expected:
    the path reaches no pallas_call in the reference)."""
    import importlib.util

    import torch

    from repro_torch.configs import get_arch

    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", root / "examples" / "torch_train_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cfg = get_arch("starcoder2-3b").model
    rec = {}
    t_phase = time.perf_counter()
    zero_kernel_counts()
    params = full_width_training(dev, cfg, rec)
    phase13f_lm_paths(dev, cfg, params, rec.pop("tok"), rec)
    full_width_decode(dev, cfg, params, rec)
    del params
    torch.cuda.empty_cache()
    train_crash_resume(dev, example.PRESETS["100m"], rec)
    reduced_card_vs_cpu(dev, rec)
    phase13g_q8(dev, rec)
    launches = kernel_counts()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 11: {rec['phase_s']:.1f} s; kernel launches on the trainer path "
        f"{json.dumps(launches)}")
    if any(launches.values()):
        raise AssertionError(f"the trainer path launched {launches}")
    return rec, launches


# ---- phase 12: the GNN family and the MIND recommender (src/repro_torch/models/gnn.py,
# models/recsys.py, data/graphs.py sample_neighbors, data/recsys.py)

GNN_LR, MIND_LR = 1e-3, 1e-2  # tests/test_models_smoke.py's
REDDIT_SCALE, REDDIT_EF = 18, 437  # RMAT at Reddit's size: 2^18 vertices, ~114.6M edges
# card vs CPU of the reduced configs (f32): |card - cpu| <= atol_frac·max|cpu| +
# 1e-5·|cpu| (tests/test_torch_gnn.py's and test_torch_recsys.py's); the card's
# index_add sums a row in atomic order
MODEL_FWD_ATOL, MODEL_GRAD_ATOL = 1e-5, 2e-4
GNN_CELLS = (("graphsage-reddit", "gnn_full"), ("graphsage-reddit", "gnn_sampled"),
             ("gatedgcn", "gnn_full"), ("schnet", "gnn_full"), ("schnet", "gnn_batched"),
             ("graphcast", "gnn_full"))


def gnn_batch(cfg, shape, gen, dev):
    """Inputs of a GNN cell drawn on ``dev`` from ``gen``, at effective_graph's
    (N, E, F): node features, random (E, 2) edges, labels or targets (the
    reference's smoke batches at full size; a molecule batch shares one edge
    template)."""
    import torch

    from repro_torch.models import gnn

    N, E, F = gnn.effective_graph(shape)

    def randn(*s):
        return torch.randn(s, generator=gen, device=dev)

    def randint(hi, *s):
        return torch.randint(0, hi, s, generator=gen, device=dev, dtype=torch.int32)

    if shape.kind == "gnn_sampled":
        B, (f1, f2) = shape.batch_nodes, shape.fanout
        return {"feats": (randn(B, F), randn(B * f1, F), randn(B * f1 * f2, F)),
                "labels": randint(cfg.n_classes, B)}
    if shape.kind == "gnn_batched":
        G, n1, e1 = shape.graph_batch, shape.n_nodes, shape.n_edges
        return {"z": randn(G, n1, F), "pos": randn(G, n1, 3), "edges_t": randint(n1, e1, 2),
                "energy": randn(G)}
    if cfg.kind == "schnet":
        return {"x": randn(N, F), "pos": randn(N, 3), "edges": randint(N, E, 2),
                "energy_sum": torch.ones((), device=dev)}
    if cfg.kind == "graphcast":
        nm = N // 4 + 1
        return {"x": randn(N, F),
                "g2m": torch.stack([randint(N, E), randint(nm, E)], 1),
                "mesh_e": randint(nm, min(E, 8 * nm), 2),
                "m2g": torch.stack([randint(nm, E), randint(N, E)], 1),
                "target": randn(N, cfg.n_vars)}
    batch = {"x": randn(N, F), "edges": randint(N, E, 2), "labels": randint(cfg.n_classes, N)}
    if cfg.kind == "gatedgcn":
        batch["ew"] = torch.rand(E, generator=gen, device=dev)
    return batch


def model_steps(step, params, opt_state, batch, what, n=3):
    """``n`` timed steps on one repeated batch: loss, seconds and peak memory
    (``max_memory_allocated`` after a reset) of each; the loss must fall."""
    import torch

    rows = []
    for i in range(n):
        torch.cuda.reset_peak_memory_stats()
        (params, opt_state, loss), s = timed(step, params, opt_state, batch)
        rows.append({"loss": float(loss), "s": s,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        log(f"phase 12: {what}, step {i}: loss {rows[-1]['loss']:.6f}, {s:.3f} s, peak "
            f"{rows[-1]['peak_gb']:.2f} GB")
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: the loss does not fall over {n} steps: {losses}")
    return rows


def gnn_cell(dev, arch, shape, batch_fn, what, sharded=None):
    """A GNN config at full width (f32, as configured) on one cell: init on
    the card from a seed, three AdamW steps on one batch; with ``sharded``
    (its phase tag, "13b" or "13h"), phase 13b's sharded step against a
    fourth."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import gnn
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.tree import tree_leaves

    cfg = get_arch(arch).model
    gen = torch.Generator(device=dev).manual_seed(0)
    N, E, F = gnn.effective_graph(shape)
    params = gnn.init_params(cfg, F, gen)
    n_params = sum(p.numel() for p in tree_leaves(params))
    batch, data_s = timed(batch_fn, cfg, shape, gen)
    opt = OptConfig(lr=GNN_LR)
    log(f"phase 12: {what}: {cfg.name} ({cfg.n_layers} layers, d {cfg.d_hidden}, "
        f"{n_params} params, {cfg.dtype}) on {shape.name} (N {N}, E {E}, F {F}); inputs on "
        f"the card {data_s:.3f} s")
    step = gnn.make_train_step(cfg, shape, opt, dp_axes=("data",))
    opt_state = adamw_init(params, opt)
    rows = model_steps(step, params, opt_state, batch, what)
    out = {"arch": arch, "shape": shape.name, "N": N, "E": E, "F": F, "params": n_params,
           "data_s": data_s, "steps": rows}
    if sharded:
        from repro_torch.optim.adamw import opt_state_specs

        out[sharded] = phase13b_sharded_vs_plain(
            dev, f"{arch} x {shape.name}", step, params, opt_state, batch,
            lambda m: gnn.param_specs(cfg, F, m),
            lambda m: opt_state_specs(gnn.param_specs(cfg, F, m), opt, m),
            lambda m: gnn.input_specs(cfg, shape, m), GNN_LR, tag=sharded)
    return out


def reddit_graph_job(out_dir):
    """Phase 12a's host graph, built in a worker process while phase 11
    runs on the card: RMAT at Reddit's size and its symmetrized CSR from
    build_csr, saved in ``out_dir`` with the seconds of each."""
    import numpy as np

    from repro_torch.data.graphs import build_csr, rmat_edges

    t0 = time.perf_counter()
    src, dst, _, n = rmat_edges(REDDIT_SCALE, REDDIT_EF, seed=5)
    rmat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    indptr, indices = build_csr(n, src, dst)
    csr_s = time.perf_counter() - t0
    np.save(Path(out_dir, "indptr.npy"), indptr)
    np.save(Path(out_dir, "indices.npy"), indices)
    Path(out_dir, "graph.json").write_text(json.dumps(
        {"n": n, "m": len(src), "rmat_s": rmat_s, "csr_s": csr_s}))


class HostJob:
    """A function run in a spawned process (stopped on exit, finished or
    not), its output in a temporary directory."""

    def __init__(self, fn):
        import multiprocessing
        import tempfile

        self.dir = tempfile.TemporaryDirectory()
        self.proc = multiprocessing.get_context("spawn").Process(target=fn, args=(self.dir.name,))
        self.proc.start()
        self.t0 = time.perf_counter()

    def wait(self):
        """The output directory, once the process has exited 0; and the
        seconds waited here."""
        t0 = time.perf_counter()
        self.proc.join()
        if self.proc.exitcode != 0:
            raise RuntimeError(f"host job exited {self.proc.exitcode}")
        return Path(self.dir.name), time.perf_counter() - t0

    def stop(self):
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join()
        self.dir.cleanup()


def phase12a_sage_sampled(dev, graph_job):
    """graphsage-reddit x minibatch_lg: an RMAT graph at Reddit's size, its
    symmetrized CSR from build_csr (``graph_job``), 1024 batch vertices with
    fanout (15, 10) through sample_neighbors, 602-wide features gathered
    from a table on the card."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.graphs import sample_neighbors

    shape = next(s for s in get_arch("graphsage-reddit").shapes if s.name == "minibatch_lg")
    out, wait_s = graph_job.wait()
    g = json.loads(Path(out, "graph.json").read_text())
    indptr, indices = np.load(Path(out, "indptr.npy")), np.load(Path(out, "indices.npy"))
    n = g["n"]
    log(f"phase 12a: RMAT scale {REDDIT_SCALE}, edge factor {REDDIT_EF}: {n} vertices, "
        f"{g['m']} edges (Reddit: {shape.n_nodes}, {shape.n_edges}) in {g['rmat_s']:.1f} s; "
        f"build_csr {g['csr_s']:.1f} s ({len(indices)} entries, "
        f"{(indptr.nbytes + indices.nbytes) / 1e9:.2f} GB of host CSR), both in a worker "
        f"process started ahead; waited for {wait_s:.1f} s here")
    B, (f1, f2) = shape.batch_nodes, shape.fanout
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    batch_v = rng.choice(n, size=B, replace=False).astype(np.int32)
    hop1 = sample_neighbors(indptr, indices, batch_v, f1, rng).reshape(-1)
    hop2 = sample_neighbors(indptr, indices, hop1, f2, rng).reshape(-1)
    sample_s = time.perf_counter() - t0
    del indptr, indices

    def batch_fn(cfg, shape, gen):
        table = torch.randn((n, shape.d_feat), generator=gen, device=dev)
        labels = torch.randint(0, cfg.n_classes, (n,), generator=gen, device=dev)
        ids = [torch.from_numpy(v).to(dev).long() for v in (batch_v, hop1, hop2)]
        return {"feats": tuple(table.index_select(0, i) for i in ids), "labels": labels[ids[0]]}

    rec = gnn_cell(dev, "graphsage-reddit", shape, batch_fn,
                   f"12a graphsage-reddit x minibatch_lg (fanout ({f1}, {f2}))")
    rec.update(graph_n=n, graph_m=g["m"], rmat_s=g["rmat_s"], csr_s=g["csr_s"],
               wait_s=wait_s, sample_s=sample_s, feat_rows=B * (1 + f1 + f1 * f2))
    log(f"phase 12a: sampling {sample_s:.3f} s on the host ({B} + {len(hop1)} + {len(hop2)} "
        f"= {rec['feat_rows']} feature rows, {rec['feat_rows'] * shape.d_feat * 4 / 1e9:.2f} "
        f"GB)")
    return rec


def phase12_full_graph_sm(dev):
    """gatedgcn and graphcast x full_graph_sm (N 3072, E 10752, F 1433)."""
    from repro_torch.configs import get_arch

    out = {}
    for arch in ("gatedgcn", "graphcast"):
        shape = next(s for s in get_arch(arch).shapes if s.name == "full_graph_sm")
        out[arch] = gnn_cell(dev, arch, shape,
                             lambda c, s, g: gnn_batch(c, s, g, dev), f"12b {arch} x full_graph_sm",
                             sharded="13h" if arch == "graphcast" else None)
    return out


def phase12c_schnet(dev):
    """schnet x molecule: 128 molecules of 30 atoms, one 64-edge template,
    through the batched path (the reference's vmap)."""
    from repro_torch.configs import get_arch

    shape = next(s for s in get_arch("schnet").shapes if s.name == "molecule")
    return gnn_cell(dev, "schnet", shape, lambda c, s, g: gnn_batch(c, s, g, dev),
                    "12c schnet x molecule (G 128, batched)", sharded="13h")


def phase12d_ogb_products(dev):
    """graphsage-reddit x ogb_products on the full graph."""
    from repro_torch.configs import get_arch

    shape = next(s for s in get_arch("graphsage-reddit").shapes if s.name == "ogb_products")
    return gnn_cell(dev, "graphsage-reddit", shape, lambda c, s, g: gnn_batch(c, s, g, dev),
                    "12d graphsage-reddit x ogb_products (full graph)", sharded="13b")


def phase12e_steiner_sampled(dev, h, root, steps=8, n_seeds=12):
    """examples/torch_gnn_steiner_sampling.py's loop at full width on phase
    6's graph: graphsage-reddit (16 input features), 8 steps of 12 random
    seeds, each subgraph from phase 6's prepared mode="pallas" handle (the
    min-plus kernel, launches = rounds); the first tree = steiner_tree's
    (mode "bucket") bit for bit."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.steiner import steiner_tree
    from repro_torch.models import gnn
    from repro_torch.optim import OptConfig

    example = load_example(root, "torch_gnn_steiner_sampling")
    g, n = h.graph, h.graph.n
    one_way = int(torch.isfinite(g.w).sum()) // 2  # from_edges: [src, dst] then padding
    src, dst = g.src[:one_way], g.dst[:one_way]
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randn((n, 16), generator=gen, device=dev)
    labels = (torch.arange(n, device=dev) * 2654435761 % 5).to(torch.int32)
    cfg = get_arch("graphsage-reddit").model
    params = gnn.init_params(cfg, 16, gen)
    outs, peaks, lines = [], [], []

    def solve(seeds):
        out = h.solve(seeds)
        outs.append(out)
        return out.raw

    def on_step(msg):
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()
        lines.append(msg)

    zero_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    records = example.train_on_steiner_subgraphs(
        g, src, dst, n, feats, labels, cfg, params, OptConfig(lr=1e-2),
        np.random.default_rng(0), steps=steps, n_seeds=n_seeds, solve=solve, log=on_step)
    sync()
    loop_s = time.perf_counter() - t0
    launches = kernel_counts()
    rounds = sum(o.telemetry.iterations for o in outs)
    if (launches["minplus_call"], launches["pack_records"]) != (rounds, rounds) or any(
            v for k, v in launches.items() if k not in ("minplus_call", "pack_records")):
        raise AssertionError(f"the Steiner sampler launched {launches} for {rounds} rounds")
    for line, peak, r in zip(lines, peaks, records):
        log(f"phase 12e: {line}; {r['s']:.3f} s, peak {peak:.2f} GB")
    ref = steiner_tree(g, torch.from_numpy(records[0]["seeds"]).to(dev))
    same_fixpoint(outs[0].raw, ref, "the first Steiner subgraph's solve vs steiner_tree (bucket)")
    losses = [r["loss"] for r in records]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"12e: the loss does not fall: {losses}")
    log(f"phase 12e: {steps} steps in {loop_s:.3f} s; {rounds} rounds, minplus_call launches "
        f"{launches['minplus_call']} (= rounds); the first tree = steiner_tree's (bucket) bit "
        f"for bit (state, pair table, MST, tree); loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"loop_s": loop_s, "rounds": rounds, "launches": launches["minplus_call"],
            "steps": [{"V": len(r["verts"]), "E": len(r["edges"]), "D": r["D"],
                       "loss": r["loss"], "s": r["s"], "peak_gb": p}
                      for r, p in zip(records, peaks)]}


def behavior_batch(n_items, hist_len, batch, seed, step):
    """One BehaviorStream batch (a worker process's task)."""
    from repro_torch.data.recsys import BehaviorStream

    return BehaviorStream(n_items, hist_len, batch, seed=seed).batch_at(step)


def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(math.ceil(q / 100 * len(xs))) - 1)]


def phase12f_mind(dev):
    """mind at full width (2^21 items x 64, 4 interests, 3 routing
    iterations, history 50) on its four cells, data from BehaviorStream
    (built in worker processes: a batch is a Python loop over its rows)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import recsys
    from repro_torch.optim import OptConfig, adamw_init

    cfg = get_arch("mind").model
    shapes = {s.name: s for s in get_arch("mind").shapes}
    train_b, bulk_b = shapes["train_batch"].batch, shapes["serve_bulk"].batch
    parts = 4  # serve_bulk's 262,144 rows as four stream batches
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=parts + 1,
                             mp_context=multiprocessing.get_context("spawn")) as ex:
        jobs = [ex.submit(behavior_batch, cfg.n_items, cfg.hist_len, train_b, 0, 0)] + [
            ex.submit(behavior_batch, cfg.n_items, cfg.hist_len, bulk_b // parts, 2, i)
            for i in range(parts)]
        train_np = jobs[0].result()
        bulk_np = [j.result() for j in jobs[1:]]
    data_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)

    def on_card(b):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in b.items()}

    gen = torch.Generator(device=dev).manual_seed(0)
    params = recsys.init_params(cfg, gen)
    rec = {"data_s": data_s}
    log(f"phase 12f: {cfg.name}: {cfg.n_items} items x {cfg.embed_dim}, {cfg.n_interests} "
        f"interests, {cfg.capsule_iters} routing iterations, history {cfg.hist_len}, "
        f"{cfg.dtype}; BehaviorStream batches ({train_b} + {parts} x {bulk_b // parts} rows) "
        f"in {data_s:.1f} s on {parts + 1} worker processes")
    # train_batch: three steps on one batch (the in-batch logits are (B, B) f32)
    opt = OptConfig(lr=MIND_LR)
    step = recsys.make_step(cfg, shapes["train_batch"], opt)
    opt_state, train_batch = adamw_init(params, opt), on_card(train_np)
    rec["train_batch"] = model_steps(step, params, opt_state, train_batch,
                                     f"12f mind x train_batch (B {train_b})")
    from repro_torch.optim.adamw import opt_state_specs

    rec["13b"] = phase13b_sharded_vs_plain(
        dev, f"mind x train_batch (B {train_b})", step, params, opt_state, train_batch,
        lambda m: recsys.param_specs(cfg, m),
        lambda m: opt_state_specs(recsys.param_specs(cfg, m), opt, m),
        lambda m: recsys.input_specs(cfg, shapes["train_batch"], m), MIND_LR)
    del opt_state, train_batch
    # serve_p99: B 512, 256 candidates a request, 120 calls
    serve = recsys.make_step(cfg, shapes["serve_p99"])
    sb = on_card({k: v[:shapes["serve_p99"].batch] for k, v in train_np.items()
                  if k != "target_id"})
    B = shapes["serve_p99"].batch
    sb["cand_ids"] = torch.from_numpy(rng.integers(0, cfg.n_items, (B, 256)).astype(np.int32)
                                      ).to(dev)
    times = [timed(serve, params, sb)[1] for _ in range(121)][1:]
    scores = serve(params, sb)
    rec["serve_p99"] = {"B": B, "calls": len(times), "p50_ms": percentile(times, 50) * 1e3,
                        "p99_ms": percentile(times, 99) * 1e3}
    if tuple(scores.shape) != (B, 256) or not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"serve_p99 scores {tuple(scores.shape)}")
    log(f"phase 12f: mind x serve_p99 (B {B}, 256 candidates): {len(times)} calls, p50 "
        f"{rec['serve_p99']['p50_ms']:.3f} ms, p99 {rec['serve_p99']['p99_ms']:.3f} ms")
    rec["13i_serve_p99"] = phase13i_sharded_serving(dev, cfg, shapes["serve_p99"], serve, params,
                                                    sb, scores, times)
    # serve_bulk: B 262,144 with 256 candidates ((B, 256, 64) f32 gathered)
    bulk = on_card({k: np.concatenate([b[k] for b in bulk_np]) for k in ("hist_ids",
                                                                          "hist_mask")})
    bulk["cand_ids"] = torch.randint(0, cfg.n_items, (bulk_b, 256), generator=gen, device=dev,
                                     dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    scores, s = timed(serve, params, bulk)
    rec["serve_bulk"] = {"B": bulk_b, "s": s, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    scores2, s2 = timed(serve, params, bulk)
    rec["serve_bulk"]["s_warm"] = s2
    if tuple(scores.shape) != (bulk_b, 256) or not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"serve_bulk scores {tuple(scores.shape)}")
    del scores, scores2, bulk
    log(f"phase 12f: mind x serve_bulk (B {bulk_b}, 256 candidates): {s:.3f} s, again "
        f"{s2:.3f} s, peak {rec['serve_bulk']['peak_gb']:.2f} GB")
    # retrieval_cand: one query against 1,000,000 candidates
    n_cand = shapes["retrieval_cand"].n_candidates
    rb = {"hist_ids": sb["hist_ids"][:1], "hist_mask": sb["hist_mask"][:1],
          "cand_ids": torch.randint(0, cfg.n_items, (n_cand,), generator=gen, device=dev,
                                    dtype=torch.int32)}
    retrieve = recsys.make_step(cfg, shapes["retrieval_cand"])
    times = [timed(retrieve, params, rb)[1] for _ in range(11)][1:]
    rs = retrieve(params, rb)
    if tuple(rs.shape) != (n_cand,) or not bool(torch.isfinite(rs).all()):
        raise AssertionError(f"retrieval scores {tuple(rs.shape)}")
    rec["retrieval_cand"] = {"candidates": n_cand, "p50_ms": percentile(times, 50) * 1e3}
    log(f"phase 12f: mind x retrieval_cand ({n_cand} candidates): p50 "
        f"{rec['retrieval_cand']['p50_ms']:.3f} ms over {len(times)} calls")
    rec["13i_retrieval_cand"] = phase13i_sharded_serving(
        dev, cfg, shapes["retrieval_cand"], retrieve, params, rb, rs, times)
    return rec


def phase13i_sharded_serving(dev, cfg, shape, serve, params, batch, want, plain_times):
    """13i: a MIND serving cell through the sharded path on the (1, 1) mesh
    (parameters by ``param_specs``, the batch by ``input_specs``): the
    scores within 1e-5 of max of the plain path's, the same number of
    calls timed, p50 and peak beside the plain path's."""
    import torch

    from repro_torch.distributed.sharding import full
    from repro_torch.models import recsys

    mesh = one_rank_mesh(dev)
    dparams = wrap(params, recsys.param_specs(cfg, mesh))
    ispecs = recsys.input_specs(cfg, shape, mesh)
    dbatch = {k: ispecs[k].sharding.distribute(v) for k, v in batch.items()}
    times = [timed(serve, dparams, dbatch)[1] for _ in range(len(plain_times) + 1)][1:]
    torch.cuda.reset_peak_memory_stats()
    got = full(serve(dparams, dbatch))
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    serve(params, batch)
    peak_u = torch.cuda.max_memory_allocated() / 1e9
    err = rel_err(got, want)
    out = {"calls": len(times), "p50_ms": percentile(times, 50) * 1e3,
           "p50_ms_plain": percentile(plain_times, 50) * 1e3, "max_err": err, "peak_gb": peak,
           "peak_gb_plain": peak_u}
    log(f"phase 13i: mind x {shape.name} through sharded serving on the (1, 1) mesh: scores "
        f"{tuple(got.shape)} within {err:.2e} of max of the plain ones (at most 1e-5); p50 "
        f"{out['p50_ms']:.3f} ms against {out['p50_ms_plain']:.3f} ms plain over "
        f"{len(times)} calls; peak {peak:.3f} GB against {peak_u:.3f} GB")
    if tuple(got.shape) != tuple(want.shape) or not err <= 1e-5:
        raise AssertionError(f"13i {shape.name}: {out}")
    return out


def close_tree(got, want, atol_frac, what, scale=None):
    """Every leaf of two trees within atol_frac of max|want| (of the leaf,
    or of ``scale``) + 1e-5·|want|; the largest error over the scale."""
    from repro_torch.tree import tree_leaves

    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        s = float(b.abs().max()) if scale is None else scale
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        if not bool(((a - b).abs() <= atol_frac * s + 1e-5 * b.abs()).all()):
            raise AssertionError(f"{what}: card vs CPU off by {float((a - b).abs().max())}")
        worst = max(worst, float((a - b).abs().max()) / max(s, 1e-30))
    return worst


def phase12g_reduced(dev):
    """The reduced GNN configs in each shape kind and reduced MIND, card
    against CPU on the same weights and inputs: a train step's loss and
    gradients, the serve and retrieval scores."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.recsys import BehaviorStream
    from repro_torch.models import gnn, recsys
    from repro_torch.tree import tree_map

    rec = {}
    small = dict(name="smoke", n_nodes=24, n_edges=80, d_feat=16, batch_nodes=8,
                 fanout=(3, 2), graph_batch=4)
    for arch, kind in GNN_CELLS:
        cfg = get_arch(arch).reduced
        shape = ShapeSpec(kind=kind, **small)
        gen = torch.Generator().manual_seed(0)
        cpu = gnn.init_params(cfg, 16, gen)
        batch = gnn_batch(cfg, shape, gen, "cpu")
        card = tree_map(lambda t: t.to(dev, copy=True), cpu)
        bcard = {k: tuple(x.to(dev) for x in v) if isinstance(v, tuple) else v.to(dev)
                 for k, v in batch.items()}
        lc, gc_ = gnn.loss_and_grads(cfg, shape, cpu, batch)
        ld, gd = gnn.loss_and_grads(cfg, shape, card, bcard)
        if not math.isclose(float(ld), float(lc), rel_tol=1e-5):
            raise AssertionError(f"{arch} {kind}: loss {float(ld)} on the card, {float(lc)}")
        err = close_tree(gd, gc_, MODEL_GRAD_ATOL, f"{arch} {kind} grads")
        rec[f"{arch} {kind}"] = {"loss": float(lc), "grad_err": err}
        log(f"phase 12g: {cfg.name} x {kind} card vs CPU: loss {float(ld):.7f} / "
            f"{float(lc):.7f}, grads {err:.2e} of max")
    cfg = get_arch("mind").reduced
    cpu = recsys.init_params(cfg, torch.Generator().manual_seed(0))
    card = {k: v.to(dev, copy=True) for k, v in cpu.items()}
    b = {k: torch.from_numpy(v) for k, v in
         BehaviorStream(cfg.n_items, cfg.hist_len, 16, seed=0).batch_at(0).items()}
    bd = {k: v.to(dev) for k, v in b.items()}
    lc, gc_ = recsys.loss_and_grads(cfg, cpu, b)
    ld, gd = recsys.loss_and_grads(cfg, card, bd)
    if not math.isclose(float(ld), float(lc), rel_tol=1e-5):
        raise AssertionError(f"mind: loss {float(ld)} on the card, {float(lc)} on the CPU")
    scale = max(float(g.abs().max()) for g in gc_.values())
    err = close_tree(gd, gc_, MODEL_GRAD_ATOL, "mind grads", scale=scale)
    cand = torch.randint(0, cfg.n_items, (16, 32), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    sc = recsys.serve_scores(cfg, cpu, dict(b, cand_ids=cand))
    sd = recsys.serve_scores(cfg, card, dict(bd, cand_ids=cand.to(dev)))
    serve_err = close_tree(sd, sc, MODEL_FWD_ATOL, "mind serve scores")
    one = {k: v[:1] for k, v in b.items()}
    rc = recsys.retrieval_scores(cfg, cpu, dict(one, cand_ids=cand.reshape(-1)))
    rd = recsys.retrieval_scores(cfg, card, {**{k: v.to(dev) for k, v in one.items()},
                                             "cand_ids": cand.reshape(-1).to(dev)})
    ret_err = close_tree(rd, rc, MODEL_FWD_ATOL, "mind retrieval scores")
    rec["mind"] = {"loss": float(lc), "grad_err": err, "serve_err": serve_err,
                   "retrieval_err": ret_err}
    log(f"phase 12g: {cfg.name} card vs CPU: loss {float(ld):.7f} / {float(lc):.7f}, grads "
        f"{err:.2e} of the largest gradient, serve scores {serve_err:.2e}, retrieval "
        f"{ret_err:.2e} of max (atol {MODEL_GRAD_ATOL} for gradients, {MODEL_FWD_ATOL} for "
        f"scores, rtol 1e-5)")
    return rec


def phase12_models(dev, holder, root, graph_job):
    """Phase 12: every model of the GNN family and MIND at full width, then
    the reduced configs card vs CPU.  Returns the record and the kernel
    launches of the models (none expected: the reference's GNN and MIND
    steps reach no pallas_call) and of the Steiner sampler (= its rounds).
    ``holder`` holds phase 6's handle, freed after 12e; ``graph_job``
    builds 12a's host graph."""
    import torch

    rec = {}
    t_phase = time.perf_counter()
    zero_kernel_counts()
    rec["12a"] = phase12a_sage_sampled(dev, graph_job)
    rec["12b"] = phase12_full_graph_sm(dev)
    rec["12c"] = phase12c_schnet(dev)
    rec["12d"] = phase12d_ogb_products(dev)
    model_launches = kernel_counts()
    rec["12e"] = phase12e_steiner_sampled(dev, holder.pop(), root)
    gc.collect()
    torch.cuda.empty_cache()
    zero_kernel_counts()
    rec["12f"] = phase12f_mind(dev)
    rec["12g"] = phase12g_reduced(dev)
    later = kernel_counts()
    model_launches = {k: v + later[k] for k, v in model_launches.items()}
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 12: {rec['phase_s']:.1f} s; kernel launches on the model paths "
        f"{json.dumps(model_launches)}; the Steiner sampler's minplus_call "
        f"{rec['12e']['launches']}")
    if any(model_launches.values()):
        raise AssertionError(f"the model paths launched {model_launches}")
    return rec, model_launches


# ---- phase 14: the dry-run and the examples, each a process of its own

DRYRUN_CELLS = (("starcoder2-3b", "decode_32k"), ("steiner", "lvj_1k"))
EXAMPLES = ("torch_quickstart.py", "torch_serve_queries.py", "torch_build_store.py",
            "torch_steiner_knowledge_graph.py")
PREDICT_14B = """
import json
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.dryrun import predict_lm_step
cell = ShapeSpec(name="13a", kind="train", seq_len={s}, global_batch={b})
print(json.dumps(predict_lm_step("starcoder2-3b", cell, device="cuda")))
"""


def phase14_start(root, out_dir):
    """Starts 14a's dry-run CLIs, 14b's prediction and 14c's examples, all
    at once (each with the port on its path); returns {name: Popen}."""
    import os

    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(root / "src"), env.get("PYTHONPATH"))
                                        if p)
    cmds = {f"14a {a} x {c}": [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
                               "--shape", c, "--mesh", "both", "--force", "--out", str(out_dir)]
            for a, c in DRYRUN_CELLS}
    cmds["14b prediction"] = [sys.executable, "-c",
                              PREDICT_14B.format(s=TRAIN_S, b=TRAIN_B)]
    cmds.update({f"14c {e}": [sys.executable, str(root / "examples" / e)] for e in EXAMPLES})
    return {k: subprocess.Popen(c, cwd=str(root), env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True) for k, c in cmds.items()}


def phase14_watch(procs, t0, limit_s=600):
    """Starts a thread a process that reads it to its end, so that each
    one's seconds are its own whatever runs beside it; returns a function
    that waits for them all and gives each process's (returncode, stdout,
    stderr tail, seconds since ``t0`` when it ended), raising on a failed
    one after all have ended."""
    from concurrent.futures import ThreadPoolExecutor

    def one(p):
        try:
            stdout, stderr = p.communicate(timeout=limit_s)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, stderr = p.communicate()
        return p.returncode, stdout, stderr[-3000:], time.perf_counter() - t0

    pool = ThreadPoolExecutor(len(procs))
    futures = {k: pool.submit(one, p) for k, p in procs.items()}

    def wait():
        try:
            out = {k: f.result() for k, f in futures.items()}
        finally:
            pool.shutdown()
        bad = {k: v for k, v in out.items() if v[0] != 0}
        if bad:
            raise AssertionError("phase 14: processes failed: " + json.dumps(
                {k: {"rc": v[0], "stdout": v[1][-2000:], "stderr": v[2]}
                 for k, v in bad.items()}))
        return out

    return wait


def phase14b_real_step(dev):
    """14b: phase 13a's cell for real: starcoder2-3b at full width from a
    seeded init, one (8, 64) sharded step on the (1, 1) mesh under
    FlopCounterMode; the parameters' and moments' bytes, the step's
    max_memory_allocated (after a reset, with what earlier phases still
    hold) and its own share above the state held before the step."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import transformer as tf
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.optim.adamw import opt_state_specs
    from repro_torch.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    cfg = get_arch("starcoder2-3b").model
    opt_cfg = OptConfig(lr=1e-3)  # phase 11's
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt_state = adamw_init(params, opt_cfg)
    mesh = one_rank_mesh(dev)
    specs = tf.param_specs(cfg, mesh)
    ospecs = opt_state_specs(specs, opt_cfg, mesh)
    cell = ShapeSpec(name="13a", kind="train", seq_len=TRAIN_S, global_batch=TRAIN_B)
    tok = torch.from_numpy(TokenStream(cfg.vocab, TRAIN_B, TRAIN_S, seed=0).batch_at(0)).to(dev)
    dtok = tf.input_specs(cfg, cell, mesh)["tokens"].sharding.distribute(tok)
    step = tf.make_train_step(cfg, opt_cfg, ("data",), param_shardings=specs)

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor))

    rec = {"params_bytes": nbytes(params), "opt_bytes": nbytes(opt_state), "held_bytes": held}
    sync()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with FlopCounterMode(display=False) as fc:
        _, _, loss = step(wrap(params, specs), wrap(opt_state, ospecs), dtok)
    sync()
    rec.update(flops=fc.get_total_flops(), loss=float(loss),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               state_before_step=before - held)
    del params, opt_state, loss
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase14_dryrun(dev, root, p15=None):
    """Phase 14 (14a, 14b, 14c), with phase 15 run once its processes are
    started (before 14b's step) when ``p15`` holds phase 15's inputs
    (emptied after it); returns phase 14's record and phase 15's (None
    without ``p15``)."""
    import shutil
    import tempfile

    import torch

    out_dir = Path(tempfile.mkdtemp(prefix="dryrun_"))
    rec15 = None
    procs = {}
    try:
        t0 = time.perf_counter()
        procs = phase14_start(root, out_dir)
        wait = phase14_watch(procs, t0)
        if p15:
            rec15 = phase15_analysis(dev, root, p15)
            p15.clear()  # phase 6's host edges
            gc.collect()
            torch.cuda.empty_cache()
        t14b = time.perf_counter()
        real = phase14b_real_step(dev)
        real_s = time.perf_counter() - t14b
        runs = wait()
        records = [json.loads(f.read_text()) for f in sorted(out_dir.glob("*.json"))]
    finally:
        for p in procs.values():  # left running only when a phase failed
            if p.poll() is None:
                p.kill()
        shutil.rmtree(out_dir, ignore_errors=True)
    rec = {"seconds": {k: round(v[3], 1) for k, v in runs.items()}, "14b_real_s": real_s}
    # 14a
    for k, (_, stdout, _, _) in runs.items():
        if k.startswith("14a"):
            for line in stdout.splitlines():
                log(f"phase 14a: {line}")
    if len(records) != 2 * len(DRYRUN_CELLS):
        raise AssertionError(f"14a: {len(records)} dry-run records")
    for r in records:
        if r["status"] != "ok" or r["device"] != "cuda":
            raise AssertionError(f"14a: a dry-run cell failed: {json.dumps(r)[:3000]}")
    rec["14a"] = [{k: r[k] for k in ("arch", "shape", "mesh", "trace_s", "state_bytes",
                                     "peak_bytes", "memory", "roofline", "collective_groups")}
                  | ({"layer_terms": r["layer_terms"]} if "layer_terms" in r else {})
                  for r in records]
    # 14b
    pred = json.loads([ln for ln in runs["14b prediction"][1].splitlines()
                       if ln.startswith("{")][-1])
    step_peak = real["max_memory_allocated"] - real["held_bytes"]
    rec["14b"] = {"predicted": pred, "real": real, "peak_ratio": pred["peak_bytes"] / step_peak}
    log(f"phase 14b: starcoder2-3b at full width, one ({TRAIN_B}, {TRAIN_S}) sharded step on "
        f"the (1, 1) mesh: matmul FLOPs predicted {pred['flops']:.0f} (dry-run, fake CUDA "
        f"tensors, layer-calibrated) against {real['flops']} counted around the real step; "
        f"parameters {pred['params_bytes']} / {real['params_bytes']} bytes, optimizer state "
        f"{pred['opt_bytes']} / {real['opt_bytes']} bytes; peak predicted "
        f"{pred['peak_bytes'] / 1e9:.2f} GB against max_memory_allocated "
        f"{real['max_memory_allocated'] / 1e9:.2f} GB, of which {real['held_bytes'] / 1e9:.2f}"
        f" GB held before the state was made: the step's own {step_peak / 1e9:.2f} GB, ratio "
        f"{rec['14b']['peak_ratio']:.3f} (recorded, not gated); loss {real['loss']:.6f}")
    if (pred["flops"] != real["flops"] or pred["params_bytes"] != real["params_bytes"]
            or pred["opt_bytes"] != real["opt_bytes"]):
        raise AssertionError(f"14b: the prediction differs from the real step: {rec['14b']}")
    # 14c
    for e in EXAMPLES:
        _, stdout, _, s = runs[f"14c {e}"]
        log(f"phase 14c: examples/{e} on {torch.cuda.get_device_name(0)} ({s:.1f} s): "
            + " | ".join(stdout.strip().splitlines()[-3:]))
    rec["14c"] = {e: runs[f"14c {e}"][1] for e in EXAMPLES}
    log(f"phase 14: {json.dumps(rec['seconds'])} s a process; 14b's real step "
        f"{real_s:.1f} s")
    return rec, rec15


# ---- phase 15: the trace-safety analyzer and the runtime sanitizer
# (src/repro_torch/analysis/, src/repro_torch/knobs.py)

SEEDED_RULES = ("SP01", "SP02", "SP03", "NU01", "NU02", "DN01")


def phase15_start(root):
    """Starts the analyzer's host processes at once: the ast gate over
    src/repro_torch against the committed baseline and the six seeded spmd
    programs; returns {name: Popen}."""
    import os

    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(root / "src"), env.get("PYTHONPATH"))
                                        if p)
    cli = [sys.executable, "-m", "repro_torch.analysis"]
    cmds = {"ast": cli + ["ast", "src/repro_torch", "--baseline",
                          "ANALYSIS_BASELINE_TORCH.json", "--strict-expired"]}
    cmds.update({f"seed {r}": cli + ["spmd", "--seed-violation", r] for r in SEEDED_RULES})
    return {k: subprocess.Popen(c, cwd=str(root), env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True) for k, c in cmds.items()}


def sanitized(fn, dev):
    """``fn()`` under ``sanitizer()`` (the card's sync debug mode counted),
    synchronized inside; returns (result, report, seconds)."""
    import torch

    from repro_torch.analysis.sanitize import sanitizer

    t0 = time.perf_counter()
    with sanitizer(device=dev) as rep:
        out = fn()
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
    return out, rep, time.perf_counter() - t0


def _report(rep) -> dict:
    return {"host_reads": rep.host_reads, "dispatch_reads": rep.dispatch_reads,
            "h2d": rep.h2d, "rebuilds": rep.rebuilds, "sync_warnings": rep.sync_warnings,
            "reads_by_kind": dict(sorted(rep.reads_by_kind.items()))}


def phase15_analysis(dev, root, p15):
    """Phase 15: the analyzer's processes, and the sanitizer around phase
    6's warm pallas solve, phase 7's 8-key batch and a scale-16 solve on the
    card and on the CPU.  ``p15`` holds phase 6's host edges, config, seeds
    and answer (D, rounds) and phase 7's 8-key batch and batch config; the
    graph is prepared anew here.  Returns the record."""
    from repro_torch.core.graph import from_edges
    from repro_torch.data.graphs import rmat_edges, select_seeds
    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.solver import SteinerSolver

    t_phase = time.perf_counter()
    procs = phase15_start(root)
    seeds, distinct, bcfg = p15["seeds"], p15["batch"], p15["bcfg"]
    rec = {"launches": {}}
    # scale 16: the same solve's host reads on the card and on the CPU; first,
    # so that the modes' one-off start (paid by a process's first guarded
    # call) falls outside the full-width pair timed below
    src, dst, w, n = rmat_edges(16, 8, max_weight=100, seed=0)
    seeds16 = select_seeds(n, src, dst, 64, strategy="uniform", seed=1000)
    reads16 = {}
    for d in (dev, "cpu"):
        h16 = SteinerSolver(p15["cfg"], device=d).prepare(from_edges(src, dst, w, n, pad_to=8,
                                                                   device=d))
        h16.solve(seeds16)
        o16, r16, rec[f"scale16_{torch_device_type(d)}_s"] = sanitized(
            lambda: h16.solve(seeds16), d)
        reads16[str(torch_device_type(d))] = (_report(r16), o16.total_distance,
                                              o16.telemetry.iterations)
    (card, d_card, it_card), (host, d_host, it_host) = reads16["cuda"], reads16["cpu"]
    rec["scale16"] = {"cuda": card, "cpu": host, "rounds": it_card}
    log(f"phase 15: scale 16 (64 seeds): host reads card {card['host_reads']} = CPU "
        f"{host['host_reads']} {json.dumps(card['reads_by_kind'])} (the CPU's dispatch mode "
        f"alone sees {host['dispatch_reads']}); rounds {it_card} / {it_host}; D {d_card} / "
        f"{d_host}; guarded {rec['scale16_cuda_s']:.3f} s on the card (with the modes' "
        f"start when no earlier phase entered them), {rec['scale16_cpu_s']:.3f} s on the CPU")
    if (card["host_reads"], card["reads_by_kind"], it_card, d_card) != (
            host["host_reads"], host["reads_by_kind"], it_host, d_host) or card["rebuilds"]:
        raise AssertionError(f"phase 15: scale 16 card vs CPU: {rec['scale16']}")
    h, rec["prepare_s"] = timed(lambda: SteinerSolver(p15["cfg"], device=dev).prepare(
        from_edges(*p15["g_host"], pad_to=8, device=dev)))

    def check(what, rep, rounds, launched):
        row = _report(rep)
        rec[what] = row | {"rounds": rounds, "launches": launched}
        log(f"phase 15: {what}: host reads {rep.host_reads} (dispatch mode "
            f"{rep.dispatch_reads}) {json.dumps(row['reads_by_kind'])}, H2D copies {rep.h2d}, "
            f"sync_debug_mode warnings {rep.sync_warnings}, rebuilds {rep.rebuilds}; "
            f"{rounds} rounds, {launched} launches")
        card = str(dev).startswith("cuda")  # a CPU rehearsal launches no kernel
        if rep.rebuilds or card and (rep.dispatch_reads != rep.host_reads or launched != rounds):
            raise AssertionError(f"phase 15: {what}: {rec[what]}")

    # phase 6's warm full-width pallas solve (a cold one first)
    h.solve(seeds)
    plain, rec["plain_single_s"] = timed(lambda: h.solve(seeds))  # beside the guarded one
    if (plain.total_distance, plain.telemetry.iterations) != (p15["D"], p15["rounds"]):
        raise AssertionError(f"phase 15: the graph prepared anew solves to "
                             f"{plain.total_distance} in {plain.telemetry.iterations} rounds, "
                             f"phase 6's {p15['D']} in {p15['rounds']}")
    kmod.minplus_call.launches = 0
    out, rep, rec["single_s"] = sanitized(lambda: h.solve(seeds), dev)
    same_raw(out.raw, plain.raw, "phase 15: the sanitized solve vs the unguarded one")
    rec["launches"]["single"] = kmod.minplus_call.launches
    check("single", rep, out.telemetry.iterations, kmod.minplus_call.launches)
    log(f"phase 15: single: guarded {rec['single_s']:.3f} s, unguarded "
        f"{rec['plain_single_s']:.3f} s just before it, under the same load")
    # phase 7's eight distinct keys through the batch backend (a cold one first)
    hb = SteinerSolver(bcfg, device=dev).prepare(h.graph)
    hb.solve(distinct)
    plain8, rec["plain_batch_s"] = timed(lambda: hb.solve(distinct))
    kmod.minplus_call.lane_launches = 0
    out8, rep8, rec["batch_s"] = sanitized(lambda: hb.solve(distinct), dev)
    same_raw(out8.raw, plain8.raw, "phase 15: the sanitized batch vs the unguarded one")
    rec["launches"]["lanes"] = kmod.minplus_call.lane_launches
    check("batch", rep8, out8.telemetry.iterations, kmod.minplus_call.lane_launches)
    log(f"phase 15: batch: guarded {rec['batch_s']:.3f} s, unguarded "
        f"{rec['plain_batch_s']:.3f} s just before it")
    del h, plain, out, hb, plain8, out8
    # the analyzer's processes
    runs = {}
    for k, p in procs.items():
        try:
            stdout, _ = p.communicate(timeout=max(1.0, 300 - (time.perf_counter() - t_phase)))
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
                q.wait()
            raise AssertionError(f"phase 15: {k} did not end in 300 s")
        runs[k] = (p.returncode, stdout)
    rc, stdout = runs.pop("ast")
    log(f"phase 15: python -m repro_torch.analysis ast src/repro_torch --baseline "
        f"ANALYSIS_BASELINE_TORCH.json: exit {rc}; {stdout.strip().splitlines()[-1]}")
    if rc != 0:
        raise AssertionError(f"phase 15: the ast gate failed:\n{stdout}")
    rec["ast"] = stdout.strip().splitlines()[-1]
    rec["seeds"] = {}
    for rule in SEEDED_RULES:
        rc, stdout = runs[f"seed {rule}"]
        ids = sorted({m for m in SEEDED_RULES if f": {m} [" in stdout})
        rec["seeds"][rule] = {"exit": rc, "rules": ids}
        if rc != 1 or ids != [rule]:
            raise AssertionError(f"phase 15: --seed-violation {rule}: exit {rc}, rules {ids}"
                                 f"\n{stdout}")
    log(f"phase 15: --seed-violation {', '.join(SEEDED_RULES)}: exit 1 each, naming its own "
        "rule only")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 15: {rec['phase_s']:.1f} s")
    return rec


# ---- phase 16: the perf-regression gate (src/repro_torch/obs/regress.py and
# python -m repro_torch.obs bench), after phase 14's processes have ended

GATE_K = 3  # the quick gate's samples a metric (bench --quick's default)
# an injected slowdown wide enough to clear the card's host noise on every
# time-derived metric (raw ratio 0.36 for a latency, 2.78 for a throughput)
GATE_FACTOR_WIDE = 5.0


def bench_process(root, device, workdir, *extra, slowdown=None):
    """``python -m repro_torch.obs bench --quick`` on ``device`` against the
    history and baseline in ``workdir``; returns (exit code, stdout, stderr,
    seconds)."""
    import os

    from repro_torch.obs.regress import INJECT_ENV

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(root / "src"), env.get("PYTHONPATH"))
                                        if p)
    env.pop(INJECT_ENV, None)
    if slowdown is not None:
        env[INJECT_ENV] = str(slowdown)
    cmd = [sys.executable, "-m", "repro_torch.obs", "bench", "--quick", "--device", device,
           "--history", str(workdir / "history.jsonl"),
           "--baseline", str(workdir / "baseline.json"), *extra]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=str(root), env=env, capture_output=True, text=True, timeout=300)
    return p.returncode, p.stdout, p.stderr, time.perf_counter() - t0


def verdict_lines(stdout) -> list:
    """The rows of the gate's rendered verdict table."""
    from repro_torch.obs.regress import METRIC_POLICY

    return [ln for ln in stdout.splitlines() if ln.split()[:1] and ln.split()[0] in METRIC_POLICY]


def verdict_statuses(stdout) -> dict:
    """{metric: status} from the gate's rendered verdict table."""
    return {ln.split()[0]: ln.split()[1] for ln in verdict_lines(stdout)}


def phase16_gate(dev, root):
    """Phase 16: 16a ``bench --quick --update-baseline`` on the card into a
    temporary directory (its medians with the card's name and power limit);
    16b the same under REPRO_BENCH_SLOWDOWN=2.5 against that baseline (exit
    1, steiner_frontier_messages "ok" and equal to the CPU port's count:
    gated; each metric's verdict printed) and under GATE_FACTOR_WIDE (exit 1
    with every time-derived metric "regress": gated); 16c a plain re-run
    against the baseline (its verdicts and exit code printed, not gated);
    then, in this process, ``run_bench(["steiner"], k=GATE_K, quick=True)``
    on the card with the resident kernel's launches counted (= rounds x (1
    cold + k warm) solves of the pallas mode).  Returns the record."""
    import shutil
    import tempfile

    import torch

    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.obs import regress
    from repro_torch.solver import SteinerSolver

    t_phase = time.perf_counter()
    card = torch_device_type(dev) == "cuda"  # a CPU rehearsal launches no kernel
    # the CPU port's count on the pinned graph (gloo on this process's world)
    cpu_msgs = regress.pinned_frontier_messages("cpu")
    rec = {"cpu_frontier_messages": cpu_msgs, "seconds": {}}
    workdir = Path(tempfile.mkdtemp(prefix="bench_gate_"))
    try:
        # 16a
        rc, out, err, rec["seconds"]["16a"] = bench_process(
            root, torch_device_type(dev), workdir, "--update-baseline")
        if rc != 0:
            raise AssertionError(f"16a: bench --update-baseline exit {rc}:\n{out}\n{err}")
        base = json.loads((workdir / "baseline.json").read_text())
        env, metrics = base["env"], base["metrics"]
        rec["16a"] = {"env": env, "metrics": metrics}
        where = f"{env['device']}, {env.get('power_limit', 'power limit not read')}"
        log(f"phase 16a: bench --quick (k={GATE_K}) medians on {where} (the baseline's env; "
            f"{rec['seconds']['16a']:.1f} s): "
            + "; ".join(f"{m} {v['value']:.6g} {v['unit']} (MAD {v['mad']:.3g})"
                        for m, v in metrics.items()))
        if sorted(metrics) != sorted(regress.METRIC_POLICY):
            raise AssertionError(f"16a: the baseline holds {sorted(metrics)}")
        if card and ("power_limit" not in env or env["device"] != torch.cuda.get_device_name(dev)):
            raise AssertionError(f"16a: the baseline's env does not name the card: {env}")
        # 16b: the injected slowdowns against 16a's baseline
        want = {m: "regress" if p["time_derived"] else "ok"
                for m, p in regress.METRIC_POLICY.items()}
        for factor, tag in ((2.5, "16b"), (GATE_FACTOR_WIDE, "16b wide")):
            rc, out, err, rec["seconds"][tag] = bench_process(
                root, torch_device_type(dev), workdir, slowdown=factor)
            status = verdict_statuses(out)
            msgs = {r["metric"]: r["value"] for r in regress.load_history(
                workdir / "history.jsonl") if r["injected"] == factor}["steiner_frontier_messages"]
            rec[tag] = {"factor": factor, "exit": rc, "status": status,
                        "frontier_messages": msgs, "verdicts": verdict_lines(out)}
            log(f"phase {tag}: REPRO_BENCH_SLOWDOWN={factor}: exit {rc} "
                f"({rec['seconds'][tag]:.1f} s); steiner_frontier_messages {msgs:.0f} (CPU port "
                f"{cpu_msgs})")
            for line in rec[tag]["verdicts"]:
                log(f"phase {tag}:   {line}")
            # gated: exit 1 and the work metric at both factors; every time-derived
            # metric "regress" at the wide factor only (PERF.md: the card's host
            # moves these metrics by up to 1.6x from one process to the next, more
            # than the 1.39x margin 2.5x leaves over the 1.8x ratio)
            if (rc != 1 or status.get("steiner_frontier_messages") != "ok" or msgs != cpu_msgs
                    or factor == GATE_FACTOR_WIDE and status != want):
                raise AssertionError(f"{tag}: the injected slowdown {factor}: exit {rc}, "
                                     f"{status}, messages {msgs} vs the CPU's {cpu_msgs}:\n"
                                     f"{out}\n{err}")
        # 16c (not gated)
        rc, out, err, rec["seconds"]["16c"] = bench_process(root, torch_device_type(dev),
                                                            workdir)
        rec["16c"] = {"exit": rc, "verdicts": verdict_lines(out)}
        log(f"phase 16c: a plain re-run against 16a's baseline (recorded, not gated): exit "
            f"{rc} ({rec['seconds']['16c']:.1f} s)")
        for line in rec["16c"]["verdicts"]:
            log(f"phase 16c:   {line}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    # the steiner group in this process, its pallas solves' launches counted
    g, n = regress._rmat_graph(regress.STEINER_SCALE, device="cpu")
    rounds = SteinerSolver(regress.steiner_config("pallas"), device="cpu").prepare(g).solve(
        regress.pinned_seeds(n)).telemetry.iterations
    kmod.minplus_call.launches = 0
    res = {r.metric: r for r in regress.run_bench(["steiner"], k=GATE_K, quick=True,
                                                  device=dev)}
    launched = kmod.minplus_call.launches
    rec["launches"], rec["rounds"] = launched, rounds
    rec["in_process"] = {m: list(r.samples) for m, r in res.items()}
    log(f"phase 16: run_bench(['steiner'], k={GATE_K}, quick=True) in this process: "
        f"{launched} minplus_call launches = {rounds} rounds x {1 + GATE_K} pallas solves; "
        + "; ".join(f"{m} {r.value:.6g} {r.unit}" for m, r in res.items()))
    if res["steiner_frontier_messages"].value != cpu_msgs:
        raise AssertionError(f"phase 16: messages {res['steiner_frontier_messages']} vs the "
                             f"CPU's {cpu_msgs}")
    if launched != (rounds * (1 + GATE_K) if card else 0):
        raise AssertionError(f"phase 16: {launched} launches for {rounds} rounds")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 16: {rec['phase_s']:.1f} s")
    return rec


def torch_device_type(d) -> str:
    import torch

    return torch.device(d).type


def analysis_inputs(dev, scale, n_seeds):
    """Phase 15's inputs made afresh (``--only-analysis``): phase 6's
    configuration on an RMAT of ``scale`` with its answer, and eight
    distinct seed sets of 16 through the batch backend."""
    import numpy as np

    from repro_torch.core.graph import from_edges
    from repro_torch.data.graphs import rmat_edges, select_seeds
    from repro_torch.solver import SolverConfig, SteinerSolver

    g_host = rmat_edges(scale, 8, max_weight=100, seed=0)
    src, dst, _, n = g_host
    seeds = select_seeds(n, src, dst, n_seeds, strategy="uniform", seed=1000)
    cfg = SolverConfig(backend="single", mode="pallas", ell_width=32, max_iters=10_000)
    ref = SteinerSolver(cfg, device=dev).prepare(
        from_edges(*g_host, pad_to=8, device=dev)).solve(seeds)
    batch = np.stack([select_seeds(n, src, dst, 16, strategy="uniform", seed=2000 + i)
                      for i in range(8)]).astype(np.int32)
    return {"g_host": g_host, "cfg": cfg, "seeds": seeds, "batch": batch,
            "bcfg": SolverConfig(backend="batch", mode="pallas", ell_width=32),
            "D": ref.total_distance, "rounds": ref.telemetry.iterations}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=23, help="RMAT scale of phases 6 and 7")
    ap.add_argument("--seeds", type=int, default=1024, help="seeds of phase 6")
    ap.add_argument("--json", default=None, help="also write the record to this file")
    ap.add_argument("--topk-kernel-k", type=int, default=TOPK_KERNEL_K,
                    help="frontier_size of the top-K kernel schedule in phase 9")
    ap.add_argument("--only-models", action="store_true",
                    help="a rehearsal of phase 12: phases 1, 6 and 12 only, no result line")
    ap.add_argument("--trainer", action="store_true",
                    help="with --only-models: phase 11 (and 13a, 13c, 13d inside it) too")
    ap.add_argument("--only-dryrun", action="store_true",
                    help="a rehearsal of phase 14 alone (no kernel build), no result line")
    ap.add_argument("--only-gate", action="store_true",
                    help="a rehearsal of phase 16 alone (phase 1's build, then the gate), "
                    "no result line")
    ap.add_argument("--only-kg", action="store_true",
                    help="a rehearsal of phase 10c: phases 1, 2, 6 and 10c only, no result line")
    ap.add_argument("--only-prim", action="store_true",
                    help="Prim's kernel alone: phases 1, 2's Prim check and Prim's times "
                    "(phase 17), no result line")
    ap.add_argument("--only-analysis", action="store_true",
                    help="a rehearsal of phase 15 on an RMAT of --scale (phases 1 and 15), "
                    "no result line")
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
    if args.only_dryrun:
        log(f"phase 1: {smi}; torch {torch.__version__} (CUDA {torch.version.cuda})")
        rec, _ = phase14_dryrun(dev, root)
        log(f"script {time.perf_counter() - t_start:.1f} s after the imports")
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps({"device": smi, "dryrun": rec}, indent=1))
        return 0
    _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"phase 1: {smi}; torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"kernel build {build_s:.1f} s")
    if args.only_gate:
        gate_rec = phase16_gate(dev, root)
        log(f"script {time.perf_counter() - t_start:.1f} s after the imports")
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps({"device": smi, "gate": gate_rec}, indent=1))
        return 0
    ptxas = ptxas_lines(_build.build_log("minplus")) + ptxas_lines(_build.build_log("mst"),
                                                                    "prim")
    for line in ptxas or ["no nvcc log (the library was built before this run)"]:
        log(f"phase 1: ptxas {line}")

    names = ("minplus_call", "minplus_call (lanes)", "minplus_blocked_call",
             "minplus_blocked_call (lanes)", "segmin_bucketed_call", "prim_call")
    tally = {k: Tally() for k in names}
    if args.only_prim:
        phase2_prim(dev, tally)
        log(f"phase 2: prim_call equals the plain loop in {tally['prim_call'].cases} cases")
        prim_rec = prim_times(dev, tally, sweep=True)
        log(f"script {time.perf_counter() - t_start:.1f} s after the imports")
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps({"device": smi, "ptxas": ptxas,
                                                   "prim": prim_rec}, indent=1))
        return 0
    # ---- phase 2
    t0 = time.perf_counter()
    phase2_kernels(dev, tally)
    phase2_lanes(dev, tally)
    seg_in, seg_launches = phase2_segmin(dev, tally)
    phase2_prim(dev, tally)
    log("phase 2: kernels equal the plain version in "
        + ", ".join(f"{k} {t.cases}" for k, t in tally.items())
        + f" cases ({time.perf_counter() - t0:.1f} s)")
    seconds = {}  # each phase's seconds, for the log

    def done(phase):
        seconds[phase] = round(time.perf_counter() - t_start - sum(seconds.values()), 1)

    done("1-2")
    if args.only_analysis:
        rec15 = phase15_analysis(dev, root, analysis_inputs(dev, args.scale, args.seeds))
        log(f"script {time.perf_counter() - t_start:.1f} s after the imports")
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps({"device": smi, "analysis": rec15}, indent=1))
        return 0
    if args.only_kg:
        rec, h, _, single_in, g_host = phase6_full_width(dev, args.scale, args.seeds, tally)
        done("6")
        kg_rec, _ = phase10c_knowledge_graph(dev, h, single_in, g_host, root)
        done("10c")
        log(f"script {time.perf_counter() - t_start:.1f} s after the imports; by phase "
            f"{json.dumps(seconds)}")
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps({"device": smi, "knowledge_graph": kg_rec},
                                                  indent=1))
        return 0
    if args.only_models:  # phase 6's handle, then phases 11 (with --trainer), 12, 13e
        graph_job = HostJob(reddit_graph_job)
        try:
            _, h, _, _, _ = phase6_full_width(dev, args.scale, args.seeds, tally)
            done("6")
            if args.trainer:
                trainer_rec, _ = phase11_trainer(dev, root)
                done("11")
            models_rec, _ = phase12_models(dev, [h], root, graph_job)
        finally:
            graph_job.stop()
        done("12")
        models_rec["state_per_device"] = phase13e_state_table(dev)
        if args.trainer:
            models_rec["trainer"] = trainer_rec
        done("13e")
        log(f"script {time.perf_counter() - t_start:.1f} s after the imports; by phase "
            f"{json.dumps(seconds)}")
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps({"device": smi, "models": models_rec},
                                                  indent=1))
        return 0
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
    # phase 15 (run inside phase 14) prepares phase 6's graph anew from its
    # host edges: phase 6's handle (10.8 GB) cannot stay on the card through
    # phase 12f (MIND's 66.7 GB peak)
    p15 = {"g_host": g_host, "cfg": h.config, "seeds": single_in[0], "batch": lanes_in[0],
           "bcfg": lanes_in[2], "D": rec["total_distance"], "rounds": rec["iterations"]}
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
    done("10b")
    # ---- phase 10c (the knowledge-graph workflow at full width, one NCCL rank)
    kg_rec, kg_launches = phase10c_knowledge_graph(dev, h, single_in, p15["g_host"], root)
    del single_in
    done("10c")
    times = kernel_times(dev, h.artifact("ell"), st, {"full": hb, "scale16": blocked16},
                         lanes_in, seg_in, tally)
    prim_rec = prim_times(dev, tally)
    times["prim_call"] = dict(prim_rec[1024], by_size=prim_rec)
    done("kernel times")
    log(f"kernel times: {json.dumps(times)}")
    log("tolerance: exact (every output of every kernel equals the plain version's; "
        + ", ".join(f"{k}: {t.cases} cases, {t.mismatches} mismatches"
                    for k, t in tally.items()) + ")")
    # ---- phase 11 (the trainer at full width), with the Steiner phases' state
    # freed but phase 6's handle (phase 12e samples its subgraphs)
    holder = [h]
    del h, st, hb, blocked16, lanes_in, seg_in
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 11: {torch.cuda.memory_allocated() / 1e9:.2f} GB held from earlier phases "
        f"(phase 6's prepared graph)")
    graph_job = HostJob(reddit_graph_job)  # phase 12a's host graph, meanwhile
    try:
        trainer_rec, trainer_launches = phase11_trainer(dev, root)
        done("11")
        # ---- phase 12 (the GNN family and MIND at full width; the Steiner sampler)
        models_rec, model_launches = phase12_models(dev, holder, root, graph_job)
    finally:
        graph_job.stop()
    done("12")
    # ---- phase 13e (13a, 13c, 13d, 13f and 13g ran inside phase 11, 13b, 13h and 13i
    # inside phase 12)
    state_rec = phase13e_state_table(dev)
    done("13e")
    # ---- phase 14 (the dry-run and the examples)
    dryrun_rec, analysis_rec = phase14_dryrun(dev, root, p15)
    done("14-15")
    # ---- phase 16 (the perf-regression gate, after phase 14's processes ended)
    gate_rec = phase16_gate(dev, root)
    done("16")

    # ---- the launches by path and the kernels line
    by_path = {"minplus_call (pallas, phase 6)": rec["launches_per_solve"] * 4,
               "minplus_call (lanes, phase 7)": lane_launches,
               "minplus_blocked_call (pallas, phase 8)": blocked_launches,
               "minplus_blocked_call (lanes, phase 8)": blocked_lane_launches,
               "segmin_bucketed_call (phase 2)": seg_launches,
               **{f"{k[:-1]}, phase 9)": v for k, v in sched_launches.items()},
               **{f"{k[:-1]}, phase 9b)": v for k, v in store_launches.items()},
               "minplus_call (traced pallas, phase 10b)": obs_launches["single"],
               "minplus_call (lanes, traced server, phase 10b)": obs_launches["lanes"],
               "minplus_call (pallas references of the mesh answers, phase 10c)": kg_launches,
               "every kernel (trainer, phase 11)": sum(trainer_launches.values()),
               "every kernel (GNN and MIND models, phase 12)": sum(model_launches.values()),
               "minplus_call (Steiner sampler, phase 12e)": models_rec["12e"]["launches"],
               "minplus_call (sanitized pallas, phase 15)": analysis_rec["launches"]["single"],
               "minplus_call (lanes, sanitized batch, phase 15)":
                   analysis_rec["launches"]["lanes"],
               "minplus_call (perf gate's steiner group, pallas, phase 16)":
                   gate_rec["launches"],
               "prim_call (pallas, phase 6)": rec["prim_launches"]}
    log(f"launches by path: {json.dumps(by_path)}")
    launches = {"minplus_call": rec["launches_per_solve"] * 4
                + sched_launches["minplus_call (pallas_frontier)"]
                + store_launches["minplus_call (pallas from a store)"]
                + store_launches["minplus_call (pallas, compacted and overlay stores)"]
                + obs_launches["single"] + kg_launches + models_rec["12e"]["launches"]
                + analysis_rec["launches"]["single"] + gate_rec["launches"],
                "minplus_call (lanes)": lane_launches
                + store_launches["minplus_call (lanes, store-backed server)"]
                + obs_launches["lanes"] + analysis_rec["launches"]["lanes"],
                "minplus_blocked_call": blocked_launches
                + sched_launches["minplus_blocked_call (pallas_frontier)"],
                "minplus_blocked_call (lanes)": blocked_lane_launches,
                "segmin_bucketed_call": seg_launches,
                "prim_call": rec["prim_launches"]}
    minplus_src = "src/repro_torch/kernels/minplus/csrc/minplus.cu"
    sources = {name: minplus_src for name in names}
    sources["segmin_bucketed_call"] = "src/repro_torch/kernels/segmin/csrc/segmin.cu"
    sources["prim_call"] = "src/repro_torch/kernels/mst/csrc/prim.cu"
    replaces = {"minplus_call": "src/repro/kernels/minplus/minplus.py:77",
                "minplus_call (lanes)": "src/repro/kernels/minplus/minplus.py:77",
                "minplus_blocked_call": "src/repro/kernels/minplus/minplus.py:159",
                "minplus_blocked_call (lanes)": "src/repro/kernels/minplus/minplus.py:159",
                "segmin_bucketed_call": "src/repro/kernels/segmin/segmin.py:66",
                "prim_call": "none (src/repro/core/mst.py:22, prim_dense, is a "
                             "lax.fori_loop: one XLA while loop)"}
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
            "bound_by": "bytes",
            "library_ms": None, "shape": kt["shape"],
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
             "mesh": mesh_rec, "obs": obs_rec, "knowledge_graph": kg_rec,
             "trainer": trainer_rec, "models": models_rec,
             "state_per_device": state_rec, "dryrun": dryrun_rec, "analysis": analysis_rec,
             "gate": gate_rec, "launches_by_path": by_path,
             "kernel_times": times, "kernels": kernels, "seconds": total_s}, indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
