#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # full width: RMAT scale 23, 1024 seeds
    python3 chip_smoke.py --scale 18 # a shorter rehearsal of phase 5

Phases (any failure raises and the script exits non-zero, printing no
result):

1. device and build: the card's name and power limit, torch's version, and
   the seconds nvcc took to build every kernel source of the package;
2. both min-plus kernels against their plain PyTorch version on the card,
   exact on all three outputs: the sweep shapes of tests/test_kernels.py
   in f32 and bf16, all-padding rows, a ragged R, K in {4, 8, 16, 32, 48},
   and source blocks that do not divide N;
3. the fixed answers of the RMAT scale-10 workload (547.0 / 44 edges /
   10 rounds / 2638 relaxations / 45912 messages) through
   SteinerSolver(SolverConfig(backend="single", mode="pallas")) on the card,
   resident and with src_block=256;
4. RMAT scale 16, 64 seeds: the solve on the card (kernels) against the same
   solve on the CPU (plain path), bit for bit on the Voronoi state, the pair
   tables, the MST, the tree, the counters and the per-round telemetry,
   resident and with src_block=4096 (the blocked kernel's path);
5. full width, the repo's lvj_1k cell cut to RMAT: prepare, one cold and 3
   warm solves with their times and a stage breakdown; launches equal to
   the rounds; the kernel equal to the plain version at the converged state;
   one more relaxation of the fixpoint improves nothing;
6. one JSON line with each kernel's launches on its main path, its error
   against the plain version, and its time beside its bound and the plain
   version's time;
7. last line: {"ok": true, "device": {...}}.

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


def seeds_dev(seeds, dev):
    import torch

    return torch.as_tensor(seeds, dtype=torch.int32, device=dev)


def bound_ms(R, K, N, dist_bytes=4, wgt_bytes=4):
    """Least time of one relaxation: each input read once, each output
    written once, over the device memory rate (the operations, ~2 a lane,
    are far below the card's rate)."""
    nbytes = R * K * (4 + wgt_bytes) + N * (dist_bytes + 4) + R * 12
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase5_full_width(dev, scale, n_seeds, tally):
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
    log(f"phase 5: n={n} E={h.graph.num_edges} ELL=({R}, {K}) host RMAT "
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
    log(f"phase 5: D={first.total_distance} edges={first.num_edges} rounds={t.iterations} "
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
    log("phase 5: stages voronoi {t_voronoi_s:.3f} s, distance graph "
        "{t_distance_graph_s:.3f} s, prim {t_prim_s:.3f} s, tree {t_tree_s:.3f} s; "
        "peak {peak_mem_gb:.1f} GB".format(**rec))

    rec.update(device_profile(lambda: h.solve(seeds), min(rec["warm_solve_s"])))
    log("phase 5: device busy {busy_share:.3f} of a warm solve; top device time (ms): "
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
    return rec, ell, st


def kernel_times(dev, ell, st, blocked_in, tally):
    """ms of each kernel and of the plain version at its main-path shape
    (the blocked kernel's is also held against the plain version here)."""
    from repro_torch.kernels.minplus import minplus as kmod
    from repro_torch.kernels.minplus.ops import INF, IMAX as IM, _pad_rows
    from repro_torch.kernels.minplus.ref import minplus_torch

    R, K = ell.nbr.shape
    N = st.dist.shape[0]
    args = (ell.nbr, ell.wgt, st.dist, st.lab)
    res = {"minplus_call": dict(
        shape=[R, K, N], ms=event_ms(lambda: kmod.minplus_call(*args), 20),
        plain_ms=event_ms(lambda: minplus_torch(*args), 3), bound_ms=bound_ms(R, K, N))}
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
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=23, help="RMAT scale of phase 5")
    ap.add_argument("--seeds", type=int, default=1024, help="seeds of phase 5")
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
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"phase 1: {smi}; torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"kernel build {build_s:.1f} s")

    tally = {"minplus_call": Tally(), "minplus_blocked_call": Tally()}
    # ---- phase 2
    t0 = time.perf_counter()
    phase2_kernels(dev, tally)
    log(f"phase 2: kernels equal the plain version in "
        f"{tally['minplus_call'].cases} + {tally['minplus_blocked_call'].cases} cases "
        f"({time.perf_counter() - t0:.1f} s)")
    # ---- phase 3
    phase3_fixed_answers(dev)
    # ---- phase 4 (the blocked kernel's main path)
    counters = {}
    blocked_in = phase4_card_vs_cpu(dev, counters)
    if counters[None][0] == 0 or counters[None][1] != 0:
        raise AssertionError(f"resident solve launched {counters[None]}")
    if counters[4096][1] == 0 or counters[4096][0] != 0:
        raise AssertionError(f"blocked solve launched {counters[4096]}")
    # ---- phase 5 (the resident kernel's main path, full width)
    rec, ell, st = phase5_full_width(dev, args.scale, args.seeds, tally)
    times = kernel_times(dev, ell, st, blocked_in, tally)
    log(f"kernel times: {json.dumps(times)}")
    log("tolerance: exact (every output of every kernel equals the plain version's; "
        + ", ".join(f"{k}: {t.cases} cases, {t.mismatches} mismatches"
                    for k, t in tally.items()) + ")")

    # ---- phase 6
    launches = {"minplus_call": rec["launches_per_solve"] * 4,
                "minplus_blocked_call": counters[4096][1]}
    replaces = {"minplus_call": "src/repro/kernels/minplus/minplus.py:77",
                "minplus_blocked_call": "src/repro/kernels/minplus/minplus.py:159"}
    kernels = []
    for name in ("minplus_call", "minplus_blocked_call"):
        kt = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/minplus/csrc/minplus.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": tally[name].max_abs_err, "mismatches": tally[name].mismatches,
            "ms": kt["ms"], "plain_ms": kt["plain_ms"], "bound_ms": kt["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "shape": kt["shape"],
        })
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"device": smi, "torch": torch.__version__, "build_s": build_s,
             "full_width": rec, "kernel_times": times, "kernels": kernels}, indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    # ---- phase 7
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
