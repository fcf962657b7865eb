"""One run of one cell: set-up, the measured window, the comparison with the
reference, and the result's line.

Set-up makes the graph on the device from ``--seed``, hands it to the
program (``from_edges``, which takes host arrays, then ``prepare`` or the
server) and warms every shape the cell's traffic uses.  The window drives
the program with the cell's traffic mix for ``--seconds``; nothing is built
inside it.  Once it has closed the peak memory is read, the program is
freed, and the plain reference works out the sampled answers again.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import time
from datetime import timedelta
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from perfkit import check, graphgen, manifest, systems, traffic
from perfkit.devtrace import Capture, DeviceTrace
from perfkit.ranks import RESULT

TRACE_SECONDS = 5.0  # the traced part of a --trace 1 window: whole queries or batches


@dataclasses.dataclass
class RunRecord:
    """What a run measured; every reader under ``bench/metrics/`` reads it."""

    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    completed: int = 0
    rounds: List[int] = dataclasses.field(default_factory=list)  # a solve's relaxation rounds
    messages: List[int] = dataclasses.field(default_factory=list)  # a mesh solve's messages
    spans: List[dict] = dataclasses.field(default_factory=list)  # the program's spans
    device: Optional[DeviceTrace] = None
    graph_n: int = 0
    graph_edges: int = 0  # directed edges of the graph, padding excluded
    lanes: int = 1  # query lanes of one kernel launch


class TraceWindow:
    """Starts the profiler with the window and stops it at the first
    boundary (a query or a flush returned) after :data:`TRACE_SECONDS`."""

    def __init__(self, capture: Optional[Capture]):
        self.capture = capture
        self.t0 = 0.0

    def begin(self):
        self.t0 = time.perf_counter()
        if self.capture is not None:
            self.capture.start()

    def boundary(self):
        c = self.capture
        if c is not None and c.running and time.perf_counter() - self.t0 >= TRACE_SECONDS:
            c.stop()

    def end(self):
        if self.capture is not None and self.capture.running:
            self.capture.stop()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ----------------------------------------------------------------------------
# the loops
# ----------------------------------------------------------------------------


def closed_loop(system, stream, seconds, keep, rec: RunRecord, tw: TraceWindow, device):
    """One client: the next query goes out when the last returns.  Returns
    {index: (seeds, answer)} of the queries in ``keep`` and of the last."""
    kept = {}
    tw.begin()
    t0 = tw.t0
    deadline = t0 + seconds
    i, last = 0, None
    while True:
        q = next(stream)
        out = system.call(q)
        if system.kind == "solver":
            rec.rounds.append(system.rounds(out))
        if i in keep:
            kept[i] = (q, out)
        last = (q, out)
        i += 1
        tw.boundary()
        if time.perf_counter() >= deadline:
            break
    _sync(device)
    rec.window_s = time.perf_counter() - t0
    tw.end()
    rec.attempted = rec.completed = i
    kept[i - 1] = last
    return kept


def backlog_loop(system, stream, seconds, rec: RunRecord, tw: TraceWindow):
    """Work dispatched ahead: queries are queued by bucket on the client's
    side, and a bucket's full batch of distinct queries goes to the server
    with one ``flush`` as soon as it has one.  Returns the batches in the
    order they came back, each the [(seeds, answer)] of its answered
    requests."""
    batches = []
    tw.begin()
    t0 = tw.t0
    deadline = t0 + seconds
    for batch in traffic.full_batches(stream, system.buckets, system.lanes):
        tickets = [system.submit(q) for q in batch]
        res = system.flush()
        rec.attempted += len(tickets)
        batches.append([(q, res[t]) for t, q in zip(tickets, batch) if t in res])
        tw.boundary()
        if time.perf_counter() >= deadline:
            break
    rec.window_s = time.perf_counter() - t0
    tw.end()
    rec.completed = sum(len(b) for b in batches)
    return batches


# ----------------------------------------------------------------------------
# one run
# ----------------------------------------------------------------------------


def load_cell(man: dict, cell: dict, overrides: Optional[dict] = None):
    """The configuration and traffic mix of ``cell``; ``overrides`` replaces
    entries of either (the tests run the harness on the CPU at small sizes
    with it)."""
    overrides = overrides or {}
    cfg = manifest.config(man, cell["config"])
    spec = manifest.traffic(cell["traffic"])
    for k, v in overrides.get("config", {}).items():
        cfg[k] = {**cfg[k], **v} if isinstance(v, dict) else v
    spec.update(overrides.get("traffic", {}))
    return cfg, spec


def program_graph(cfg: dict, edges: graphgen.Edges, device):
    """The program's graph of ``edges``: ``from_edges`` takes host arrays."""
    from repro_torch.core.graph import from_edges

    return from_edges(edges.src.numpy(), edges.dst.numpy(), edges.w.numpy(), edges.n,
                      pad_to=int(cfg["graph"]["pad_to"]), device=device)


def _served(ans):
    return float(ans.total_distance), int(ans.num_edges)


def run_cell(man: dict, cell: dict, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, overrides: Optional[dict] = None):
    """Runs ``cell`` once.  Returns (result, check lines)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cfg, spec = load_cell(man, cell, overrides)
    on_card = torch.device(device).type == "cuda"
    rec = RunRecord()

    # --- set-up: the graph, the program, the warm-up
    log(f"set-up: imports done at {time.perf_counter() - t_start:.2f} s")
    edges = graphgen.rmat(cfg["graph"], seed, device)
    _sync(device)
    log(f"set-up: graph made at {time.perf_counter() - t_start:.2f} s")
    edges = edges.to("cpu")
    rec.graph_n, rec.graph_edges = edges.n, edges.directed_edges
    log(f"set-up: graph n={edges.n} E={edges.directed_edges} on the host at "
        f"{time.perf_counter() - t_start:.2f} s")
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    graph = program_graph(cfg, edges, device)
    log(f"set-up: from_edges done at {time.perf_counter() - t_start:.2f} s")
    system = systems.build(cfg, graph, device)
    del graph
    log(f"set-up: program prepared at {time.perf_counter() - t_start:.2f} s")
    rec.lanes = system.lanes
    kind = spec["kind"]
    warm_seed = int(traffic.rng_for(seed, traffic.WARMUP).integers(2**62))
    warm_stream = traffic.query_stream(spec, edges.n, warm_seed)
    system.warmup(next(warm_stream))
    capture = None
    if trace:
        from repro_torch import obs

        if on_card:
            Capture.warm()
            capture = Capture()
        obs.enable(trace=True)
    tw = TraceWindow(capture)
    _sync(device)
    log(f"set-up: warmed up at {time.perf_counter() - t_start:.2f} s")

    # --- the window
    chk = spec["check"]
    if kind == "closed":
        stream = traffic.query_stream(spec, edges.n, seed)
        keep = set(check.sample(int(chk["pool"]), int(chk["sample"]),
                                traffic.rng_for(seed, traffic.SAMPLE)))
        rec.setup_s = time.perf_counter() - t_start
        kept = closed_loop(system, stream, seconds, keep, rec, tw, device)
        batches = None
    elif kind == "backlog":
        stream = traffic.query_stream(spec, edges.n, seed)
        rec.setup_s = time.perf_counter() - t_start
        batches = backlog_loop(system, stream, seconds, rec, tw)
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    if trace:
        from repro_torch import obs

        rec.spans = obs.tracer().events()
        obs.disable()
    rec.device = capture.trace if capture is not None else None
    if rec.device is not None:
        log(f"trace: {len(rec.device.events)} device activities in {rec.device.window_s:.3f} s, "
            f"read in {capture.stop_s:.2f} s")
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    # --- the comparison, the program freed first
    if batches is None:
        got = {i: (q, check.solve_answer(out.raw)) for i, (q, out) in kept.items()}
        del kept
    else:
        answers = [a for b in batches for a in b]
        pick = check.batch_sample([[len(q) for q, _ in b] for b in batches], int(chk["sample"]),
                                  traffic.rng_for(seed, traffic.SAMPLE))
        got = {j: (answers[j][0], _served(answers[j][1])) for j in pick}
        del answers, batches
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    log(f"window: {rec.completed} of {rec.attempted} answered in {rec.window_s:.3f} s")
    numbers = compare(cfg, edges, got, device)
    log(f"reference: {len(got)} answers in {time.perf_counter() - t_ref:.2f} s")
    numbers.setdefault("unanswered", rec.attempted - rec.completed)
    ok, lines = check.verdict(numbers, manifest.limits(cfg))
    return result(man, cell, rec, ok, numbers, cfg, peak, trace, device), lines


def run_control(man: dict, cell: dict, seed: int, seconds: float, device="cuda",
                overrides: Optional[dict] = None):
    """The control of ``cell``: the plain reference in bfloat16 put in the
    program's place, on the answers a run compares (a closed mix's sampled
    queries; a backlog's first 32 batches, sampled as a run samples them),
    held to the same limits.  Returns (numbers, correct, check lines)."""
    cfg, spec = load_cell(man, cell, overrides)
    edges = graphgen.rmat(cfg["graph"], seed, device).to("cpu")
    chk = spec["check"]
    rng = traffic.rng_for(seed, traffic.SAMPLE)
    stream = traffic.query_stream(spec, edges.n, seed)
    if spec["kind"] == "closed":
        pool = int(chk["pool"])
        queries = [next(stream) for _ in range(pool + 1)]
        pick = check.sample(pool, int(chk["sample"]), rng) + [pool]
    else:
        serve = cfg["serve"]
        gen = traffic.full_batches(stream, serve["buckets"], int(serve["max_batch"]))
        batches = [next(gen) for _ in range(32)]
        queries = [q for b in batches for q in b]
        pick = check.batch_sample([[len(q) for q in b] for b in batches], int(chk["sample"]), rng)
    got = {j: (queries[j], None) for j in pick}
    numbers = compare(cfg, edges, got, device, control=True)
    numbers["unanswered"] = 0  # the control answers every request
    ok, lines = check.verdict(numbers, manifest.limits(cfg))
    return numbers, ok, lines


def compare(cfg: dict, edges, got: Dict[int, tuple], device, control: bool = False) -> dict:
    """The numbers of the sampled answers against the reference in float32.
    With ``control`` the answers are the reference's own in bfloat16, the
    precision below the configurations' (the control), not the program's."""
    ref_mod = manifest.reference(cfg)
    src, dst, w = edges.symmetric(device)
    parts = []
    for q, ans in got.values():
        solver = cfg["system"] == "solver"
        seeds = np.asarray(q, np.int64) if solver else np.unique(np.asarray(q, np.int64))
        ref = ref_mod.solve(src, dst, w, edges.n, torch.as_tensor(seeds), "float32")
        if control:
            ctl = ref_mod.solve(src, dst, w, edges.n, torch.as_tensor(seeds), "bfloat16")
            ans = ctl if solver else (ctl["total_distance"], ctl["num_edges"])
        parts.append(check.compare_solve(ans, ref) if solver else check.compare_served(ans, ref))
    return check.combine(parts, {"compared": len(parts)})


def result(man, cell, rec: RunRecord, ok, numbers, cfg, peak, trace, device) -> dict:
    on_card = torch.device(device).type == "cuda"
    metrics = {}
    for m in manifest.cell_metrics(man, cell["name"], trace):
        value = manifest.metric_reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(peak),
    }
    out = {"correct": bool(ok), "attempted": rec.attempted,
           "failed": rec.attempted - rec.completed, "metrics": metrics, "device": dev}
    if rec.device is not None:
        dev["busy_s"] = rec.device.busy_s()
        dev["window_s"] = rec.device.window_s
        out["breakdown"] = {"device_ops": rec.device.top_ops(), "idle_gaps": rec.device.idle_gaps()}
    lim = manifest.limits(cfg)
    out["checks"] = {k: {"value": numbers.get(k), "limit": lim[k]} for k in lim}
    return out


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ----------------------------------------------------------------------------
# a cell over ranks (perfkit.ranks launches them)
# ----------------------------------------------------------------------------

WORLD_TIMEOUT_S = 300  # a collective that waits longer raises


def _die_with(launcher: int) -> None:
    """Asks the kernel to kill this rank when its launcher dies
    (``PR_SET_PDEATHSIG``), so that no rank outlives it."""
    import ctypes
    import signal

    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    if os.getppid() != launcher:  # it died before the call
        os._exit(1)


def rank_main(spec: dict, forbidden) -> int:
    """One rank: its card, the world, the SPMD run; rank 0 writes the result
    line to the launcher.  ``forbidden()`` names the JAX modules loaded,
    which end the run with no result."""
    _die_with(int(spec["launcher"]))
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    t_start = float(spec["t_start"])
    say = log if rank == 0 else (lambda *a: None)
    say(f"set-up: rank 0 imported at {time.perf_counter() - t_start:.2f} s")
    on_card = spec["device"] == "cuda"
    if on_card:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < world:
            log(f"no result: {spec['workload']} needs {world} CUDA device(s), "
                f"this machine has {have}")
            return 2
        torch.cuda.set_device(local)  # before anything touches a card
        torch.zeros(1, device="cuda")
        say(f"set-up: rank 0 on its card at {time.perf_counter() - t_start:.2f} s")
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world) if on_card else 1)
    dist.init_process_group("cuda:nccl,cpu:gloo" if on_card else "gloo",
                            init_method=f"tcp://127.0.0.1:{int(spec['port'])}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=WORLD_TIMEOUT_S))
    if spec.get("hook"):
        manifest.load_module(Path(spec["hook"]), "hook").plant(rank)
    man = manifest.load_manifest()
    cell = manifest.workload(man, spec["workload"])
    out = run_rank(man, cell, int(spec["seed"]), float(spec["seconds"]), bool(spec["trace"]),
                   spec["device"], t_start, spec.get("overrides"))
    bad = forbidden()
    if bad:
        log(f"no result: rank {rank} loaded {', '.join(bad)}")
        return 3
    if out is not None:
        res, lines = out
        print(RESULT + json.dumps({"result": res, "lines": lines}), flush=True)
    return 0


def fingerprint(edges: graphgen.Edges) -> torch.Tensor:
    """(4,) int64 sums of the edges, position-weighted, on the host: equal
    on two ranks only where they made the same graph."""
    i = torch.arange(edges.src.shape[0], device=edges.src.device, dtype=torch.int64)
    s, d, w = edges.src.long(), edges.dst.long(), edges.w.long()
    mix = (s * 0x9E3779B1) ^ (d * 0x85EBCA77) ^ (w << 40)
    return torch.stack([(mix * (2 * i + 1)).sum(), s.sum(), d.sum(), w.sum()]).cpu()


def same_graph(edges: graphgen.Edges) -> None:
    """Raises unless every rank made the graph that rank 0 made."""
    mine = fingerprint(edges)
    every = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    differ = [r for r, f in enumerate(every) if not torch.equal(f, every[0])]
    if differ:
        raise RuntimeError(f"ranks {differ} made another graph than rank 0 from the same seed")


def _broadcast(flag: torch.Tensor) -> None:
    dist.broadcast(flag, src=0)  # a host tensor: gloo


def lockstep_loop(system, stream, seconds, keep, rec: RunRecord, tw: TraceWindow, device,
                  rank: int):
    """The closed loop of every rank: the same queries, one at a time.
    After each, rank 0 decides whether the window goes on and whether the
    traced part ends, and broadcasts both.  Returns rank 0's {index:
    (seeds, answer)} of the queries in ``keep`` and of the last."""
    kept = {}
    flag = torch.zeros(2, dtype=torch.int32)
    decide_s = 0.0
    tw.begin()
    t0 = tw.t0
    deadline = t0 + seconds
    i, last = 0, None
    while True:
        q = next(stream)
        out = system.call(q)
        rec.rounds.append(system.rounds(out))
        rec.messages.append(system.messages(out))
        if rank == 0:
            if i in keep:
                kept[i] = (q, out)
            last = (q, out)
        i += 1
        t = time.perf_counter()
        if rank == 0:
            flag[0] = int(t < deadline)
            flag[1] = int(t - t0 >= TRACE_SECONDS)
        _broadcast(flag)
        decide_s += time.perf_counter() - t
        if flag[1] and tw.capture is not None and tw.capture.running:
            tw.capture.stop()
        if not flag[0]:
            break
    _sync(device)
    rec.window_s = time.perf_counter() - t0
    tw.end()
    rec.attempted = rec.completed = i
    if rank == 0:
        kept[i - 1] = last
        log(f"lockstep: {i} decisions broadcast in {decide_s * 1e3:.1f} ms")
    return kept


def _max(value: float, dtype) -> float:
    t = torch.tensor([value], dtype=dtype)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.item()


def _mean(value: float) -> float:
    t = torch.tensor([value], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.item() / dist.get_world_size()


def run_rank(man: dict, cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides: Optional[dict] = None):
    """This rank's part of one run of ``cell``.  Returns rank 0's (result,
    check lines); None on the other ranks."""
    rank = dist.get_rank()
    say = log if rank == 0 else (lambda *a: None)
    cfg, spec = load_cell(man, cell, overrides)
    on_card = torch.device(device).type == "cuda"
    rec = RunRecord()

    # --- set-up: the graph on every card, the program, the warm-up
    say(f"set-up: {dist.get_world_size()} ranks joined at {time.perf_counter() - t_start:.2f} s")
    edges = graphgen.rmat(cfg["graph"], seed, device)
    same_graph(edges)
    edges = edges.to("cpu")
    rec.graph_n, rec.graph_edges = edges.n, edges.directed_edges
    say(f"set-up: graph n={edges.n} E={edges.directed_edges} made and agreed at "
        f"{time.perf_counter() - t_start:.2f} s")
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    # a host graph, as the port's knowledge-graph example gives it: prepare
    # partitions it on the host and keeps this rank's shard on its card
    graph = program_graph(cfg, edges, "cpu")
    system = systems.build(cfg, graph, device)
    del graph
    say(f"set-up: program prepared at {time.perf_counter() - t_start:.2f} s")
    warm_seed = int(traffic.rng_for(seed, traffic.WARMUP).integers(2**62))
    t_warm = time.perf_counter()
    system.warmup(next(traffic.query_stream(spec, edges.n, warm_seed)))
    say(f"set-up: the warm-up query took {time.perf_counter() - t_warm:.2f} s")
    capture = None
    if trace:
        from repro_torch import obs

        if on_card:
            Capture.warm()
            capture = Capture()
        if rank == 0:
            obs.enable(trace=True)
    tw = TraceWindow(capture)
    _sync(device)
    chk = spec["check"]
    if spec["kind"] != "closed":
        raise ValueError(f"a cell over ranks runs a closed mix, not {spec['kind']!r}")
    stream = traffic.query_stream(spec, edges.n, seed)
    keep = set(check.sample(int(chk["pool"]), int(chk["sample"]),
                            traffic.rng_for(seed, traffic.SAMPLE)))
    _broadcast(torch.zeros(2, dtype=torch.int32))  # every rank warm: the window opens
    rec.setup_s = time.perf_counter() - t_start
    say(f"set-up: warmed up at {rec.setup_s:.2f} s")

    # --- the window
    kept = lockstep_loop(system, stream, seconds, keep, rec, tw, device, rank)
    if trace and rank == 0:
        from repro_torch import obs

        rec.spans = obs.tracer().events()
        obs.disable()
    rec.device = capture.trace if capture is not None else None
    busy = _mean(rec.device.busy_s()) if rec.device is not None else None
    if rec.device is not None:
        say(f"trace: {len(rec.device.events)} device activities in {rec.device.window_s:.3f} s, "
            f"read in {capture.stop_s:.2f} s; busy {busy:.3f} s, the mean of the ranks")
    peak = int(_max(torch.cuda.max_memory_allocated() if on_card else 0, torch.int64))

    # --- every rank frees its program; rank 0 compares
    got = {i: (q, check.solve_answer(out.raw)) for i, (q, out) in kept.items()}
    del kept, system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    if rank != 0:
        return None
    t_ref = time.perf_counter()
    say(f"window: {rec.completed} queries in {rec.window_s:.3f} s on every rank")
    numbers = compare(cfg, edges, got, device)
    say(f"reference: {len(got)} answers in {time.perf_counter() - t_ref:.2f} s")
    numbers.setdefault("unanswered", rec.attempted - rec.completed)
    ok, lines = check.verdict(numbers, manifest.limits(cfg))
    out = result(man, cell, rec, ok, numbers, cfg, peak, trace, device)
    if busy is not None:
        out["device"]["busy_s"] = busy
    return out, lines
