"""Continuous perf-regression gate of the port: pinned benches, history, gates.

Counterpart of ``repro.obs.regress``, name for name, on the port's solver,
server and ingest:

  * :func:`run_bench` executes pinned small-scale configurations of the
    solver (RMAT scale 8, 8 seeds, warm solves of modes "bucket", "frontier"
    and "pallas" and the mesh1d frontier message count), the server (a 24-
    or 60-query Zipf stream) and ``build_store`` (RMAT scale 9 or 11),
    median-of-k per metric, on ``device`` ("cuda" unless the caller asks
    for the CPU; without a card the default raises);
  * every run appends env-stamped rows to an append-only
    ``BENCH_HISTORY_TORCH.jsonl`` (one JSON object per metric per run);
    the stamp names torch's version and, on a card, the card and its power
    limit, so every stored number names the hardware it came from;
  * :func:`compare` gates the measured medians against committed
    per-metric baselines (``BENCH_BASELINES_TORCH.json``) with noise-aware
    thresholds — ``limit = max(value·max_ratio, value + min(z·MAD,
    0.4·value))`` for lower-is-better metrics (mirrored for throughput) —
    MAD widens tight ratios for noisy metrics, the 40% cap keeps a noisy
    baseline from ever hiding a true ≥2× change, and the deterministic work
    metric (frontier message count) trips at 5%;
  * ``python -m repro_torch.obs bench`` wires it to the CLI and exits
    nonzero on regression.

Every timed window ends in a device synchronize, so no queued work falls
outside it; a cold solve (the first call of a handle) stays outside.
Setting ``REPRO_BENCH_SLOWDOWN=<factor>`` scales every time-derived sample
(latencies up, throughputs down), the hook that proves the gate fires on a
≥2× slowdown.

The module imports the standard library only; the solver, server and
store (and torch with them) are imported by the workloads that run them.
Baselines and histories have the reference's format, so either package
reads the other's files.
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import statistics
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

DEFAULT_HISTORY = "BENCH_HISTORY_TORCH.jsonl"
DEFAULT_BASELINE = "BENCH_BASELINES_TORCH.json"
INJECT_ENV = "REPRO_BENCH_SLOWDOWN"

# Per-metric gate policy.  Time-derived metrics get a wide ratio (CI
# runners differ from the baseline machine); deterministic work metrics
# are machine-independent and gate tightly.
METRIC_POLICY: Dict[str, Dict[str, object]] = {
    "steiner_warm_ms_bucket": dict(
        unit="ms", higher_is_better=False, max_ratio=1.8, time_derived=True
    ),
    "steiner_warm_ms_frontier": dict(
        unit="ms", higher_is_better=False, max_ratio=1.8, time_derived=True
    ),
    "steiner_warm_ms_pallas": dict(
        unit="ms", higher_is_better=False, max_ratio=1.8, time_derived=True
    ),
    "steiner_frontier_messages": dict(
        unit="messages", higher_is_better=False, max_ratio=1.05,
        time_derived=False,
    ),
    "serve_qps": dict(
        unit="qps", higher_is_better=True, max_ratio=1.8, time_derived=True
    ),
    "serve_fresh_p50_ms": dict(
        unit="ms", higher_is_better=False, max_ratio=1.8, time_derived=True
    ),
    "ingest_edges_per_s": dict(
        unit="edges/s", higher_is_better=True, max_ratio=1.8,
        time_derived=True,
    ),
}
DEFAULT_Z = 5.0


@dataclasses.dataclass(frozen=True)
class MetricResult:
    """Median-of-k measurement of one pinned benchmark metric."""

    metric: str
    unit: str
    higher_is_better: bool
    samples: Tuple[float, ...]
    time_derived: bool = True

    @property
    def value(self) -> float:
        return float(statistics.median(self.samples))

    @property
    def mad(self) -> float:
        med = statistics.median(self.samples)
        return float(statistics.median(abs(s - med) for s in self.samples))


def _result(metric: str, samples: Sequence[float]) -> MetricResult:
    pol = METRIC_POLICY[metric]
    return MetricResult(
        metric=metric,
        unit=str(pol["unit"]),
        higher_is_better=bool(pol["higher_is_better"]),
        samples=tuple(float(s) for s in samples),
        time_derived=bool(pol["time_derived"]),
    )


# ----------------------------------------------------------------------------
# pinned inputs (built exactly as the reference builds them)
# ----------------------------------------------------------------------------

STEINER_SCALE = 8
STEINER_MODES = ("bucket", "frontier", "pallas")


def _rmat_graph(scale: int, seed: int = 0, *, device="cuda"):
    from repro_torch.core.graph import from_edges
    from repro_torch.data.graphs import rmat_edges

    src, dst, w, n = rmat_edges(scale, 8, max_weight=100, seed=seed)
    return from_edges(src, dst, w, n, pad_to=8, device=device), n


def pinned_seeds(n: int):
    """The solver group's 8 sorted int32 seeds of an ``n``-vertex graph."""
    import numpy as np

    rng = np.random.default_rng(0)
    return np.sort(rng.choice(n, size=8, replace=False)).astype(np.int32)


def steiner_config(mode: str):
    """The single-device config of the warm-solve metric of ``mode``."""
    from repro_torch.solver import SolverConfig

    kw = dict(ell_width=16, frontier_size=256) if mode != "bucket" else {}
    return SolverConfig(backend="single", mode=mode, **kw)


def frontier_messages_config():
    """The mesh1d prioritized schedule whose message count is the
    deterministic work metric."""
    from repro_torch.solver import SolverConfig

    return SolverConfig(
        backend="mesh1d", mode="frontier", mesh_shape=(1, 1),
        ell_width=16, frontier_size=256,
    )


def serve_workload(n: int, num_queries: int):
    """The server group's query pool (8 sorted 6-seed lists) and Zipf(1.1)
    stream of ``num_queries`` pool indices."""
    import numpy as np

    rng = np.random.default_rng(1)
    pool = [
        sorted(rng.choice(n, size=6, replace=False).tolist())
        for _ in range(8)
    ]
    p = 1.0 / np.arange(1, len(pool) + 1) ** 1.1
    stream = rng.choice(len(pool), size=num_queries, p=p / p.sum())
    return pool, stream


def ingest_source(quick: bool):
    """The ingest group's RMAT edge stream."""
    from repro_torch.graphstore.ingest import RmatEdgeSource

    return RmatEdgeSource(scale=9 if quick else 11, edge_factor=8, seed=0)


def _sync(device) -> None:
    """Waits for the device's queued work (a no-op off the card)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def pinned_frontier_messages(device="cuda") -> int:
    """``steiner_frontier_messages`` of the pinned graph and seeds on
    ``device`` (makes a world of one when none exists)."""
    from repro_torch.solver import SteinerSolver

    g, n = _rmat_graph(STEINER_SCALE, device=device)
    res = SteinerSolver(frontier_messages_config(), device=device).prepare(g).solve(
        pinned_seeds(n)
    )
    return int(res.telemetry.messages)


# ----------------------------------------------------------------------------
# pinned benchmark configurations (small-scale perf_* workloads)
# ----------------------------------------------------------------------------


def _bench_steiner(k: int, quick: bool, device) -> List[MetricResult]:
    """perf_steiner pinned rows: warm solve p50 per mode + the
    deterministic mesh-frontier message count."""
    from repro_torch.solver import SteinerSolver

    g, n = _rmat_graph(STEINER_SCALE, device=device)
    seeds = pinned_seeds(n)
    out: List[MetricResult] = []
    for mode in STEINER_MODES:
        h = SteinerSolver(steiner_config(mode), device=device).prepare(g)
        h.solve(seeds)  # cold solve: first-call costs stay outside the window
        _sync(device)
        samples = []
        for _ in range(k):
            t0 = time.perf_counter()
            h.solve(seeds)
            _sync(device)
            samples.append((time.perf_counter() - t0) * 1e3)
        out.append(_result(f"steiner_warm_ms_{mode}", samples))
    # deterministic work metric: message count of the mesh1d prioritized
    # schedule on the pinned graph/seeds (machine-independent)
    out.append(
        _result("steiner_frontier_messages", [float(pinned_frontier_messages(device))])
    )
    return out


def _bench_serve(k: int, quick: bool, device) -> List[MetricResult]:
    """perf_serve pinned row: Zipfian stream QPS + fresh-path p50."""
    from repro_torch.serve import ServeConfig, SteinerServer

    g, n = _rmat_graph(STEINER_SCALE, device=device)
    nq = 24 if quick else 60
    qps_samples, p50_samples = [], []
    for rep in range(k):
        srv = SteinerServer(
            g, ServeConfig(buckets=(8,), max_batch=4, cache_capacity=64),
            device=device,
        )
        srv.warmup()
        pool, stream = serve_workload(n, nq)
        _sync(device)
        t0 = time.perf_counter()
        for i, qi in enumerate(stream):
            srv.submit(pool[qi])
            if (i + 1) % 4 == 0:
                srv.flush()
        srv.flush()
        _sync(device)
        dt = time.perf_counter() - t0
        qps_samples.append(nq / dt)
        st = srv.stats()
        p50_samples.append(float(st["fresh_p50_ms"]))
    return [
        _result("serve_qps", qps_samples),
        _result("serve_fresh_p50_ms", p50_samples),
    ]


def _bench_ingest(k: int, quick: bool, device) -> List[MetricResult]:
    """perf_ingest pinned row: streaming RMAT ingest throughput (build_store
    runs on the host, whatever the device)."""
    import shutil
    import tempfile

    from repro_torch.graphstore.ingest import build_store

    samples = []
    for rep in range(k):
        tmp = tempfile.mkdtemp(prefix="repro_bench_ingest_")
        try:
            _, stats = build_store(ingest_source(quick), Path(tmp) / "bench.gstore")
            samples.append(float(stats.edges_per_sec))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return [_result("ingest_edges_per_s", samples)]


GROUPS: Dict[str, Callable[[int, bool, object], List[MetricResult]]] = {
    "steiner": _bench_steiner,
    "serve": _bench_serve,
    "ingest": _bench_ingest,
}


def injection_factor() -> float:
    """The REPRO_BENCH_SLOWDOWN factor (1.0 = no injection)."""
    f = float(os.environ.get(INJECT_ENV, "1.0"))
    if f <= 0:
        raise ValueError(f"{INJECT_ENV} must be > 0, got {f}")
    return f


def apply_injection(
    results: Sequence[MetricResult], factor: float
) -> List[MetricResult]:
    """Scales time-derived samples by ``factor`` (latency up, throughput
    down) — models a uniform machine slowdown for gate self-tests."""
    if factor == 1.0:
        return list(results)
    out = []
    for r in results:
        if not r.time_derived:
            out.append(r)
            continue
        s = 1.0 / factor if r.higher_is_better else factor
        out.append(
            dataclasses.replace(
                r, samples=tuple(x * s for x in r.samples)
            )
        )
    return out


def run_bench(
    groups: Optional[Sequence[str]] = None,
    *,
    k: int = 5,
    quick: bool = False,
    registry: Optional[Dict[str, Callable]] = None,
    device="cuda",
) -> List[MetricResult]:
    """Runs the pinned configurations on ``device`` (each group is called
    as ``fn(k, quick, device)``); injection is applied centrally.  The
    default device raises where no card is present."""
    from repro_torch.solver.api import resolve_device

    device = resolve_device(device)
    registry = GROUPS if registry is None else registry
    names = list(registry) if groups is None else list(groups)
    results: List[MetricResult] = []
    for name in names:
        if name not in registry:
            raise KeyError(
                f"unknown bench group {name!r} (available: {sorted(registry)})"
            )
        results.extend(registry[name](k, quick, device))
    return apply_injection(results, injection_factor())


# ----------------------------------------------------------------------------
# history (append-only JSONL) + baselines (committed JSON)
# ----------------------------------------------------------------------------


def _card_stamp(index: int) -> Dict[str, str]:
    """The card's name and power limit as nvidia-smi gives them; torch's
    device name alone where nvidia-smi is absent or fails."""
    import torch

    # nvidia-smi's indices ignore CUDA_VISIBLE_DEVICES; its UUIDs do not
    uuid = getattr(torch.cuda.get_device_properties(index), "uuid", None)
    card = f"GPU-{uuid}" if uuid is not None else str(index)
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={card}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        if smi.returncode == 0 and smi.stdout.strip():
            name, _, limit = smi.stdout.strip().splitlines()[0].rpartition(", ")
            return {"device": name, "power_limit": limit}
    except (OSError, subprocess.TimeoutExpired):
        pass
    return {"device": torch.cuda.get_device_name(index)}


def env_stamp(device=None) -> Dict[str, object]:
    """Where a measurement was taken: the host, Python, torch and the
    device (on a card its name and power limit).  ``device=None`` stamps
    the card where one is present, else the CPU."""
    import torch

    stamp: Dict[str, object] = {
        "platform": platform.platform(),
        "machine": platform.machine(),
        "python": platform.python_version(),
        "cpus": os.cpu_count(),
        "torch": torch.__version__,
    }
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        stamp["cuda"] = torch.version.cuda
        stamp.update(_card_stamp(torch.cuda.current_device()
                                 if device.index is None else device.index))
    else:
        stamp["device"] = device.type
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=Path(__file__).resolve().parent,
        )
        if sha.returncode == 0:
            stamp["git"] = sha.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return stamp


def append_history(
    path, results: Sequence[MetricResult], *, quick: bool, k: int,
    injected: float = 1.0, device=None,
) -> int:
    """Appends one env-stamped JSON line per metric; returns rows written."""
    stamp = env_stamp(device)
    ts = time.time()
    with open(path, "a") as f:
        for r in results:
            f.write(json.dumps({
                "ts": ts,
                "metric": r.metric,
                "value": r.value,
                "mad": r.mad,
                "unit": r.unit,
                "higher_is_better": r.higher_is_better,
                "samples": list(r.samples),
                "k": k,
                "quick": quick,
                "injected": injected,
                "env": stamp,
            }) + "\n")
    return len(results)


def load_history(path) -> List[Dict[str, object]]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def write_baseline(path, results: Sequence[MetricResult], *, device=None) -> None:
    """Atomic write of the committed per-metric baseline file."""
    doc = {
        "created": time.time(),
        "env": env_stamp(device),
        "metrics": {
            r.metric: {
                "value": r.value,
                "mad": r.mad,
                "unit": r.unit,
                "higher_is_better": r.higher_is_better,
            }
            for r in results
        },
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def load_baseline(path) -> Dict[str, Dict[str, object]]:
    with open(path) as f:
        doc = json.load(f)
    metrics = doc.get("metrics")
    if not isinstance(metrics, dict):
        raise ValueError(f"{path}: not a baseline file (no 'metrics' map)")
    return metrics


# ----------------------------------------------------------------------------
# the gate
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Verdict:
    metric: str
    status: str  # "ok" | "regress" | "missing"
    value: float
    unit: str
    baseline: Optional[float] = None
    limit: Optional[float] = None
    ratio: Optional[float] = None  # degradation factor vs baseline


def compare(
    results: Sequence[MetricResult],
    baselines: Dict[str, Dict[str, object]],
    *,
    z: float = DEFAULT_Z,
    max_ratio: Optional[float] = None,
) -> List[Verdict]:
    """Noise-aware gate: a lower-is-better metric regresses only when its
    median exceeds BOTH ``baseline·max_ratio`` and ``baseline + slack``
    where ``slack = min(z·MAD, 0.4·baseline)`` (mirrored for
    higher-is-better) — the MAD term widens tight ratios for genuinely
    noisy metrics, while the 40% cap guarantees a recorded-noisy baseline
    can never hide a true ≥2× change behind an unbounded noise band.
    ``max_ratio=None`` uses each metric's METRIC_POLICY ratio.
    """
    verdicts = []
    for r in results:
        b = baselines.get(r.metric)
        if b is None:
            verdicts.append(
                Verdict(r.metric, "missing", r.value, r.unit)
            )
            continue
        bv = float(b["value"])
        slack = min(z * float(b.get("mad", 0.0)), 0.4 * bv)
        ratio_cap = (
            float(METRIC_POLICY.get(r.metric, {}).get("max_ratio", 1.8))
            if max_ratio is None
            else max_ratio
        )
        if r.higher_is_better:
            limit = min(bv / ratio_cap, bv - slack)
            regress = r.value < limit
            ratio = bv / r.value if r.value > 0 else float("inf")
        else:
            limit = max(bv * ratio_cap, bv + slack)
            regress = r.value > limit
            ratio = r.value / bv if bv > 0 else float("inf")
        verdicts.append(Verdict(
            r.metric,
            "regress" if regress else "ok",
            r.value,
            r.unit,
            baseline=bv,
            limit=limit,
            ratio=ratio,
        ))
    return verdicts


def render_verdicts(verdicts: Sequence[Verdict]) -> str:
    lines = [
        f"{'metric':<28} {'status':<8} {'value':>12} {'baseline':>12} "
        f"{'limit':>12} {'x':>6}"
    ]
    for v in verdicts:
        lines.append(
            f"{v.metric:<28} {v.status:<8} {v.value:>12.4g} "
            f"{v.baseline if v.baseline is not None else float('nan'):>12.4g} "
            f"{v.limit if v.limit is not None else float('nan'):>12.4g} "
            f"{v.ratio if v.ratio is not None else float('nan'):>6.2f}"
        )
    return "\n".join(lines)
