"""``python -m repro_torch.obs``: validate a trace, gate the perf, report a flight.

``validate`` checks that a Chrome trace is schema-clean (monotonic ``ts``,
complete X events or paired B/E, known phases), that a Prometheus dump
parses (``--metrics``), and that named spans are present
(``--require-span``, repeatable)::

    python -m repro_torch.obs validate trace.json --metrics metrics.txt \\
        --require-span ingest:build_store

``bench`` is the continuous perf-regression gate: it runs the pinned
small-scale configurations of :mod:`repro_torch.obs.regress` on ``--device``
(``cuda`` by default; it raises where there is no card), appends env-stamped
rows to ``BENCH_HISTORY_TORCH.jsonl`` and exits 1 when a metric regresses
past its noise-aware threshold against ``BENCH_BASELINES_TORCH.json``
(``--update-baseline`` rewrites the baseline instead of gating; a missing
baseline warns and passes unless ``--strict``)::

    python -m repro_torch.obs bench --quick            # on the card
    python -m repro_torch.obs bench --quick --device cpu --only steiner

``report`` renders a dumped flight recording
(:func:`repro_torch.obs.flight.dump_flight`) as a text or markdown
load-imbalance report, after the exact per-rank/global consistency check.

Exit 0 on success, 1 with a reason on stderr otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import flight, regress
from repro_torch.obs.metrics import parse_prometheus
from repro_torch.obs.trace import validate_chrome_trace


def _cmd_validate(args: argparse.Namespace) -> int:
    try:
        with open(args.trace) as f:
            doc = json.load(f)
        n = validate_chrome_trace(doc)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"trace validation failed: {e}", file=sys.stderr)
        return 1
    print(f"trace ok: {n} events")

    if args.metrics is not None:
        try:
            with open(args.metrics) as f:
                samples = parse_prometheus(f.read())
        except (OSError, ValueError) as e:
            print(f"metrics validation failed: {e}", file=sys.stderr)
            return 1
        if not samples:
            print("metrics validation failed: no samples", file=sys.stderr)
            return 1
        print(f"metrics ok: {len(samples)} samples")

    if args.require_span:
        names = {ev.get("name") for ev in doc.get("traceEvents", doc)}
        missing = [s for s in args.require_span if s not in names]
        if missing:
            print(f"missing required spans: {missing}", file=sys.stderr)
            return 1
        print(f"required spans present: {args.require_span}")
    return 0


def _cmd_bench(args: argparse.Namespace) -> int:
    factor = regress.injection_factor()
    if factor != 1.0:
        print(f"NOTE: {regress.INJECT_ENV}={factor} — injected slowdown")
    k = args.k if args.k is not None else (3 if args.quick else 5)
    try:
        results = regress.run_bench(args.only, k=k, quick=args.quick, device=args.device)
    except KeyError as e:
        print(f"bench failed: {e}", file=sys.stderr)
        return 1
    rows = regress.append_history(
        args.history, results, quick=args.quick, k=k, injected=factor,
        device=args.device,
    )
    print(f"appended {rows} rows to {args.history}")

    if args.update_baseline:
        regress.write_baseline(args.baseline, results, device=args.device)
        print(f"baseline updated: {args.baseline}")
        return 0

    try:
        baselines = regress.load_baseline(args.baseline)
    except FileNotFoundError:
        print(
            f"WARNING: no baseline file at {args.baseline} — "
            "run with --update-baseline to create one",
            file=sys.stderr,
        )
        return 1 if args.strict else 0
    verdicts = regress.compare(
        results, baselines, z=args.z, max_ratio=args.max_ratio
    )
    print(regress.render_verdicts(verdicts))
    bad = [v.metric for v in verdicts if v.status == "regress"]
    missing = [v.metric for v in verdicts if v.status == "missing"]
    if missing:
        print(f"WARNING: no baseline for: {missing}", file=sys.stderr)
        if args.strict:
            return 1
    if bad:
        print(f"PERF REGRESSION: {bad}", file=sys.stderr)
        return 1
    print("perf gate: ok")
    return 0


def _cmd_report(args: argparse.Namespace) -> int:
    try:
        doc = flight.load_flight(args.flight)
        per_rank = doc["per_rank"]
        label = args.label or str(doc.get("label", ""))
        if doc.get("per_round") is not None:
            flight.check_consistency(per_rank, doc["per_round"], label=label)
        report = flight.analyze(per_rank, label=label)
    except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
        print(f"flight report failed: {e}", file=sys.stderr)
        return 1
    print(
        flight.render_report(
            report, fmt="markdown" if args.markdown else "text", top=args.top
        ),
        end="",
    )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = p.add_subparsers(dest="cmd", required=True)

    pv = sub.add_parser("validate", help="validate a Chrome trace (+ metrics)")
    pv.add_argument("trace", help="Chrome trace-event JSON file")
    pv.add_argument("--metrics", help="Prometheus text-exposition file")
    pv.add_argument(
        "--require-span",
        action="append",
        default=None,
        help="span name that must appear in the trace (repeatable)",
    )
    pv.set_defaults(fn=_cmd_validate)

    pb = sub.add_parser("bench", help="run pinned benches + perf-regression gate")
    pb.add_argument(
        "--quick", action="store_true",
        help="CI-sized configurations (smaller k and workloads)",
    )
    pb.add_argument("--k", type=int, default=None, help="samples per metric")
    pb.add_argument(
        "--only", action="append", default=None,
        help="bench group to run: steiner|serve|ingest (repeatable)",
    )
    pb.add_argument("--history", default=regress.DEFAULT_HISTORY)
    pb.add_argument("--baseline", default=regress.DEFAULT_BASELINE)
    pb.add_argument(
        "--update-baseline", action="store_true",
        help="write measurements as the new baseline instead of gating",
    )
    pb.add_argument("--z", type=float, default=regress.DEFAULT_Z, help="MAD multiplier")
    pb.add_argument(
        "--max-ratio", type=float, default=None,
        help="override every metric's policy ratio",
    )
    pb.add_argument(
        "--strict", action="store_true",
        help="missing baselines fail instead of warn",
    )
    pb.add_argument(
        "--device", default="cuda",
        help="where the workloads run (default cuda; cpu runs the plain path)",
    )
    pb.set_defaults(fn=_cmd_bench)

    pr = sub.add_parser("report", help="render a per-rank flight recording")
    pr.add_argument("flight", help="flight JSON (flight.dump_flight)")
    pr.add_argument("--markdown", action="store_true")
    pr.add_argument("--label", default=None)
    pr.add_argument("--top", type=int, default=5, help="stragglers to list")
    pr.set_defaults(fn=_cmd_report)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
