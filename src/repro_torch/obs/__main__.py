"""``python -m repro_torch.obs``: validate a trace, report a flight recording.

``validate`` checks that a Chrome trace is schema-clean (monotonic ``ts``,
complete X events or paired B/E, known phases), that a Prometheus dump
parses (``--metrics``), and that named spans are present
(``--require-span``, repeatable)::

    python -m repro_torch.obs validate trace.json --metrics metrics.txt \\
        --require-span ingest:build_store

``report`` renders a dumped flight recording
(:func:`repro_torch.obs.flight.dump_flight`) as a text or markdown
load-imbalance report, after the exact per-rank/global consistency check.

Exit 0 on success, 1 with a reason on stderr otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import flight
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
