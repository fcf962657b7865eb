"""CLI: ``python -m repro_torch.analysis <ast|spmd> [options]``.

The counterpart of ``python -m repro.analysis``: two analyzer layers share
one ruff-style interface and one sectioned baseline file
(``ANALYSIS_BASELINE_TORCH.json`` at the repo root):

  ast   source-level trace-safety rules (TS01–TS07, SUP01): fast, no torch
        import, runs on file paths.
  spmd  recorded-op rules (SP01–SP03, NU01–NU02, DN01): records the aten
        ops of a tiny solve of every backend x mode combo (the mesh ones on
        4 gloo ranks) and analyzes the recordings.

The bare form ``python -m repro_torch.analysis src/repro_torch …`` means
``ast``.  Each subcommand gates only its OWN section of the baseline: an
ast run can never expire spmd debt or vice versa.

Exit codes:
  0  no findings outside the baseline
  1  new findings (or, with ``--strict-expired``, expired baseline debt)
  2  usage error

Typical runs::

    python -m repro_torch.analysis ast src/repro_torch --baseline ANALYSIS_BASELINE_TORCH.json
    python -m repro_torch.analysis spmd --baseline ANALYSIS_BASELINE_TORCH.json
    python -m repro_torch.analysis spmd --combo mesh1d/dense
    python -m repro_torch.analysis spmd --seed-violation SP01   # expects exit 1
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis.findings import Finding

_SUBCOMMANDS = ("ast", "spmd")


def _add_common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument(
        "--baseline", metavar="FILE",
        help="committed findings baseline; only NEW findings fail the run",
    )
    ap.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite this subcommand's baseline section from the current "
        "findings and exit 0 (other sections are preserved verbatim)",
    )
    ap.add_argument(
        "--strict-expired", action="store_true",
        help="also exit 1 when baseline entries no longer match (fixed debt "
        "must be removed from the baseline)",
    )
    ap.add_argument(
        "--json", metavar="FILE", dest="json_out",
        help="also write the run's findings as JSON (CI failure artifact)",
    )
    ap.add_argument(
        "--quiet", action="store_true", help="suppress the summary line"
    )


def _json_payload(
    section: str, new: List[Finding], suppressed_n: int, expired: List[dict]
) -> str:
    return json.dumps(
        {
            "section": section,
            "new": [
                {
                    "rule": f.rule, "path": f.path, "line": f.line,
                    "col": f.col, "message": f.message, "context": f.context,
                }
                for f in new
            ],
            "suppressed": suppressed_n,
            "expired": expired,
        },
        indent=2,
    ) + "\n"


def _gate(findings: List[Finding], section: str, args) -> int:
    """Shared report-vs-baseline tail of both subcommands."""
    suppressed_n = 0
    expired: List[dict] = []

    if args.baseline and args.update_baseline:
        try:
            with open(args.baseline, "r", encoding="utf-8") as fh:
                sections: Dict[str, list] = baseline_mod.load_sections(fh.read())
        except FileNotFoundError:
            sections = {}
        sections[section] = findings
        with open(args.baseline, "w", encoding="utf-8") as fh:
            fh.write(baseline_mod.dump_sections(sections))
        if not args.quiet:
            print(
                f"baseline updated: {len(findings)} finding(s) pinned in "
                f"section {section!r} of {args.baseline}"
            )
        return 0

    if args.baseline:
        try:
            with open(args.baseline, "r", encoding="utf-8") as fh:
                entries = baseline_mod.load_sections(fh.read()).get(section, [])
        except FileNotFoundError:
            print(f"baseline file not found: {args.baseline}", file=sys.stderr)
            return 2
        new, suppressed, expired = baseline_mod.split(findings, entries)
        suppressed_n = len(suppressed)
        findings = new

    for f in findings:
        print(f.render())
    for e in expired:
        print(
            f"{e.get('path', '?')}: expired baseline entry "
            f"[{e.get('rule', '?')} in {e.get('context', '?')}] — fixed? "
            f"run --update-baseline to retire it"
        )
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as fh:
            fh.write(_json_payload(section, findings, suppressed_n, expired))

    if not args.quiet:
        bits = [f"{len(findings)} new finding(s)"]
        if args.baseline:
            bits.append(f"{suppressed_n} baselined")
            bits.append(f"{len(expired)} expired")
        print(f"jitlint[{section}]: " + ", ".join(bits))

    if findings:
        return 1
    if expired and args.strict_expired:
        return 1
    return 0


# ---------------------------------------------------------------------------
# ast subcommand (the legacy default)
# ---------------------------------------------------------------------------


def _main_ast(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis ast",
        description="jitlint: source-level trace-safety rules (TS01–TS07)",
    )
    ap.add_argument(
        "paths", nargs="*", default=["src/repro_torch"],
        help="files or directories to analyze (default: src/repro_torch)",
    )
    ap.add_argument(
        "--regions", action="store_true",
        help="dump the inferred sync-free regions (functions + why) "
        "instead of running rules",
    )
    _add_common(ap)
    args = ap.parse_args(argv)

    if args.update_baseline and not args.baseline:
        ap.error("--update-baseline requires --baseline FILE")

    if args.regions:
        from repro_torch.analysis import Project

        project = Project.load(args.paths)
        for fn in sorted(
            project.traced_functions(), key=lambda f: (f.module.path, f.qualname)
        ):
            statics = sorted(p for p, s in fn.param_static.items() if s)
            tag = " [root]" if fn.is_root else ""
            extra = f" static={statics}" if statics else ""
            print(
                f"{fn.module.path}:{fn.node.lineno}: {fn.display()}{tag} "
                f"({fn.trace_reason}){extra}"
            )
        return 0

    from repro_torch.analysis import analyze_paths

    return _gate(analyze_paths(args.paths), "ast", args)


# ---------------------------------------------------------------------------
# spmd subcommand
# ---------------------------------------------------------------------------


def _parse_combo(spec: Optional[str]):
    if spec is None:
        return None
    parts = spec.split("/")
    if len(parts) != 2 or not all(parts):
        raise SystemExit(f"--combo expects backend/mode, got {spec!r}")
    return parts[0], parts[1]


def _main_spmd(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis spmd",
        description="jitlint: recorded-op SPMD/numeric/ownership rules "
        "(SP01–SP03, NU01–NU02, DN01) over tiny solves of every combo",
    )
    ap.add_argument(
        "--combo", metavar="BACKEND/MODE",
        help="restrict to one registered combo (e.g. mesh1d/dense); "
        "default: every combo in the registry",
    )
    ap.add_argument(
        "--list-combos", action="store_true",
        help="print the registered backend/mode combos and exit",
    )
    ap.add_argument(
        "--seed-violation", metavar="RULE",
        help="analyze the seeded-broken program for RULE instead of the "
        "real solves; exits 1 iff the rule fires (CI self-test)",
    )
    _add_common(ap)
    args = ap.parse_args(argv)

    if args.update_baseline and not args.baseline:
        ap.error("--update-baseline requires --baseline FILE")

    from repro_torch.analysis.spmd import analyze_all, combos

    if args.list_combos:
        for backend, mode in combos():
            print(f"{backend}/{mode}")
        return 0

    if args.seed_violation:
        from repro_torch.analysis.spmd.selftest import SEEDABLE_RULES, seed_findings

        rule = args.seed_violation.upper()
        if rule not in SEEDABLE_RULES:
            ap.error(
                f"no seeded program for {rule!r}; "
                f"seedable: {', '.join(SEEDABLE_RULES)}"
            )
        findings = seed_findings(rule)
        for f in findings:
            print(f.render())
        caught = any(f.rule == rule for f in findings)
        if not args.quiet:
            verdict = "caught" if caught else "MISSED — the gate is blind"
            print(f"jitlint[spmd]: seeded {rule} {verdict}")
        if args.json_out:
            with open(args.json_out, "w", encoding="utf-8") as fh:
                fh.write(_json_payload("spmd-selftest", findings, 0, []))
        return 1 if caught else 0

    findings = analyze_all(
        only=_parse_combo(args.combo),
        quiet=args.quiet,
        echo=lambda m: print(m, file=sys.stderr),
    )
    return _gate(findings, "spmd", args)


def main(argv: List[str] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _SUBCOMMANDS:
        sub, rest = argv[0], argv[1:]
    else:
        sub, rest = "ast", argv  # bare legacy form == ast
    if sub == "spmd":
        return _main_spmd(rest)
    return _main_ast(rest)


if __name__ == "__main__":
    sys.exit(main())
