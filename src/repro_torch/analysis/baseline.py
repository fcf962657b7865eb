"""Committed findings baseline: CI fails only on NEW findings.

A copy of ``repro.analysis.baseline`` (same format, same bytes on disk).
The port's file is ``ANALYSIS_BASELINE_TORCH.json``; it pins the accepted
findings at adoption time so the analyzer can gate CI from day one
without a big-bang cleanup.  Keys are line-number-free (rule, path,
context, normalized line text) — see
:meth:`repro_torch.analysis.findings.Finding.baseline_key` — so unrelated
edits don't churn the file.

Lifecycle:
  * a finding matching a baseline entry is **suppressed** (counted, not
    reported);
  * a finding with no entry is **new** → exit 1;
  * an entry with no finding is **expired** — reported as fixable debt
    and removed by ``--update-baseline``.

Since the spmd layer landed, the committed file is **sectioned**
(format 2): the ``ast`` and ``spmd`` analyzers each own one named entry
list, and each run only splits/expires/rewrites *its own* section — an
ast run can never expire spmd debt or vice versa.  Format-1 files (a
flat ``findings`` list) load as the ``ast`` section for compatibility.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Tuple

from repro_torch.analysis.findings import Finding

_FORMAT = 1
_FORMAT_SECTIONED = 2
SECTIONS = ("ast", "spmd")


def _entry(f: Finding) -> Dict[str, str]:
    rule, path, context, line_text = f.baseline_key()
    return {"rule": rule, "path": path, "context": context, "line": line_text}


def _key(entry: Dict[str, str]) -> Tuple[str, str, str, str]:
    return (
        entry.get("rule", ""),
        entry.get("path", ""),
        entry.get("context", ""),
        entry.get("line", ""),
    )


def dump(findings: Iterable[Finding]) -> str:
    entries = sorted(
        ({**_entry(f)} for f in findings),
        key=lambda e: (e["path"], e["rule"], e["context"], e["line"]),
    )
    # dedup identical keys (two findings on one line collapse to one entry)
    seen, unique = set(), []
    for e in entries:
        k = _key(e)
        if k not in seen:
            seen.add(k)
            unique.append(e)
    return json.dumps({"format": _FORMAT, "findings": unique}, indent=2) + "\n"


def load(text: str) -> List[Dict[str, str]]:
    """Legacy flat view: the ``ast`` section of any supported format."""
    return load_sections(text).get("ast", [])


def load_sections(text: str) -> Dict[str, List[Dict[str, str]]]:
    """Section name → entry list, for either on-disk format.

    Format 2 files carry ``{"format": 2, "sections": {"ast": [...],
    "spmd": [...]}}``; format 1 files (flat ``findings``) come back as
    ``{"ast": [...]}`` so pre-sectioned baselines keep gating."""
    data = json.loads(text) if text.strip() else {"sections": {}}
    if isinstance(data, dict) and isinstance(data.get("sections"), dict):
        return {
            str(name): list(entries)
            for name, entries in data["sections"].items()
        }
    if isinstance(data, dict) and "findings" in data:
        return {"ast": list(data["findings"])}
    raise ValueError(
        "baseline must be {'format': 2, 'sections': {...}} "
        "or the legacy {'format': 1, 'findings': [...]}"
    )


def dump_sections(sections: Dict[str, Iterable]) -> str:
    """Serialize a sectioned baseline (format 2).

    Each section's value may be Findings (freshly pinned) or already-
    serialized entry dicts (a section preserved verbatim from a prior
    load — the update path for the *other* analyzer's debt)."""
    out: Dict[str, List[Dict[str, str]]] = {}
    for name in sorted(sections):
        entries: List[Dict[str, str]] = []
        for item in sections[name]:
            entries.append(_entry(item) if isinstance(item, Finding) else dict(item))
        entries.sort(key=lambda e: (e.get("path", ""), e.get("rule", ""),
                                    e.get("context", ""), e.get("line", "")))
        seen, unique = set(), []
        for e in entries:
            k = _key(e)
            if k not in seen:
                seen.add(k)
                unique.append(e)
        out[name] = unique
    return json.dumps(
        {"format": _FORMAT_SECTIONED, "sections": out}, indent=2
    ) + "\n"


def split(
    findings: List[Finding], entries: List[Dict[str, str]]
) -> Tuple[List[Finding], List[Finding], List[Dict[str, str]]]:
    """(new, suppressed, expired_entries) for one run against a baseline.

    Matching is multiset-aware: N identical keys in the baseline absorb at
    most N identical findings."""
    budget: Dict[Tuple[str, str, str, str], int] = {}
    for e in entries:
        budget[_key(e)] = budget.get(_key(e), 0) + 1
    new: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        k = f.baseline_key()
        if budget.get(k, 0) > 0:
            budget[k] -= 1
            suppressed.append(f)
        else:
            new.append(f)
    expired = [e for e in entries if budget.get(_key(e), 0) > 0]
    for e in expired:
        budget[_key(e)] -= 1
    return new, suppressed, expired
