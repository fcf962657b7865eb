"""repro_torch.analysis: the jitlint trace-safety analyzer and runtime sanitizer.

The counterpart of ``repro.analysis``, with each rule in PyTorch's
meaning.  The port's counterpart of a traced region is a *sync-free
region*: code that must not read a tensor's value on the host, because
the dry-run's fake worlds run it on fake tensors and because on the card
every such read is a stream sync.

Static side (pure ``ast``, no torch import): infer the sync-free regions
(:mod:`repro_torch.analysis.regions`), then check the rules TS01–TS07
(:mod:`repro_torch.analysis.rules`).  CLI: ``python -m
repro_torch.analysis ast`` with ruff-style ``file:line:col: TSxx message``
output gated by the committed ``ANALYSIS_BASELINE_TORCH.json``
(:mod:`repro_torch.analysis.baseline`).

SPMD side (:mod:`repro_torch.analysis.spmd`, ``python -m
repro_torch.analysis spmd``): records the aten ops of a tiny solve of
every backend x mode combo, on 4 gloo ranks for the mesh backends, and
checks replica uniformity (SP01–SP03), integer ranges (NU01–NU02) and
writes into buffers the solve does not own (DN01).

Runtime side (:mod:`repro_torch.analysis.sanitize`): counters of host
reads, host-to-device copies and memo rebuilds around warm solves.

Suppress a single line with ``# jitlint: ignore`` or
``# jitlint: ignore[TS03]``.
"""

from __future__ import annotations

from typing import List

from repro_torch.analysis.findings import Finding, sort_findings
from repro_torch.analysis.regions import Project
from repro_torch.analysis.rules import check_project

__all__ = ["Finding", "Project", "analyze_paths", "check_project"]


def analyze_paths(paths) -> List[Finding]:
    """Index ``paths`` (files or directories), infer the sync-free regions,
    and run every rule.  Returns findings sorted by (path, line, col,
    rule)."""
    project = Project.load(paths)
    return sort_findings(check_project(project))
