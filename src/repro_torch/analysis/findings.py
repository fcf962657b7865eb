"""Finding container + ruff-style rendering for the jitlint analyzer (a copy
of ``repro.analysis.findings``)."""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location.

    Attributes:
      rule: rule id ("TS01" … "TS07").
      path: file path as given to the analyzer (normalized separators).
      line, col: 1-based line / 0-based column of the offending node.
      message: human-readable description of the hazard.
      context: dotted qualname of the enclosing function ("<module>" at
        module scope) — part of the baseline key, so findings survive
        unrelated line drift.
      line_text: stripped source text of the offending line — the other
        half of the baseline key.
    """

    rule: str
    path: str
    line: int
    col: int
    message: str
    context: str = "<module>"
    line_text: str = ""

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col + 1}: {self.rule} "
            f"{self.message} [in {self.context}]"
        )

    def baseline_key(self) -> Tuple[str, str, str, str]:
        """Line-number-free identity: (rule, path, context, line text).

        Keyed on the *text* of the line rather than its number so that
        edits elsewhere in the file do not churn the baseline; moving or
        rewording the offending line retires the entry (and re-raises
        the finding as new — by design)."""
        return (self.rule, norm_path(self.path), self.context, self.line_text)


def norm_path(path: str) -> str:
    """Repo-relative forward-slash path (stable baseline keys on any OS)."""
    p = os.path.normpath(path).replace(os.sep, "/")
    for prefix in ("./",):
        if p.startswith(prefix):
            p = p[len(prefix):]
    return p


def sort_findings(findings) -> list:
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))
