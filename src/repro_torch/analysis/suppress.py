"""Per-line suppression comments, shared by the ast and spmd layers (a copy
of ``repro.analysis.suppress``).

Two forms, both anchored on the offending source line:

  ``# jitlint: ignore``             blanket — silences every rule on the line
  ``# jitlint: ignore[TS03,SP01]``  scoped — silences only the listed rules

A scoped suppression naming a rule id the analyzer does not know is
itself a finding (rule ``SUP01``): a typo'd id silently suppresses
nothing while looking reviewed, which is worse than no suppression.
"""

from __future__ import annotations

import re
from typing import FrozenSet, Optional, Tuple

SUPPRESS_MARKER = "jitlint: ignore"

# Every rule id either analyzer layer can emit.  SUP01 is the
# meta-rule: an unknown id inside a scoped suppression comment.
AST_RULES: Tuple[str, ...] = (
    "TS01", "TS02", "TS03", "TS04", "TS05", "TS06", "TS07", "SUP01",
)
SPMD_RULES: Tuple[str, ...] = ("SP01", "SP02", "SP03", "NU01", "NU02", "DN01")
KNOWN_RULES: FrozenSet[str] = frozenset(AST_RULES) | frozenset(SPMD_RULES)

_SCOPED = re.compile(re.escape(SUPPRESS_MARKER) + r"\[([^\]]*)\]")


def parse_suppression(line_text: str) -> Optional[FrozenSet[str]]:
    """The suppression on one source line, if any.

    Returns None (no marker), ``frozenset()`` (blanket form — every rule),
    or the frozenset of rule ids a scoped form lists (unknown ids
    included verbatim; validate with :func:`unknown_rule_ids`)."""
    if SUPPRESS_MARKER not in line_text:
        return None
    m = _SCOPED.search(line_text)
    if m is None:
        return frozenset()  # blanket
    ids = [tok.strip().upper() for tok in m.group(1).split(",")]
    return frozenset(tok for tok in ids if tok)


def suppresses(line_text: str, rule: str) -> bool:
    """True iff the line's suppression comment (if any) silences ``rule``."""
    scope = parse_suppression(line_text)
    if scope is None:
        return False
    return not scope or rule in scope


def unknown_rule_ids(line_text: str) -> Tuple[str, ...]:
    """Rule ids a scoped suppression lists that no analyzer layer knows."""
    scope = parse_suppression(line_text)
    if not scope:  # no marker, or blanket form
        return ()
    return tuple(sorted(scope - KNOWN_RULES))
