"""Recorded-op SPMD, numeric-range and ownership analyses.

The counterpart of ``repro.analysis.spmd``.  The ast layer
(:mod:`repro_torch.analysis.rules`) sees source text; this layer sees what
runs: it records the aten ops of a tiny solve of every registered
backend x mode combo (:mod:`.dispatch_tools`), the mesh combos on 4 gloo
ranks, and runs three analyses over the recordings:

  :mod:`.uniformity`  replica-uniformity lattice   → SP01, SP02, SP03
  :mod:`.intervals`   value-range interpretation   → NU01, NU02
  :mod:`.donation`    writes into foreign buffers  → DN01

:mod:`.harness` owns recording (the tiny graph, the (2, 2) world, the live
registry); :mod:`.selftest` keeps one deliberately broken torch program
per rule, so CI can prove the gate fires.  Findings flow through the same
:mod:`repro_torch.analysis.findings` / :mod:`repro_torch.analysis.baseline`
plumbing as the ast layer: one sectioned ``ANALYSIS_BASELINE_TORCH.json``,
one CLI.
"""

from repro_torch.analysis.spmd.harness import (  # noqa: F401
    analyze_all,
    analyze_recordings,
    combos,
    record_combo,
)
