"""Per-line suppression: blanket and rule-scoped forms.

``# jitlint: ignore`` silences every rule on its line;
``# jitlint: ignore[TS03]`` silences only the listed rules, and a scope
naming an id no analyzer knows is itself a finding (SUP01)."""

from repro_torch.knobs import sync_free


@sync_free
def acknowledged_hazard(x):
    # a deliberate, reviewed exception is suppressed in place
    flag = bool(x[0] > 0)  # jitlint: ignore
    probe = float(x[0])  # expect: TS03
    return flag, probe


@sync_free
def scoped_suppressions(x):
    # scoped form: the listed rule is silenced on this line
    flag = bool(x[0] > 0)  # jitlint: ignore[TS02, TS03]
    # a scope listing a DIFFERENT rule silences nothing
    probe = float(x[0])  # jitlint: ignore[TS01]  # expect: TS03
    # a typo'd id suppresses nothing while looking reviewed — flag both
    leak = int(x[1])  # jitlint: ignore[TS99]  # expect: TS03, SUP01
    return flag, probe, leak
