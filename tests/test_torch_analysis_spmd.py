"""repro_torch.analysis.spmd: the recorded-op SPMD/numeric/ownership layer.

The reference's spmd tests cannot be the oracle here (they fail at the
seed: ``jax.core.ClosedJaxpr`` is gone from the installed jax), so the
port's layer is held against three things:

  * the reference's committed verdict: ``ANALYSIS_BASELINE.json``'s spmd
    section is empty, every combo clean; the port's baseline's must be too;
  * seeded-violation self-tests: one deliberately broken program per rule
    MUST be caught, and only by its own rule;
  * a runtime ground truth: on 4 gloo ranks of a (2, 2) mesh, every value
    the uniformity lattice calls uniform is bit-equal on every rank, and a
    seeded varying channel differs.

The mesh combos and the channel run in one spawn of 4 ranks for the
module; the mesh seeds make their own fake worlds, so they run in one
subprocess of their own.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.analysis import baseline
from repro_torch.analysis.spmd import analyze_recordings, combos, record_combo
from repro_torch.analysis.spmd.dispatch_tools import Recorder
from repro_torch.analysis.spmd.harness import MESH_BACKENDS, record_mesh
from repro_torch.analysis.spmd.uniformity import Lattice, op_keys
from repro_torch.analysis.suppress import SPMD_RULES

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
BASELINE_PATH = os.path.join(REPO, "ANALYSIS_BASELINE_TORCH.json")
REF_BASELINE_PATH = os.path.join(REPO, "ANALYSIS_BASELINE.json")
MESH_SPECS = [f"{b}/{m}" for b, m in combos() if b in MESH_BACKENDS]


def _env():
    return dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def mesh_recs():
    """Every mesh combo and the seeded channel, recorded once on 4 gloo
    ranks with the ground truth's digests."""
    return record_mesh(MESH_SPECS + ["channel"], digests=True)


@pytest.fixture(scope="module")
def seeded():
    """rule -> the seeded program's findings, from one subprocess (the
    mesh seeds make worlds of the fake process group of their own)."""
    code = ("import json; from repro_torch.analysis.spmd.selftest import SEEDABLE_RULES, "
            "seed_findings; print(json.dumps({r: [[f.rule, f.path, f.line] for f in "
            "seed_findings(r)] for r in SEEDABLE_RULES}))")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=REPO, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    return json.loads(run.stdout.strip().splitlines()[-1])


# ----------------------------------------------------------------------------
# seeded violations: the gate must fire on every rule it claims to carry
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("rule", ["SP01", "SP02", "SP03", "NU01", "NU02", "DN01"])
def test_seeded_violation_is_caught_by_its_rule_only(seeded, rule):
    rules = {f[0] for f in seeded[rule]}
    assert rules == {rule}, f"seed {rule} gave {seeded[rule]}"
    assert all(f[1] == "src/repro_torch/analysis/spmd/selftest.py" for f in seeded[rule])


def test_seedable_rules_cover_every_spmd_rule():
    from repro_torch.analysis.spmd.selftest import SEEDABLE_RULES

    assert set(SEEDABLE_RULES) == set(SPMD_RULES)


def test_cli_seed_violation_exits_one_with_rule_id(tmp_path):
    artifact = tmp_path / "findings.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "spmd", "--seed-violation", "NU01",
         "--json", str(artifact)],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300)
    assert run.returncode == 1, run.stdout + run.stderr
    assert "NU01" in run.stdout
    payload = json.loads(artifact.read_text())
    assert payload["new"] and all(f["rule"] == "NU01" for f in payload["new"])


# ----------------------------------------------------------------------------
# the real solves: every combo recorded and clean modulo the baseline
# ----------------------------------------------------------------------------


def test_combos_come_from_the_live_registry():
    from repro_torch.solver.config import BACKEND_MODES

    got = list(combos())
    assert got == [(b, m) for b in sorted(BACKEND_MODES) for m in BACKEND_MODES[b]]
    assert len(got) == 12


def test_all_combos_clean_modulo_baseline(mesh_recs):
    with open(BASELINE_PATH, encoding="utf-8") as fh:
        entries = baseline.load_sections(fh.read())["spmd"]
    with open(REF_BASELINE_PATH, encoding="utf-8") as fh:
        assert baseline.load_sections(fh.read())["spmd"] == []  # the reference's verdict
    assert entries == []
    findings = []
    for backend, mode in combos():
        spec = f"{backend}/{mode}"
        recs = mesh_recs[spec] if spec in mesh_recs else [record_combo(backend, mode)]
        assert recs[0].ops, spec
        findings += analyze_recordings(recs, context=spec)
    new, _suppressed, _expired = baseline.split(findings, entries)
    assert new == [], "new spmd findings in the solves:\n" + "\n".join(f.render() for f in new)


def test_mesh_recordings_see_the_collectives(mesh_recs):
    """The (2, 2) world runs the real distributed program: collectives over
    each axis and over both, the same sequence on every rank."""
    for spec in MESH_SPECS:
        recs = mesh_recs[spec]
        assert sorted(r.rank for r in recs) == [0, 1, 2, 3]
        axes = {recs[0].mesh_groups[op.collective[1]] for op in recs[0].ops if op.collective}
        assert ("data", "model") in axes and ("model",) in axes, spec
        assert len({len(r.ops) for r in recs}) == 1, spec


def test_cli_spmd_single_combo_clean_against_baseline():
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "spmd", "--combo", "single/dense",
         "--baseline", BASELINE_PATH],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr


# ----------------------------------------------------------------------------
# the runtime ground truth on 4 gloo ranks
# ----------------------------------------------------------------------------


def _digests(recs):
    out = {}
    for r in recs:
        for k, op in zip(op_keys(r), r.ops):
            out.setdefault(k, {})[r.rank] = op.digest
    return {k: d for k, d in out.items()
            if len(d) == len(recs) and all(v is not None for v in d.values())}


@pytest.mark.parametrize("spec", MESH_SPECS)
def test_uniform_values_are_bit_equal_on_every_rank(mesh_recs, spec):
    recs = mesh_recs[spec]
    verdict = Lattice(recs).run()
    digests = _digests(recs)
    uniform = [k for k in digests if not verdict[k]]
    assert len(uniform) > 100, spec
    bad = [k for k in uniform if len(set(digests[k].values())) > 1]
    assert bad == [], f"called uniform, differ across ranks: {bad[:5]}"
    # the lattice is not vacuous: most values it calls varying do differ
    varying = [k for k in digests if verdict[k]]
    assert sum(len(set(digests[k].values())) > 1 for k in varying) > len(varying) // 2


def test_seeded_varying_channel_differs(mesh_recs):
    recs = mesh_recs["channel"]
    verdict = Lattice(recs).run()
    digests = _digests(recs)
    by_op = {k[2]: k for k in digests}
    varying = by_op["aten.full.default"]
    reduced = by_op["c10d.allreduce_.default"]
    assert verdict[varying] == {"model"}
    assert len(set(digests[varying].values())) == 2  # one value per "model" coordinate
    assert not verdict[reduced] and len(set(digests[reduced].values())) == 1
    # reading the varying channel on the host is exactly SP01
    assert {f.rule for f in analyze_recordings(recs, "channel")} == {"SP01"}


# ----------------------------------------------------------------------------
# interval, ownership and suppression details worth pinning
# ----------------------------------------------------------------------------


def _record(fn, *args, owned=()):
    with Recorder() as rec:
        fn(*args)
    return [rec.recording(owned=owned)]


def test_nu01_fires_only_on_proven_overflow():
    def safe():
        return torch.arange(1000, dtype=torch.int32).to(torch.int16)

    def unknown(x):
        return x.to(torch.int16)  # unknown range: must NOT fire

    def through_arithmetic():
        return (torch.arange(100, dtype=torch.int32) * 1000).to(torch.int16)

    def into_narrow_buffer():
        dst = torch.zeros(4, dtype=torch.int16)
        dst.copy_(torch.full((4,), 40000, dtype=torch.int32))  # a cast hidden in copy_
        return dst

    assert analyze_recordings(_record(safe), "t") == []
    assert analyze_recordings(_record(unknown, torch.arange(4, dtype=torch.int32)), "t") == []
    assert {f.rule for f in analyze_recordings(_record(through_arithmetic), "t")} == {"NU01"}
    assert {f.rule for f in analyze_recordings(_record(into_narrow_buffer), "t")} == {"NU01"}


def test_dn01_quiet_on_an_owned_buffer():
    def relabel(buf):
        head = buf[:4]
        buf.mul_(2.0)
        return head + 1.0

    buf = torch.ones(8)
    assert {f.rule for f in analyze_recordings(_record(relabel, buf), "t")} == {"DN01"}
    assert analyze_recordings(_record(relabel, buf, owned=(buf,)), "t") == []

    def fresh():
        own = torch.zeros(8)  # made inside the region: its own
        own[2:4] = 1.0
        return own.add_(1.0)

    assert analyze_recordings(_record(fresh), "t") == []


def test_scoped_suppression_silences_spmd_finding(tmp_path):
    mod = tmp_path / "suppressed_spmd.py"
    mod.write_text(
        "import torch\n"
        "\n"
        "def overflow():\n"
        "    x = torch.arange(70000, dtype=torch.int32)\n"
        "    return x.to(torch.int16)  # jitlint: ignore[NU01]\n"
        "\n"
        "def loud():\n"
        "    x = torch.arange(70000, dtype=torch.int32)\n"
        "    return x.to(torch.int16)  # jitlint: ignore[NU02]\n",
        encoding="utf-8",
    )
    import importlib.util

    spec = importlib.util.spec_from_file_location("suppressed_spmd", mod)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    assert analyze_recordings(_record(m.overflow), "t") == []
    loud = analyze_recordings(_record(m.loud), "t")
    assert [f.rule for f in loud] == ["NU01"] and loud[0].line == 9
