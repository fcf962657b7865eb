"""The port's jitlint analyzer: fixture corpus, region inference, baseline
and suppression plumbing against the reference's, knobs, CLI, the runtime
sanitizer and the mesh memo.

The fixture harness is exhaustive in both directions, as the reference's
(tests/test_analysis.py): every line tagged ``# expect: TSxx`` in
tests/analysis_fixtures_torch/*.py must produce that finding, and every
untagged line must stay quiet.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.analysis import analyze_paths as ref_analyze_paths
from repro.analysis import baseline as ref_baseline
from repro.analysis import suppress as ref_suppress
from repro.analysis.findings import Finding as RefFinding
from repro_torch import knobs
from repro_torch.analysis import analyze_paths, baseline, sanitize, suppress
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.regions import Project

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "analysis_fixtures_torch")
REF_FIXTURES = os.path.join(HERE, "analysis_fixtures")
REPO = os.path.dirname(HERE)
SRC = os.path.join(REPO, "src", "repro_torch")
BASELINE_PATH = os.path.join(REPO, "ANALYSIS_BASELINE_TORCH.json")
REF_BASELINE_PATH = os.path.join(REPO, "ANALYSIS_BASELINE.json")

_EXPECT = re.compile(r"#\s*expect:\s*([A-Z0-9,\s]+)")


def _fixture_files(folder=FIXTURES):
    return sorted(
        os.path.join(folder, f)
        for f in os.listdir(folder)
        if f.endswith(".py") and f != "__init__.py"
    )


def _expected_markers(path):
    """{(lineno, rule)} parsed from trailing ``# expect: TSxx`` comments."""
    out = set()
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, start=1):
            m = _EXPECT.search(line)
            if not m:
                continue
            for rule in re.split(r"[,\s]+", m.group(1).strip()):
                if rule:
                    out.add((lineno, rule))
    return out


# ----------------------------------------------------------------------------
# fixture corpus: positive + negative per rule
# ----------------------------------------------------------------------------


@pytest.mark.parametrize(
    "path", _fixture_files(), ids=[os.path.basename(p) for p in _fixture_files()]
)
def test_fixture_findings_match_markers(path):
    found = {(f.line, f.rule) for f in analyze_paths([path])}
    expected = _expected_markers(path)
    missing = expected - found
    unexpected = found - expected
    assert not missing, f"rules that failed to fire: {sorted(missing)}"
    assert not unexpected, f"false positives: {sorted(unexpected)}"


@pytest.mark.parametrize(
    "ref_path", _fixture_files(REF_FIXTURES),
    ids=[os.path.basename(p) for p in _fixture_files(REF_FIXTURES)],
)
def test_fixtures_translate_the_reference_line_for_line(ref_path):
    """Every reference fixture has a torch translation carrying its
    ``# expect:`` markers on the same lines."""
    path = os.path.join(FIXTURES, os.path.basename(ref_path))
    assert os.path.exists(path)
    assert _expected_markers(ref_path) <= _expected_markers(path)


def test_every_rule_has_positive_and_negative_coverage():
    rules = {f"TS0{i}" for i in range(1, 8)} | {"SUP01"}
    tagged = set()
    for path in _fixture_files():
        tagged |= {r for _, r in _expected_markers(path)}
    assert tagged == rules, f"rules without a positive fixture: {rules - tagged}"


@pytest.mark.parametrize("name", ["ts04_idcache.py", "ts05_setorder.py"])
def test_host_rules_match_the_reference_on_its_fixtures(name):
    """TS04 / TS05 are host-code rules with one meaning in both packages:
    the port gives the reference's findings on the reference's fixtures."""
    path = os.path.join(REF_FIXTURES, name)

    def key(f):
        return (f.rule, f.line, f.col, f.message, f.context, f.line_text)

    ref = [key(f) for f in ref_analyze_paths([path])]
    assert ref and [key(f) for f in analyze_paths([path])] == ref


# ----------------------------------------------------------------------------
# region inference
# ----------------------------------------------------------------------------


def _load_regions():
    return Project.load([os.path.join(FIXTURES, "regions_nested.py")])


def test_transitive_callee_is_traced_with_static_params():
    proj = _load_regions()
    (mod,) = proj.modules.values()
    helper = mod.functions["helper_called_from_jit"]
    assert helper.traced and not helper.is_root
    assert helper.param_static == {"x": False, "mode": True}


def test_loop_bodies_and_nested_defs_are_traced():
    proj = _load_regions()
    (mod,) = proj.modules.values()
    for name in ("loop_body", "loop_cond", "entry.nested", "make_sharded.body"):
        fn = mod.functions[name]
        assert fn.traced, f"{name} should be in a region ({fn.trace_reason!r})"
        assert not any(fn.param_static.values()), f"{name} params must be tensors"


def test_host_code_is_not_traced():
    proj = _load_regions()
    (mod,) = proj.modules.values()
    assert not mod.functions["plain_helper"].traced
    assert not mod.functions["make_sharded"].traced


def test_root_declaration_parsed():
    proj = _load_regions()
    (mod,) = proj.modules.values()
    entry = mod.functions["entry"]
    assert entry.is_root
    assert entry.param_static == {"x": False, "mode": True}


def test_port_roots_are_found():
    """The port's roots: the step closures and DistRounds marked
    ``sync_free``, the kernel wrappers, autograd.Function methods and the
    callables ``checkpoint`` / ``local_call`` run (through ``_remat``)."""
    proj = Project.load([SRC])
    roots = {f.display() for f in proj.traced_functions() if f.is_root}
    for name in (
        "repro_torch.models.transformer.make_train_step.train_step",
        "repro_torch.models.transformer.make_decode_step.decode_step",
        "repro_torch.models.transformer.make_prefill_step.prefill_step",
        "repro_torch.models.gnn.make_train_step.train_step",
        "repro_torch.models.recsys.make_step.step",
        "repro_torch.models.recsys.make_step.serve",
        "repro_torch.optim.adamw.adamw_update",
        "repro_torch.core.dist_steiner._build.edge_round",
        "repro_torch.core.dist_steiner._build.frontier_init",
        "repro_torch.kernels.minplus.minplus.minplus_call",
        "repro_torch.kernels.minplus.minplus.minplus_blocked_call",
        "repro_torch.kernels.segmin.segmin.segmin_bucketed_call",
        "repro_torch.models.gnn._ScatterSum.forward",
    ):
        assert name in roots, name
    gnn = proj.modules["repro_torch.models.gnn"].functions.values()
    assert any(f.trace_reason == "passed to _remat" for f in gnn)  # _remat forwards
    edge_round = proj.modules["repro_torch.core.dist_steiner"].functions["_build.edge_round"]
    assert edge_round.param_static == {"loop": False, "it": True}


# ----------------------------------------------------------------------------
# baseline: add / suppress / expire round-trip, and byte parity
# ----------------------------------------------------------------------------


def _mk(rule="TS01", path="a.py", ctx="a.f", text="assert x", cls=Finding):
    return cls(rule=rule, path=path, line=3, col=4, message="m", context=ctx,
               line_text=text)


def test_baseline_round_trip_suppresses_everything():
    findings = [_mk(), _mk(rule="TS03", text="float(x)")]
    entries = baseline.load(baseline.dump(findings))
    new, suppressed, expired = baseline.split(findings, entries)
    assert new == [] and expired == []
    assert len(suppressed) == 2


def test_baseline_is_line_number_free():
    pinned = baseline.load(baseline.dump([_mk()]))
    drifted = [Finding(rule="TS01", path="a.py", line=99, col=0, message="m",
                       context="a.f", line_text="assert x")]
    new, suppressed, _ = baseline.split(drifted, pinned)
    assert new == [] and len(suppressed) == 1


def test_baseline_flags_new_and_expired():
    entries = baseline.load(baseline.dump([_mk()]))
    fresh = _mk(rule="TS05", text="np.array(set(x))")
    new, suppressed, expired = baseline.split([fresh], entries)
    assert new == [fresh] and suppressed == [] and len(expired) == 1


def test_baseline_multiset_budget():
    entries = baseline.load(baseline.dump([_mk()]))
    new, suppressed, expired = baseline.split([_mk(), _mk()], entries)
    assert len(suppressed) == 1 and len(new) == 1 and expired == []


def test_sectioned_baseline_sections_do_not_interfere():
    ast_f = [_mk()]
    spmd_f = [_mk(rule="SP01", path="core.py", ctx="mesh1d/dense")]
    sections = baseline.load_sections(baseline.dump_sections({"ast": ast_f, "spmd": spmd_f}))
    assert baseline.split(ast_f, sections["ast"])[2] == []
    assert baseline.split(spmd_f, sections["spmd"])[2] == []
    sections["ast"] = []
    reloaded = baseline.load_sections(baseline.dump_sections(sections))
    assert reloaded["ast"] == [] and reloaded["spmd"][0]["rule"] == "SP01"


def test_legacy_format1_loads_as_ast_section():
    text = baseline.dump([_mk()])
    sections = baseline.load_sections(text)
    assert set(sections) == {"ast"} and baseline.load(text) == sections["ast"]


def _corpus():
    return [
        [_mk(), _mk(rule="TS03", text="float(x)"), _mk(rule="TS03", text="float(x)")],
        [_mk(rule="SP01", path="./core\\x.py", ctx="mesh1d/dense", text='s = "é"'),
         _mk(rule="DN01", path="b.py", ctx="single/pallas", text="x.mul_(2)")],
        [],
    ]


@pytest.mark.parametrize("case", range(3))
def test_baseline_bytes_equal_the_reference(case):
    """``dump`` / ``dump_sections`` write the reference's bytes for the
    same findings, and ``load_sections`` reads the same entries."""
    ours = _corpus()[case]
    ref = [_mk(f.rule, f.path, f.context, f.line_text, cls=RefFinding) for f in ours]
    assert baseline.dump(ours) == ref_baseline.dump(ref)
    text = baseline.dump_sections({"ast": ours, "spmd": ours[:1]})
    assert text == ref_baseline.dump_sections({"ast": ref, "spmd": ref[:1]})
    assert baseline.load_sections(text) == ref_baseline.load_sections(text)


@pytest.mark.parametrize("path", [REF_BASELINE_PATH, BASELINE_PATH])
def test_committed_baselines_load_and_dump_like_the_reference(path):
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    sections = baseline.load_sections(text)
    assert sections == ref_baseline.load_sections(text)
    assert baseline.dump_sections(sections) == ref_baseline.dump_sections(sections) == text


# ----------------------------------------------------------------------------
# suppression comments: blanket / scoped / unknown-id forms
# ----------------------------------------------------------------------------


def test_suppression_parsing_forms():
    assert suppress.parse_suppression("x = 1") is None
    assert suppress.parse_suppression("x = 1  # jitlint: ignore") == frozenset()
    assert suppress.parse_suppression("x  # jitlint: ignore[TS03, sp01]") == {"TS03", "SP01"}
    assert suppress.suppresses("x  # jitlint: ignore", "TS01")
    assert suppress.suppresses("x  # jitlint: ignore[TS03]", "TS03")
    assert not suppress.suppresses("x  # jitlint: ignore[TS03]", "TS01")
    assert suppress.unknown_rule_ids("x  # jitlint: ignore[TS99, SP01]") == ("TS99",)
    assert suppress.unknown_rule_ids("x  # jitlint: ignore") == ()


_IDS = st.sampled_from(sorted(suppress.KNOWN_RULES) + ["TS99", "sp01", "XX", " TS03 ", ""])
_LINES = st.builds(
    lambda code, ids, sep, form: code + {
        0: "",
        1: "  # jitlint: ignore",
        2: "  # jitlint: ignore[" + sep.join(ids) + "]",
        3: "  # jitlint: ignore[" + sep.join(ids),
        4: "  # jitlint:ignore[" + sep.join(ids) + "]",
    }[form],
    st.text(st.characters(blacklist_characters="\n\r"), max_size=20),
    st.lists(_IDS, max_size=4),
    st.sampled_from([",", ", ", " ,"]),
    st.integers(0, 4),
)


@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(_LINES, st.sampled_from(sorted(suppress.KNOWN_RULES)))
def test_suppression_parsing_equals_the_reference(line, rule):
    assert suppress.parse_suppression(line) == ref_suppress.parse_suppression(line)
    assert suppress.unknown_rule_ids(line) == ref_suppress.unknown_rule_ids(line)
    assert suppress.suppresses(line, rule) == ref_suppress.suppresses(line, rule)


def test_rule_ids_equal_the_reference():
    assert suppress.AST_RULES == ref_suppress.AST_RULES
    assert suppress.SPMD_RULES == ref_suppress.SPMD_RULES


def test_sup01_not_raised_for_docstring_mentions(tmp_path):
    mod = tmp_path / "doc.py"
    mod.write_text(
        '"""Docs may mention # jitlint: ignore[XX99] without tripping."""\n'
        "MARKER = 'jitlint: ignore[YY88]'\n",
        encoding="utf-8",
    )
    assert analyze_paths([str(mod)]) == []


# ----------------------------------------------------------------------------
# self-lint and the CLI
# ----------------------------------------------------------------------------


def test_self_lint_src_repro_torch_modulo_baseline(monkeypatch):
    monkeypatch.chdir(REPO)  # baseline keys are repo-relative paths
    findings = analyze_paths(["src/repro_torch"])
    with open(BASELINE_PATH, encoding="utf-8") as fh:
        entries = baseline.load_sections(fh.read())["ast"]
    new, _suppressed, expired = baseline.split(findings, entries)
    assert new == [], "new trace-safety findings in src/repro_torch:\n" + "\n".join(
        f.render() for f in new)
    assert expired == [], f"fixed debt still in the baseline: {expired}"


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          capture_output=True, text=True, env=_env(), cwd=REPO)


def test_ast_layer_imports_no_torch_and_the_port_no_jax():
    code = ("import sys, repro_torch.analysis, repro_torch.analysis.__main__, "
            "repro_torch.knobs; assert 'torch' not in sys.modules, 'torch'; "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) or m == 'repro' "
            "for m in sys.modules), 'jax'")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=REPO)
    assert run.returncode == 0, run.stderr
    bad = re.compile(r"^\s*(import (jax|repro)\b|from (jax|repro)(\.| import))", re.M)
    for root, _dirs, files in os.walk(os.path.join(SRC, "analysis")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f), encoding="utf-8") as fh:
                    assert not bad.search(fh.read()), f
    with open(os.path.join(SRC, "knobs.py"), encoding="utf-8") as fh:
        assert not bad.search(fh.read())


def test_cli_exit_codes(tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text("def f(x):\n    return x\n", encoding="utf-8")
    ok = _cli(str(clean))
    assert ok.returncode == 0, ok.stdout + ok.stderr
    seeded = tmp_path / "seeded.py"
    seeded.write_text(
        "from repro_torch.knobs import sync_free\n\n\n@sync_free\ndef f(x):\n"
        "    assert (x > 0).all()\n    return x\n",
        encoding="utf-8",
    )
    bad = _cli(str(seeded))
    assert bad.returncode == 1 and "TS01" in bad.stdout
    bl = tmp_path / "bl.json"
    assert _cli(str(seeded), "--baseline", str(bl), "--update-baseline").returncode == 0
    again = _cli("ast", str(seeded), "--baseline", str(bl))
    assert again.returncode == 0, again.stdout + again.stderr
    pinned = json.loads(bl.read_text())
    assert pinned["format"] == 2 and pinned["sections"]["ast"]
    usage = _cli("ast", str(clean), "--update-baseline")
    assert usage.returncode == 2
    regions = _cli("ast", str(seeded), "--regions")
    assert regions.returncode == 0 and "[root]" in regions.stdout


def test_cli_gates_src_repro_torch_against_the_committed_baseline():
    run = _cli("ast", "src/repro_torch", "--baseline", BASELINE_PATH, "--strict-expired")
    assert run.returncode == 0, run.stdout + run.stderr


def test_cli_strict_expired_scopes_to_own_section(tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text("def f(x):\n    return x\n", encoding="utf-8")
    bl = tmp_path / "bl.json"
    stale_ast = {"rule": "TS01", "path": "gone.py", "context": "gone.f", "line": "assert x"}
    spmd_entry = {"rule": "SP01", "path": "core.py", "context": "mesh1d/dense",
                  "line": "return hist"}
    bl.write_text(json.dumps(
        {"format": 2, "sections": {"ast": [stale_ast], "spmd": [spmd_entry]}}), encoding="utf-8")
    lenient = _cli("ast", str(clean), "--baseline", str(bl))
    assert lenient.returncode == 0 and "expired" in lenient.stdout
    assert "SP01" not in lenient.stdout
    assert _cli("ast", str(clean), "--baseline", str(bl), "--strict-expired").returncode == 1
    assert _cli("ast", str(clean), "--baseline", str(bl), "--update-baseline").returncode == 0
    data = json.loads(bl.read_text())
    assert data["sections"]["ast"] == [] and data["sections"]["spmd"] == [spmd_entry]


# ----------------------------------------------------------------------------
# knobs: the classification TS06 reads
# ----------------------------------------------------------------------------


def test_knob_classification_is_total_and_disjoint():
    from repro_torch.solver.config import SolverConfig

    fields = {f.name for f in dataclasses.fields(SolverConfig)}
    assert knobs.VIEW_KNOBS | knobs.SOLVE_KNOBS == fields
    assert not knobs.VIEW_KNOBS & knobs.SOLVE_KNOBS
    knobs.validate_config_coverage(fields)


def test_unclassified_field_is_rejected():
    from repro_torch.solver.config import SolverConfig

    fields = {f.name for f in dataclasses.fields(SolverConfig)}
    with pytest.raises(TypeError, match="not_a_knob"):
        knobs.validate_config_coverage(fields | {"not_a_knob"})
    with pytest.raises(TypeError, match="mode"):
        knobs.validate_config_coverage(fields - {"mode"})


def test_knob_aliases_resolve_to_config_fields():
    from repro_torch.solver.config import SolverConfig

    fields = {f.name for f in dataclasses.fields(SolverConfig)}
    assert set(knobs.KNOB_ALIASES.values()) <= fields
    assert knobs.classify("frontier") == "view"  # -> pallas_frontier
    assert knobs.classify("max_rounds") == "solve"  # -> max_iters
    assert knobs.classify("src_block") == "view"
    assert knobs.classify("something_else") is None


def test_sync_free_is_a_no_op():
    def f(x):
        return x + 1

    assert knobs.sync_free(f) is f
    assert knobs.sync_free(static=("it",))(f) is f


# ----------------------------------------------------------------------------
# the runtime sanitizer
# ----------------------------------------------------------------------------


def _tiny_graph():
    from repro_torch.core.graph import from_edges
    from repro_torch.data.graphs import rmat_edges

    src, dst, w, n = rmat_edges(6, 6, max_weight=20, seed=1)
    return from_edges(src, dst, w, n, pad_to=8, device="cpu")


def _mark_rounds(pred, bu, bv, valid) -> int:
    """Rounds of ``core.tree.mark_paths``' pointer doubling: marks spread
    from the bridge endpoints along pred, one level deeper than the last
    round's reach each time (1, 2, 4, ... levels), and the loop ends on the
    first round that adds nothing."""
    pred, valid = np.asarray(pred), np.asarray(valid)
    seen = set(int(e) for e in np.r_[np.asarray(bu)[valid], np.asarray(bv)[valid]])
    level, depth = set(seen), 0
    while True:
        level = {int(pred[u]) for u in level} - seen
        if not level:
            break
        seen |= level
        depth += 1
    return 1 if depth == 0 else int(np.log2(depth)) + 2


def _expected_reads(backend, mode, frontier, out) -> int:
    """The host reads of one warm solve with Prim, written out.

    Voronoi stage: one a round (the round's flag: ``bool`` or the bucket
    schedule's ``tolist``), plus the final loop test of the schedules that
    test before the round (frontier, pallas-frontier) and the bucket
    width's ``tolist`` of weight sums; "dense" and "bucket" batches run
    their lanes one by one, each with its own iterations.
    Tail, a lane: two ``nonzero`` (the distance graph's edge compaction),
    two boolean-mask reads of the bridge endpoints, and two a marking round
    (its ``bool`` and its ``ptr[marked]`` mask read).
    One ``.cpu()`` fetches the totals and counters at the end.
    """
    r = out.raw
    lanes = 1 if backend == "single" else r.parent.shape[0]

    def lane(x, b):
        return x if backend == "single" else x[b]

    its = [int(lane(r.stats.iterations, b)) for b in range(lanes)]
    extra = int(mode in ("bucket", "frontier") or frontier)
    if backend == "batch" and mode in ("dense", "bucket"):
        voronoi = sum(i + extra for i in its)
    else:
        voronoi = out.telemetry.iterations + extra
    tail = sum(4 + 2 * _mark_rounds(lane(r.state.pred, b), lane(r.tree.bridge_u, b),
                                    lane(r.tree.bridge_v, b), lane(r.tree.bridge_valid, b))
               for b in range(lanes))
    return voronoi + tail + 1


_SANITIZED = [("single", m, False) for m in ("dense", "bucket", "frontier", "pallas")] + [
    ("single", "pallas", True)] + [("batch", m, False) for m in ("dense", "bucket", "pallas")] + [
    ("batch", "pallas", True)]


@pytest.mark.parametrize("backend,mode,frontier", _SANITIZED,
                         ids=[f"{b}-{m}{'-frontier' if f else ''}" for b, m, f in _SANITIZED])
def test_warm_solve_under_sanitizer(backend, mode, frontier):
    """A warm solve reads the host exactly as often as the formula says,
    copies nothing onto a card, rebuilds nothing, and answers bit for bit
    what the unguarded solve does."""
    from repro_torch.solver import SolverConfig, SteinerSolver

    kw = {"pallas_frontier": True} if frontier else {}
    cfg = SolverConfig(backend=backend, mode=mode, frontier_size=8, **kw)
    handle = SteinerSolver(cfg, device="cpu").prepare(_tiny_graph())
    rng = np.random.default_rng(7)
    seeds = rng.choice(64, size=5, replace=False).astype(np.int32)
    if backend == "batch":
        seeds = np.stack([seeds, rng.choice(64, size=5, replace=False).astype(np.int32)])
    plain = handle.solve(seeds)
    with sanitize.sanitizer() as rep:
        out = handle.solve(seeds)
    assert rep.rebuilds == 0 and rep.h2d == 0 and rep.sync_warnings is None
    assert rep.host_reads == _expected_reads(backend, mode, frontier, out), rep.reads_by_kind
    for a, b in ((plain.raw.state, out.raw.state), (plain.raw.tree, out.raw.tree)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert torch.equal(x, y), f.name


def test_implicit_read_raises():
    x = torch.arange(4.0)
    with pytest.raises(sanitize.TraceSafetyError, match="host read"):
        with sanitize.host_read_guard(allow=0):
            if x[0] > 1:  # an implicit bool(): a host read
                pass
    with sanitize.host_read_guard(allow=2) as rep:
        x.sum().item()
        x.tolist()
    assert rep.host_reads == 2 and rep.reads_by_kind == {"item": 1, "tolist": 1}


def test_reads_count_once_across_the_two_modes():
    x = torch.arange(6.0)
    with sanitize.host_read_guard() as rep:
        x.cpu().numpy()  # the .cpu() is the read; its .numpy() is not another
        float(x[1])
        x[x > 2]  # boolean-mask indexing: the host reads the count
        torch.nonzero(x)
        x.repeat_interleave(torch.tensor([1, 1, 1, 1, 1, 2]))
        x.repeat_interleave(2)  # known size: no read
    assert rep.reads_by_kind == {"cpu": 1, "__float__": 1, "index[mask]": 1, "nonzero": 1,
                                 "repeat_interleave": 1}, rep.reads_by_kind


def test_cold_prepare_counts_its_builds():
    from repro_torch.solver import SolverConfig, SteinerSolver

    g = _tiny_graph()
    with sanitize.rebuild_guard(allow=1) as rep:
        SteinerSolver(SolverConfig(mode="pallas"), device="cpu").prepare(g)
    assert rep.rebuilds == 1  # the ELL view
    with sanitize.rebuild_guard() as rep:  # memoized on the graph
        SteinerSolver(SolverConfig(mode="frontier"), device="cpu").prepare(g)
    assert rep.rebuilds == 0
    with pytest.raises(sanitize.TraceSafetyError, match="built 1"):
        with sanitize.rebuild_guard(key="view"):
            SteinerSolver(SolverConfig(mode="pallas", ell_width=8), device="cpu").prepare(g)


def test_h2d_guard_counts_copies_onto_a_card_only():
    with sanitize.h2d_guard(allow=0) as rep:
        torch.arange(3).to("cpu", torch.float32)
    assert rep.h2d == 0


# ----------------------------------------------------------------------------
# the mesh memo survives a world the caller re-creates
# ----------------------------------------------------------------------------


def test_mesh_memo_follows_a_recreated_world(monkeypatch):
    import torch.distributed as dist

    from repro_torch.core import mesh as mesh_mod
    from repro_torch.core.mesh import SUM, all_reduce, device_mesh

    # the new WORLD may reuse the dead one's id: make it always do so, so a
    # memo keyed on id(WORLD) serves the dead world's mesh here
    monkeypatch.setattr(mesh_mod, "id", lambda obj: 0, raising=False)
    if not dist.is_initialized():
        device_mesh((1, 1))
    first = device_mesh((1, 1))
    assert device_mesh((1, 1)) is first
    dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    second = device_mesh((1, 1))
    assert second is not first
    out = all_reduce(torch.ones(3), SUM, second.group(("data", "model")))
    assert out.tolist() == [1.0, 1.0, 1.0]
