"""BENCHMARK.json and the files it names: the loader finds every
configuration, traffic mix and metric by name, and the manifest keeps the
contract's shape."""

import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from perfkit import manifest  # noqa: E402

MAN = manifest.load_manifest(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_cell_finds_its_files(cell):
    w = manifest.workload(MAN, cell)
    cfg = manifest.config(MAN, w["config"])
    spec = manifest.traffic(w["traffic"])
    assert cfg["system"] in ("solver", "server") and spec["kind"] in ("closed", "backlog")
    assert callable(manifest.reference(cfg).solve)
    assert set(manifest.limits(cfg)) and all(v == 0 for v in manifest.limits(cfg).values())
    e2e = manifest.cell_metrics(MAN, cell, trace=False)
    layer = manifest.cell_metrics(MAN, cell, trace=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for m in e2e + layer:
        assert callable(manifest.metric_reader(m["name"]))
    for m in layer:
        assert m["moves"] in {x["name"] for x in e2e}


def test_manifest_keeps_the_contract():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["bench"] and MAN["command"] == ["python3", "bench/run.py"]
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in MAN[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert set(c["reduced"]) <= set(json.loads((ROOT / c["file"]).read_text())["reduced"])
    pairs = set()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and "\n" not in m["layer"]
    assert len(json.dumps(MAN)) < 64 * 1024


def test_a_new_cell_needs_new_files_only(tmp_path):
    """A later change adds a configuration, a mix and a metric as files and
    entries; the loader finds them without an edit to any file."""
    bench = tmp_path / "bench"
    for d in ("configs", "traffic", "metrics"):
        (bench / d).mkdir(parents=True)
    cfg = json.loads((ROOT / "bench/configs/lvj1k-single.json").read_text())
    cfg["name"] = "lvj1k-blocked"
    cfg["solver"]["src_block"] = 4096
    (bench / "configs/lvj1k-blocked.json").write_text(json.dumps(cfg))
    (bench / "traffic/closed-s64.json").write_text(json.dumps(
        {"name": "closed-s64", "kind": "closed", "sizes": {"dist": "fixed", "value": 64},
         "check": {"sample": 2, "pool": 8}}))
    (bench / "metrics/layout_builds.blocked.py").write_text("def read(rec):\n    return 1.0\n")
    man = {**MAN, "configs": MAN["configs"] + [
        {"name": "lvj1k-blocked", "source": "x", "file": "bench/configs/lvj1k-blocked.json",
         "reduced": [], "why": "x"}],
        "workloads": MAN["workloads"] + [
        {"name": "lvj1k-blocked-s64", "config": "lvj1k-blocked", "traffic": "closed-s64",
         "chips": 1, "why": "x"}],
        "end_to_end": [dict(m, workloads=m["workloads"] + ["lvj1k-blocked-s64"])
                       if m["name"] == "solve_ms" else m for m in MAN["end_to_end"]],
        "per_layer": MAN["per_layer"] + [
        {"name": "layout_builds.blocked", "unit": "builds", "better": "lower",
         "source": "program_counter", "layer": "solver", "moves": "solve_ms"}]}
    assert manifest.config(man, "lvj1k-blocked", root=tmp_path)["solver"]["src_block"] == 4096
    assert manifest.traffic("closed-s64", bench_dir=bench)["kind"] == "closed"
    assert manifest.metric_reader("layout_builds.blocked", bench_dir=bench)(None) == 1.0
    # a per-layer metric without ``workloads`` is read in every cell that
    # reports what it moves, the new cell's included
    def reports(name, trace):
        return [w["name"] for w in man["workloads"]
                if name in {m["name"] for m in manifest.cell_metrics(man, w["name"], trace)}]

    assert reports("layout_builds.blocked", True) == reports("solve_ms", False)
    assert reports("solve_ms", False)[-1] == "lvj1k-blocked-s64"
    with pytest.raises(KeyError):
        manifest.workload(man, "no-such-cell")
