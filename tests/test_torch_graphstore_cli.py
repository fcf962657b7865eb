"""``python -m repro_torch.graphstore`` against ``python -m repro.graphstore``.

The port's CLI follows the reference's conventions (one JSON document on
stdout under ``--json``, progress on stderr, nothing on stderr under
``--quiet``, ``--trace``/``--metrics`` dumps) and writes the same stores:
every array file of a store built by either CLI with the same arguments is
byte-identical, and the manifests are equal apart from the timing fields of
``ingest`` (``seconds``, ``edges_per_sec``).  Exact everywhere else.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.graphstore.__main__ import main as jmain
from repro_torch import obs as tobs
from repro_torch.graphstore.__main__ import main as tmain

ROOT = Path(__file__).resolve().parent.parent
TIMING = ("seconds", "edges_per_sec")


@pytest.fixture(autouse=True)
def _fresh_obs():
    tobs.reset()
    yield
    tobs.reset()


def _run(main, capsys, *argv):
    rc = main(list(argv))
    out, err = capsys.readouterr()
    return rc, out, err


def _untimed(doc):
    return {k: v for k, v in doc.items() if k not in TIMING + ("path",)}


def test_json_and_quiet_follow_the_reference(tmp_path, capsys):
    """build, partition (1D with ELL shards, then 2D) and info: one JSON
    document on stdout equal to the reference CLI's (paths and timings
    aside), progress on stderr, and nothing on stderr under --quiet."""
    docs = {}
    for name, main in (("port", tmain), ("reference", jmain)):
        store = str(tmp_path / name / "g.gstore")
        rc, out, err = _run(main, capsys, "--json", "build", store, "--scale", "6",
                            "--edge-factor", "4", "--seed", "2")
        assert rc == 0 and "built" in err
        build = json.loads(out)
        rc, out, err = _run(main, capsys, "--json", "--quiet", "partition", store,
                            "--blocks", "2", "--ell-width", "8")
        assert rc == 0 and err == ""
        part = json.loads(out)
        rc, out, err = _run(main, capsys, "--json", "--quiet", "partition", store,
                            "--scheme", "2d", "--rows", "2", "--cols", "2")
        assert rc == 0 and err == ""
        part2 = json.loads(out)
        rc, out, err = _run(main, capsys, "--json", "--quiet", "info", store)
        assert rc == 0 and err == ""
        info = json.loads(out)
        rc, text, err = _run(main, capsys, "info", store, "--no-verify")
        assert rc == 0 and "partition      : 2d" in text and "checksums      : skipped" in text
        docs[name] = (_untimed(build), _untimed(part), _untimed(part2), _untimed(info),
                      text.replace(store, "STORE"))
    assert docs["port"] == docs["reference"]
    assert docs["port"][1]["shards"] == 2 and docs["port"][1]["ell"]["k"] == 8


def test_trace_and_metrics(tmp_path, capsys):
    """--trace and --metrics of a build: a valid Chrome trace with the
    ingest spans (the same events as the reference CLI's) and a Prometheus
    dump that parses, both accepted by ``python -m repro_torch.obs validate``."""
    from repro_torch.obs.__main__ import main as obs_main

    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.txt"
    rc, out, err = _run(tmain, capsys, "--quiet", "--trace", str(trace), "--metrics",
                        str(metrics), "build", str(tmp_path / "g.gstore"), "--scale", "6",
                        "--edge-factor", "4")
    assert rc == 0 and out == "" and err == ""
    doc = json.loads(trace.read_text())
    assert tobs.validate_chrome_trace(doc) > 0
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"ingest:build_store", "ingest:pass1_degrees", "ingest:pass2_scatter",
            "ingest:chunk"} <= names
    samples = tobs.parse_prometheus(metrics.read_text())
    assert samples["graphstore_ingest_edges_total"] > 0
    assert obs_main(["validate", str(trace), "--metrics", str(metrics),
                     "--require-span", "ingest:build_store"]) == 0
    jtrace = tmp_path / "jtrace.json"
    assert jmain(["--quiet", "--trace", str(jtrace), "build", str(tmp_path / "j.gstore"),
                  "--scale", "6", "--edge-factor", "4"]) == 0

    def events(d):
        return sorted((e["name"], e["ph"], json.dumps({k: v for k, v in e.get("args", {})
                                                       .items() if k != "out"}))
                      for e in d["traceEvents"] if e["ph"] != "M")

    assert events(doc) == events(json.loads(jtrace.read_text()))


def test_append_compact_verify_roundtrip(tmp_path, capsys):
    """append (records file and flags) -> verify -> partition -> compact
    (shards refreshed) -> verify, then a corrupted byte fails verify; the
    reference's CLI on a copy reports the same documents."""
    recs = tmp_path / "recs.json"
    recs.write_text(json.dumps([["add", 1, 2, 3.5], ["delete", 3, 4], ["reweight", 5, 6, 9.0]]))
    docs = {}
    for name, main in (("port", tmain), ("reference", jmain)):
        store = str(tmp_path / name / "g.gstore")
        assert main(["--quiet", "build", store, "--scale", "7", "--edge-factor", "4",
                     "--seed", "3"]) == 0
        assert main(["--quiet", "partition", store, "--blocks", "4", "--ell-width", "8"]) == 0
        capsys.readouterr()
        seq = []
        for argv in (["append", store, "--records", str(recs), "--add", "7", "8", "2.5"],
                     ["verify", store], ["compact", store, "--verify"], ["verify", store]):
            rc, out, err = _run(main, capsys, "--quiet", "--json", *argv)
            assert rc == 0 and err == ""
            seq.append(_untimed(json.loads(out)))
        docs[name] = seq
    assert docs["port"] == docs["reference"]
    append, verify, compact, after = docs["port"]
    assert append["epoch"] == 1 and append["count"] == 4
    assert verify["ok"] and verify["delta_segments"] == 1
    assert compact["records_folded"] == 4 and compact["epoch"] == 1 and compact["scheme"] == "1d"
    assert 0 < compact["shard_files_rewritten"] < compact["shard_files_total"]
    assert after["ok"] and after["delta_segments"] == 0 and after["epoch"] == 1
    store = tmp_path / "port" / "g.gstore"
    for name in ("indices", "weights"):
        assert (store / f"{name}.bin").read_bytes() == (
            tmp_path / "reference" / "g.gstore" / f"{name}.bin").read_bytes()
    with open(store / "weights.bin", "r+b") as h:
        h.seek(64)
        byte = h.read(1)
        h.seek(64)
        h.write(bytes([byte[0] ^ 0xFF]))
    rc, out, err = _run(tmain, capsys, "--quiet", "--json", "verify", str(store))
    assert rc == 1 and json.loads(out)["ok"] is False


@pytest.mark.parametrize("argv", [
    ["append", "{store}"],
    ["partition", "{store}", "--scheme", "2d", "--ell-width", "8"],
    ["build", "{tmp}/x.gstore", "--source", "tsv"],
], ids=["append without records", "2d with ELL width", "tsv without input"])
def test_usage_errors_exit_2_like_the_reference(tmp_path, capsys, argv):
    for main in (tmain, jmain):
        store = tmp_path / ("t" if main is tmain else "j") / "g.gstore"
        assert main(["--quiet", "build", str(store), "--scale", "5", "--edge-factor", "2"]) == 0
        args = [a.format(store=store, tmp=store.parent) for a in argv]
        assert main(["--quiet", *args]) == 2


def test_cli_is_a_host_tool(tmp_path):
    """Every subcommand runs in a process that imports neither torch nor
    JAX nor the reference package: the CLI touches no device."""
    store = str(tmp_path / "g.gstore")
    code = "\n".join([
        "import sys",
        "from repro_torch.graphstore.__main__ import main",
        f"s = {store!r}",
        "for argv in (['build', s, '--scale', '6', '--edge-factor', '4', '--hub-sort'],",
        "             ['info', s], ['partition', s, '--blocks', '2', '--ell-width', '8'],",
        "             ['append', s, '--add', '1', '2', '3.0'], ['compact', s, '--verify'],",
        "             ['verify', s]):",
        "    assert main(['--quiet', *argv]) == 0, argv",
        "bad = [m for m in ('torch', 'jax', 'repro') if m in sys.modules]",
        "assert not bad, bad",
    ])
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert p.returncode == 0, p.stderr


def _cli(module, cwd, *argv):
    p = subprocess.run([sys.executable, "-m", module, *argv], capture_output=True, text=True,
                       cwd=cwd, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                       timeout=300)
    assert p.returncode == 0, p.stderr
    return p


def _files(path):
    return sorted(os.path.relpath(os.path.join(d, f), path)
                  for d, _, fs in os.walk(path) for f in fs)


@pytest.mark.parametrize("source", ["rmat --hub-sort", "tsv"])
def test_cli_built_store_equals_reference(tmp_path, source):
    """``python -m repro_torch.graphstore build`` and ``python -m
    repro.graphstore build`` with the same arguments, as processes: every
    file byte-identical but the manifest, and the manifests equal apart
    from the timing fields of ``ingest``."""
    if source == "tsv":
        edges = tmp_path / "edges.txt"
        edges.write_text("# SNAP header\n0 1 2\n1 2\n  # indented\n2 7 4.5\n7 0\n3 5 1\n")
        args = ["--source", "tsv", "--input", str(edges), "--chunk-edges", "2"]
    else:
        args = ["--scale", "7", "--edge-factor", "4", "--seed", "5", "--hub-sort"]
    out = {}
    for module, name in (("repro_torch.graphstore", "t"), ("repro.graphstore", "j")):
        p = _cli(module, tmp_path, "--json", "build", f"{name}.gstore", *args)
        out[name] = json.loads(p.stdout)
    stores = ["{}.gstore"] + (["{}.hub.gstore"] if "--hub-sort" in args else [])
    assert ("hub_sorted" in out["t"]) == ("hub_sorted" in out["j"]) == ("--hub-sort" in args)
    for pattern in stores:
        t, j = tmp_path / pattern.format("t"), tmp_path / pattern.format("j")
        assert _files(t) == _files(j)
        for f in _files(t):
            if f != "manifest.json":
                assert (t / f).read_bytes() == (j / f).read_bytes(), f
        mt, mj = (json.loads((x / "manifest.json").read_text()) for x in (t, j))
        if "ingest" in mt:
            for k in TIMING:
                assert isinstance(mt["ingest"].pop(k), float)
                mj["ingest"].pop(k)
        assert mt == mj
