"""Observability of ``repro_torch`` against ``repro``: the trace recorder,
the trace validator and the Prometheus parser give the reference's verdicts
and values; everything is inert while obs is off; switching obs on changes
no result, counter or per-round row; and the traces and metrics that the
solver, the server, ingest, partitioning and the delta log record equal the
reference's, event for event.

Tolerance: exact everywhere.  Timestamps, durations and the samples that
hold seconds are the only fields left out of a comparison (``_events``,
``_untimed``); path-valued span args (``store``, ``out``) are compared by
their last component, since each package writes its own copy of a store.
What only the port records (``PORT_ONLY``) is dropped from both sides
before the comparison; ``test_torch_obs_solve.py`` tests it.
"""

import collections
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.graphstore as jgs
import repro.obs as jobs
import repro.serve as jserve
import repro.solver as jsolver
from _torch_parity import assert_same_output, both_graphs, instance
from repro.data.graphs import rmat_edges
from repro.obs.__main__ import main as jobs_main
from repro_torch import graphstore as tgs
from repro_torch import obs as tobs
from repro_torch.obs import flight as tflight
from repro_torch.obs.__main__ import main as tobs_main
from repro_torch.serve import ServeConfig, SteinerServer
from repro_torch.solver import SolverConfig, SteinerSolver

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _fresh_obs():
    """Every test starts and ends with both recorders disabled and empty."""
    jobs.reset()
    tobs.reset()
    yield
    jobs.reset()
    tobs.reset()


def _arg(k, v):
    return os.path.basename(v) if k in ("store", "out") else v


# Span names and arg keys the port records and the reference does not: the
# solve's child spans, the request id and host-read tally of its ``solve``
# span, and ``synthetic_timing`` on the round spans of mode "pallas" (the
# port stamps the resident schedule's rounds at their host reads).
PORT_ONLY = ("solve:voronoi", "solve:tail", "solve:mst", "req", "host_reads",
             "synthetic_timing")


def _port_only(name, key):
    if key == "synthetic_timing":
        return name.startswith("round[") and name.endswith("/pallas]")
    return key in PORT_ONLY


def _events(tracer):
    """A tracer's events as a multiset of (name, ph, tid, args), without
    ``ts`` and ``dur`` (the process-name metadata is not among them), and
    without the spans and args in ``PORT_ONLY``."""
    out = collections.Counter()
    for e in tracer.events():
        if e["name"] in PORT_ONLY:
            continue
        args = {k: _arg(k, v) for k, v in e.get("args", {}).items()
                if not _port_only(e["name"], k)}
        out[(e["name"], e["ph"], e["tid"], json.dumps(args, sort_keys=True))] += 1
    return out


def _untimed(text):
    """Prometheus samples without those that hold seconds or a rate."""
    return {k: v for k, v in tobs.parse_prometheus(text).items()
            if not (("seconds" in k and "_count" not in k) or "per_sec" in k)}


# ----------------------------------------------------------------------------
# the recorders: the same documents, the same verdicts
# ----------------------------------------------------------------------------


def _tracer_ops(m):
    tr = m.Tracer()
    with tr.span("outer", mode="frontier", rounds=3):
        t0 = tr.now()
        tr.add_instant("checkpoint", epoch=2)
    tr.add_span("retro", t0, tr.now(), tid=1, round=0, synthetic_timing=True)
    tr.add_counter("convergence[x]", tr.now(), {"frontier": 5, "messages": 2.5})
    cm = tr.span("abandoned", k=1)
    cm.__enter__()
    leaked = tr.flush_open_spans()
    evs = sorted((e["name"], e["ph"], e["tid"], e.get("s"), json.dumps(e.get("args"),
                  sort_keys=True)) for e in tr.events())
    return leaked, tr.flush_open_spans(), evs, m.validate_chrome_trace(tr.chrome_trace())


_GOOD_TRACE = {"traceEvents": [
    {"name": "process_name", "ph": "M", "pid": 0, "tid": 0, "args": {"name": "p"}},
    {"name": "a", "ph": "B", "ts": 0.0, "pid": 0, "tid": 0},
    {"name": "x", "ph": "X", "ts": 1.0, "dur": 2.0, "pid": 0, "tid": 1},
    {"name": "c", "ph": "C", "ts": 2, "pid": 0, "tid": 0, "args": {"v": 1.0}},
    {"name": "i", "ph": "i", "s": "t", "ts": 2.5, "pid": 0, "tid": 0},
    {"name": "a", "ph": "E", "ts": 3.0, "pid": 0, "tid": 0}]}

TRACE_DOCS = {
    "good object": _GOOD_TRACE,
    "good array": _GOOD_TRACE["traceEvents"][1:],
    "unknown phase": [{"ph": "Z", "ts": 0.0}],
    "not monotonic": [{"ph": "i", "ts": 5.0}, {"ph": "i", "ts": 1.0}],
    "unclosed B": [{"ph": "B", "ts": 0.0, "name": "x"}],
    "E without B": [{"ph": "E", "ts": 0.0}],
    "B/E on another tid": [{"ph": "B", "ts": 0.0, "tid": 0}, {"ph": "E", "ts": 1.0, "tid": 1}],
    "negative ts": [{"ph": "X", "ts": -1.0, "dur": 1.0}],
    "missing ts": [{"ph": "i"}],
    "negative dur": [{"ph": "X", "ts": 0.0, "dur": -1.0}],
    "event not an object": [3],
    "no traceEvents": {"events": []},
    "neither object nor array": "trace",
}


def _registry_text(m):
    reg = m.MetricsRegistry()
    reg.counter("w_total", "line one\nline two \\ backslash", {"path": 'a\\b"c\nd,}e'}).inc(3)
    reg.gauge("g", "plain", {"x": "comma,brace}"}).set(7)
    reg.counter("solves_total", "completed solves").inc(41)
    h = reg.histogram("lat_seconds", labels={"path": "fresh"})
    h.observe(0.5)
    h.observe(1.5)
    return reg.prometheus_text()


PROM_TEXTS = {
    "a registry's dump": None,
    "labels with escapes": 'x_total{b="q\\"uote",a="back\\\\slash"} 2\n# comment\n\ny 1e3\n',
    "trailing comma": 'x{a="1",} 4\n',
    "not a sample": "this is { not a sample\n",
    "bad value": "x_total twelve\n",
    "empty": "",
}

CASES = (
    [("tracer", None)]
    + [("validate", k) for k in TRACE_DOCS]
    + [("prometheus", k) for k in PROM_TEXTS]
)


def _verdict(fn):
    try:
        return "ok", fn()
    except ValueError as e:
        return "ValueError", str(e)


@pytest.mark.parametrize("kind,case", CASES)
def test_recorders_give_the_reference_verdict(kind, case):
    """Tracer, validate_chrome_trace and parse_prometheus of the port return
    what the reference's return (or raise with its message) on the same
    document."""
    got = {}
    for name, m in (("port", tobs), ("reference", jobs)):
        if kind == "tracer":
            got[name] = _tracer_ops(m)
        elif kind == "validate":
            got[name] = _verdict(lambda: m.validate_chrome_trace(TRACE_DOCS[case]))
        else:
            text = PROM_TEXTS[case]
            text = _registry_text(m) if text is None else text
            got[name] = _verdict(lambda: m.parse_prometheus(text))
    assert got["port"] == got["reference"]
    if kind == "tracer":
        leaked, again, evs, n = got["port"]
        assert leaked == ["abandoned"] and again == [] and n == 5
        assert any('"leaked": true' in e[4] for e in evs)


def test_export_is_atomic_and_valid(tmp_path):
    tr = tobs.Tracer()
    with tr.span("s", n=np.int64(3).item()):
        pass
    path = tmp_path / "t.json"
    tr.export_chrome(str(path))
    doc = json.loads(path.read_text())
    assert tobs.validate_chrome_trace(doc) == 1
    assert doc["traceEvents"][0]["args"] == {"name": "repro_torch"}
    assert list(tmp_path.glob("*.tmp.*")) == []


def test_leaked_span_flushed_at_exit():
    code = ("from repro_torch.obs.trace import Tracer\n"
            "tr = Tracer()\ncm = tr.span('leaky_span')\ncm.__enter__()\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=60)
    assert p.returncode == 0, p.stderr
    assert "repro_torch.obs: flushed 1 span(s)" in p.stderr and "leaky_span" in p.stderr


# ----------------------------------------------------------------------------
# the switch: inert while off, data kept by disable
# ----------------------------------------------------------------------------


def test_disabled_everything_noops_and_disable_keeps_data(tmp_path):
    assert not tobs.enabled() and not tobs.tracing()
    assert tobs.counter("x_total") is None
    assert tobs.gauge("x") is None and tobs.histogram("x_s") is None
    assert tobs.span("a") is tobs.span("b")  # the shared no-op
    with tobs.span("never-recorded"):
        pass
    tobs.add_span("retro", 0.0, 1.0)
    tobs.emit_round_telemetry(np.ones((2, 4)), 0.0, 1.0, label="x")
    assert tobs.prometheus_text() == ""
    assert tobs.export_chrome_trace(str(tmp_path / "t.json")) is False
    assert tobs.registry() is None and tobs.tracer() is None

    tobs.enable()
    tobs.counter("kept_total").inc(5)
    with tobs.span("kept"):
        pass
    tobs.disable()
    assert tobs.counter("kept_total") is None  # no new recording
    with tobs.span("dropped"):
        pass
    assert "kept_total 5" in tobs.registry().prometheus_text()
    assert [e["name"] for e in tobs.tracer().events()] == ["kept"]
    tobs.enable(trace=False)  # an idempotent re-enable keeps both
    assert tobs.counter("kept_total").value == 5 and tobs.tracing()
    assert tobs.export_chrome_trace(str(tmp_path / "t.json")) is True
    tobs.reset()
    assert not tobs.enabled() and tobs.registry() is None


def test_obs_imports_no_torch():
    code = ("import sys\nimport repro_torch.obs, repro_torch.obs.trace, "
            "repro_torch.obs.__main__\nassert 'torch' not in sys.modules, 'torch'\n"
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=60)
    assert p.returncode == 0, p.stderr


# ----------------------------------------------------------------------------
# the solver: obs on changes nothing; its trace is the reference's
# ----------------------------------------------------------------------------

OBS_SPECS = [
    ("single", "dense"),
    ("single", "bucket"),
    ("single", "frontier"),
    ("single", "pallas"),
    ("batch", "bucket"),
    ("mesh1d", "bucket"),
    ("mesh1d", "frontier"),
    ("mesh2d", "bucket"),
]


def _seeds(backend, seeds):
    return np.stack([seeds, np.roll(seeds, 1)]) if backend == "batch" else seeds


@pytest.mark.parametrize("backend,mode", OBS_SPECS)
def test_obs_on_is_bit_identical(backend, mode):
    """The same handle solves with obs off and on: state, tree, counters and
    per-round rows bit for bit, and the solve is recorded, with the port's
    own child spans on the single and batch backends."""
    src, dst, w, n, seeds = instance(1)
    _, g = both_graphs(src, dst, w, n)
    cfg = SolverConfig(backend=backend, mode=mode, mesh_shape=(1, 1))
    handle = SteinerSolver(cfg, device="cpu").prepare(g)
    seeds = _seeds(backend, seeds)
    off = handle.solve(seeds)
    tobs.enable()
    on = handle.solve(seeds)
    assert_same_output(off, on)
    names = {e["name"] for e in tobs.tracer().events()}
    assert {"solve", f"round[{backend}/{mode}]", f"convergence[{backend}/{mode}]"} <= names
    children = {"solve:voronoi", "solve:tail", "solve:mst"}
    assert children & names == (set() if backend.startswith("mesh") else children)
    samples = tobs.parse_prometheus(tobs.prometheus_text())
    key = f'solver_messages_total{{backend="{backend}",mode="{mode}"}}'
    assert samples[key] == on.telemetry.messages


TRACED = [
    dict(backend="single", mode="frontier"),
    dict(backend="single", mode="pallas"),
    dict(backend="batch", mode="bucket"),
    dict(backend="mesh1d", mode="frontier", mesh_shape=(1, 1), ell_width=8,
         frontier_size=32, telemetry_per_rank=True),
]


@pytest.mark.parametrize("kw", TRACED, ids=lambda kw: f"{kw['backend']}-{kw['mode']}")
def test_solve_trace_equals_reference(kw, tmp_path):
    """prepare and solve of the same graph and seeds, traced in both
    packages: the same spans with the same args, the same synthetic round
    spans and convergence (and per-rank) counter values, the same metric
    samples but the solve's seconds; the export passes the validator."""
    src, dst, w, n, seeds = instance(1)
    jg, tg = both_graphs(src, dst, w, n)
    seeds = _seeds(kw["backend"], seeds)
    tobs.enable()
    jobs.enable()
    SteinerSolver(SolverConfig(**kw), device="cpu").prepare(tg).solve(seeds)
    jsolver.SteinerSolver(jsolver.SolverConfig(**kw)).prepare(jg).solve(seeds)
    got, want = _events(tobs.tracer()), _events(jobs.tracer())
    assert got == want
    names = {k[0] for k in got}
    label = f"{kw['backend']}/{kw['mode']}"
    assert {"prepare", "solve", f"round[{label}]", f"convergence[{label}]"} <= names
    if kw.get("telemetry_per_rank"):
        assert f"rank[{label}/0]" in names
    assert _untimed(tobs.prometheus_text()) == _untimed(jobs.prometheus_text())
    path = tmp_path / "trace.json"
    assert tobs.export_chrome_trace(str(path))
    assert tobs.validate_chrome_trace(json.loads(path.read_text())) == len(tobs.tracer())


# ----------------------------------------------------------------------------
# the server
# ----------------------------------------------------------------------------

SERVE = ["serve:queue_wait", "serve:assemble", "serve:solve", "serve:stash", "serve:warmup"]


def test_served_stream_trace_equals_reference():
    """A stream with repeats through both servers, traced: the serve spans
    (one queue wait a ticket), their args, the solves' spans and rounds and
    the untimed samples of both registries equal the reference's."""
    src, dst, w, n = rmat_edges(7, 6, seed=2)
    jg, tg = both_graphs(src, dst, w, n)
    rng = np.random.default_rng(5)
    pool = [rng.choice(n, size=int(k), replace=False).tolist() for k in (3, 5, 9, 4)]
    stream = [pool[i] for i in (0, 1, 0, 2, 3, 1, 2, 0)]
    kw = dict(mode="bucket", buckets=(8, 16), max_batch=2)
    tobs.enable()
    jobs.enable()
    tsrv = SteinerServer(tg, ServeConfig(**kw), device="cpu")
    jsrv = jserve.SteinerServer(jg, jserve.ServeConfig(**kw))
    for srv in (tsrv, jsrv):
        srv.warmup()
        for i in range(0, len(stream), 3):
            for q in stream[i:i + 3]:
                srv.submit(q)
            srv.flush()
    got, want = _events(tobs.tracer()), _events(jobs.tracer())
    assert got == want
    names = collections.Counter(k[0] for k in got.elements())
    assert all(names[s] > 0 for s in SERVE)
    assert names["serve:queue_wait"] == len(stream)
    assert _untimed(tobs.prometheus_text()) == _untimed(jobs.prometheus_text())
    assert _untimed(tsrv.prometheus_text()) == _untimed(jsrv.prometheus_text())


def test_store_backed_server_epoch_trace_equals_reference(tmp_path):
    """A store-backed server through one apply_deltas epoch: the delta,
    refresh, bump and warm re-solve spans and args equal the reference's."""
    src, dst, w, n = rmat_edges(7, 6, seed=4)
    pj, _ = jgs.build_store(jgs.ArraySource(src, dst, w, n), tmp_path / "j" / "g.gstore")
    pt, _ = tgs.build_store(tgs.ArraySource(src, dst, w, n), tmp_path / "t" / "g.gstore")
    rng = np.random.default_rng(9)
    queries = [rng.choice(n, size=5, replace=False).tolist() for _ in range(4)]
    recs = [("add", int(queries[0][0]), int(queries[1][1]), 1.0),
            ("delete", int(src[0]), int(dst[0])),
            ("reweight", int(src[3]), int(dst[3]), 2.0)]
    kw = dict(mode="bucket", buckets=(8,), max_batch=2)
    tobs.enable()
    jobs.enable()
    tsrv = SteinerServer(None, ServeConfig(**kw), graph_path=pt, device="cpu")
    jsrv = jserve.SteinerServer(None, jserve.ServeConfig(**kw), graph_path=pj)
    reports = []
    for srv in (tsrv, jsrv):
        answers = [srv.query(q).total_distance for q in queries]
        reports.append(srv.apply_deltas(recs))
        answers += [srv.query(q).total_distance for q in queries]
        reports.append(answers)
    assert reports[:2] == reports[2:]
    got, want = _events(tobs.tracer()), _events(jobs.tracer())
    assert got == want
    names = {k[0] for k in got}
    assert {"delta:append", "delta:replay", "refresh", "serve:bump_epoch",
            "prepare:materialize"} <= names
    assert _untimed(tobs.prometheus_text()) == _untimed(jobs.prometheus_text())


# ----------------------------------------------------------------------------
# ingest, partitioning, the delta log
# ----------------------------------------------------------------------------


def _store_ops(m, path, src, dst, w, n, case):
    """One store operation of package ``m`` (repro.graphstore or
    repro_torch.graphstore), traced."""
    p, _ = m.build_store(m.ArraySource(src, dst, w, n, chunk_edges=300), path)
    if case == "build":
        return
    store = m.open_store(p)
    if case == "partition 1d + ell":
        m.partition_store(store, n_replica=2, n_blocks=3)
        m.partition_ell_store(m.open_store(p), k=6)
    elif case == "partition 2d":
        m.partition_store_2d(store, R=2, C=2)
    elif case == "hub sort":
        m.hub_sort_store(store, path.parent / "h.gstore")
    elif case == "append, replay, compact":
        m.partition_store(store, n_replica=1, n_blocks=2)
        m.append_deltas(p, [("add", 0, 5, 3.0), ("delete", int(src[1]), int(dst[1]))])
        m.append_deltas(p, [("reweight", int(src[2]), int(dst[2]), 7.0)])
        m.compact(m.open_store(p))


STORE_CASES = ["build", "partition 1d + ell", "partition 2d", "hub sort",
               "append, replay, compact"]


@pytest.mark.parametrize("case", STORE_CASES)
def test_store_ops_trace_equals_reference(tmp_path, case):
    """Ingest (its chunks included), the partitioners, the hub sort, the
    delta log's append and replay and compaction: the same spans, args and
    untimed samples as the reference's."""
    src, dst, w, n = rmat_edges(8, 4, seed=1)
    tobs.enable()
    jobs.enable()
    _store_ops(tgs, tmp_path / "t" / "g.gstore", src, dst, w, n, case)
    _store_ops(jgs, tmp_path / "j" / "g.gstore", src, dst, w, n, case)
    got, want = _events(tobs.tracer()), _events(jobs.tracer())
    assert got == want
    names = {k[0] for k in got}
    assert {"ingest:build_store", "ingest:pass1_degrees", "ingest:pass2_scatter",
            "ingest:chunk"} <= names
    assert _untimed(tobs.prometheus_text()) == _untimed(jobs.prometheus_text())
    assert tobs.parse_prometheus(tobs.prometheus_text())["graphstore_ingest_edges_total"] \
        == len(src)
    assert tobs.validate_chrome_trace(tobs.tracer().chrome_trace()) == sum(got.values())


# ----------------------------------------------------------------------------
# python -m repro_torch.obs
# ----------------------------------------------------------------------------


def _validate_inputs(tmp_path):
    tr = tobs.Tracer()
    with tr.span("build"):
        pass
    trace = tmp_path / "t.json"
    tr.export_chrome(str(trace))
    reg = tobs.MetricsRegistry()
    reg.counter("x_total").inc(2)
    metrics = tmp_path / "m.txt"
    metrics.write_text(reg.prometheus_text())
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([{"ph": "Z", "ts": 0.0}]))
    badm = tmp_path / "bad.txt"
    badm.write_text("not { prometheus\n")
    empty = tmp_path / "empty.txt"
    empty.write_text("")
    per_rank = np.ones((2, 2, 4), np.float32)
    per_rank[1, 0, 1] = 5.0
    good = tmp_path / "flight.json"
    tflight.dump_flight(str(good), per_rank, label="t", per_round=per_rank.sum(axis=1))
    off = tmp_path / "off.json"
    tflight.dump_flight(str(off), per_rank, label="t", per_round=per_rank.sum(axis=1) + 1)
    return {"trace": trace, "metrics": metrics, "bad": bad, "badm": badm, "empty": empty,
            "flight": good, "off": off}


CLI_CASES = [
    ["validate", "{trace}", "--metrics", "{metrics}", "--require-span", "build"],
    ["validate", "{trace}", "--require-span", "nope"],
    ["validate", "{bad}"],
    ["validate", "{trace}", "--metrics", "{badm}"],
    ["validate", "{trace}", "--metrics", "{empty}"],
    ["report", "{flight}"],
    ["report", "{flight}", "--markdown", "--top", "1"],
    ["report", "{flight}", "--label", "other"],
    ["report", "{off}"],
]


@pytest.mark.parametrize("argv", CLI_CASES, ids=lambda a: " ".join(a))
def test_obs_cli_matches_reference(tmp_path, capsys, argv):
    """``python -m repro_torch.obs validate|report`` exits and prints as the
    reference's CLI does on the same files."""
    files = _validate_inputs(tmp_path)
    args = [a.format(**files) for a in argv]
    rc = tobs_main(args)
    out, err = capsys.readouterr()
    jrc = jobs_main(args)
    jout, jerr = capsys.readouterr()
    assert (rc, out, err) == (jrc, jout, jerr)
    assert rc == (0 if argv[1] in ("{trace}", "{flight}") and "nope" not in argv
                  and "{badm}" not in argv and "{empty}" not in argv else 1)
