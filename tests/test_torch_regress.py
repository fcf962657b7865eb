"""The port's perf-regression gate (``repro_torch.obs.regress`` and
``python -m repro_torch.obs bench``) against the reference's
(``repro.obs.regress``): the same verdicts and text, cross-read files, the
same pinned inputs and the same deterministic work metric; and the two
public functions ``available_backends`` and ``to_networkx``."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.graph as jgraph
import repro.graphstore.ingest as jingest
import repro.serve as jserve
import repro.solver as jsolver
from _torch_parity import both_graphs
from repro.obs import regress as jregress
from repro_torch.core import graph as tgraph
from repro_torch.obs import regress
from repro_torch.obs.__main__ import main as obs_main
from repro_torch import graphstore as tgs
from repro_torch import serve as tserve
from repro_torch import solver as tsolver

ROOT = Path(__file__).resolve().parents[1]


# ----------------------------------------------------------------------------
# the reference's tests of regress.py, on the port
# ----------------------------------------------------------------------------


def _lo(value, metric="m_lo", mad_samples=None):
    samples = (value,) if mad_samples is None else tuple(mad_samples)
    return regress.MetricResult(metric, "ms", False, samples)


def _hi(value):
    return regress.MetricResult("m_hi", "qps", True, (value,))


def test_regress_compare_thresholds():
    base = {
        "m_lo": {"value": 100.0, "mad": 2.0},
        "m_hi": {"value": 50.0, "mad": 1.0},
    }
    # unknown metrics use the default 1.8 ratio:
    # lower-better limit = max(100·1.8, 100 + 5·2) = 180
    assert regress.compare([_lo(179.0)], base)[0].status == "ok"
    assert regress.compare([_lo(181.0)], base)[0].status == "regress"
    # MAD widens a tight ratio (noise awareness): slack 5·4 = 20 lifts
    # the 1.1-ratio limit from 110 to 120
    noisy = {"m_lo": {"value": 100.0, "mad": 4.0}}
    assert regress.compare([_lo(115.0)], noisy, max_ratio=1.1)[0].status == "ok"
    assert regress.compare([_lo(125.0)], noisy, max_ratio=1.1)[0].status == "regress"
    # ...but the slack is capped at 0.4·baseline: a hugely noisy
    # baseline cannot hide a genuine big regression
    wild = {"m_lo": {"value": 100.0, "mad": 1000.0}}
    assert regress.compare([_lo(141.0)], wild, max_ratio=1.1)[0].status == "regress"
    # higher-better mirror: limit = min(50/1.8, 50 − 5·1) = 27.78
    assert regress.compare([_hi(28.0)], base)[0].status == "ok"
    assert regress.compare([_hi(27.0)], base)[0].status == "regress"
    # missing baseline is reported, never a crash
    v = regress.compare([regress.MetricResult("unknown", "ms", False, (1.0,))], base)[0]
    assert v.status == "missing" and v.baseline is None
    # render covers every verdict shape
    text = regress.render_verdicts(regress.compare([_lo(1.0), _hi(1.0)], base))
    assert "m_lo" in text and "m_hi" in text


def test_regress_median_and_mad():
    r = _lo(0.0, mad_samples=(10.0, 11.0, 14.0))
    assert r.value == 11.0
    assert r.mad == 1.0  # median(|{10,11,14} − 11|) = median{1,0,3}


def test_regress_injection_is_time_derived_only(monkeypatch):
    res = [
        regress.MetricResult("t", "ms", False, (10.0,), time_derived=True),
        regress.MetricResult("q", "qps", True, (100.0,), time_derived=True),
        regress.MetricResult("w", "messages", False, (500.0,), time_derived=False),
    ]
    out = {r.metric: r for r in regress.apply_injection(res, 2.0)}
    assert out["t"].value == 20.0  # latency doubles
    assert out["q"].value == 50.0  # throughput halves
    assert out["w"].value == 500.0  # deterministic work untouched
    assert regress.apply_injection(res, 1.0) == res
    monkeypatch.setenv(regress.INJECT_ENV, "2.5")
    assert regress.injection_factor() == 2.5
    monkeypatch.setenv(regress.INJECT_ENV, "-1")
    with pytest.raises(ValueError):
        regress.injection_factor()


def test_regress_history_and_baseline_files(tmp_path):
    res = [_lo(10.0), _hi(100.0)]
    hist = tmp_path / "h.jsonl"
    assert regress.append_history(hist, res, quick=True, k=1) == 2
    assert regress.append_history(hist, res, quick=True, k=1) == 2
    rows = regress.load_history(hist)
    assert len(rows) == 4  # append-only
    assert rows[0]["metric"] == "m_lo" and rows[0]["value"] == 10.0
    assert "platform" in rows[0]["env"]
    base = tmp_path / "b.json"
    regress.write_baseline(base, res)
    bl = regress.load_baseline(base)
    assert bl["m_lo"]["value"] == 10.0
    assert bl["m_hi"]["higher_is_better"] is True
    assert list(tmp_path.glob("*.tmp.*")) == []  # atomic baseline write
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    with pytest.raises(ValueError, match="not a baseline"):
        regress.load_baseline(bad)


def test_bench_cli_gate(tmp_path, monkeypatch):
    def fake(k, quick, device):
        return [regress.MetricResult("steiner_warm_ms_bucket", "ms", False, (10.0,) * k)]

    monkeypatch.setattr(regress, "GROUPS", {"fake": fake})
    hist, base = tmp_path / "h.jsonl", tmp_path / "b.json"
    args = [
        "bench", "--only", "fake", "--k", "3", "--device", "cpu",
        "--history", str(hist), "--baseline", str(base),
    ]
    # no baseline yet: warn-and-pass, unless --strict
    assert obs_main(args) == 0
    assert obs_main(args + ["--strict"]) == 1
    assert obs_main(args + ["--update-baseline"]) == 0
    assert regress.load_baseline(base)["steiner_warm_ms_bucket"]["value"] == 10.0
    # clean pass against its own baseline
    assert obs_main(args) == 0
    # unknown group is an error, not a silent no-op
    assert obs_main(["bench", "--only", "nope", "--device", "cpu", "--history", str(hist),
                     "--baseline", str(base)]) == 1
    # injected 2× slowdown must fire the gate (policy ratio 1.8, mad 0)
    monkeypatch.setenv(regress.INJECT_ENV, "2.0")
    assert obs_main(args) == 1
    rows = regress.load_history(hist)
    assert len(rows) == 5 and rows[-1]["injected"] == 2.0


# ----------------------------------------------------------------------------
# the same names, policy, verdicts and text as the reference
# ----------------------------------------------------------------------------


def test_names_policy_and_defaults_match_reference():
    assert regress.METRIC_POLICY == jregress.METRIC_POLICY
    assert (regress.DEFAULT_Z, regress.INJECT_ENV) == (jregress.DEFAULT_Z, jregress.INJECT_ENV)
    assert sorted(regress.GROUPS) == sorted(jregress.GROUPS)
    assert (regress.DEFAULT_BASELINE, regress.DEFAULT_HISTORY) == (
        "BENCH_BASELINES_TORCH.json", "BENCH_HISTORY_TORCH.jsonl")
    for cls in ("MetricResult", "Verdict"):
        assert ([f.name for f in dataclasses.fields(getattr(regress, cls))]
                == [f.name for f in dataclasses.fields(getattr(jregress, cls))])
    for name in ("compare", "render_verdicts", "injection_factor", "apply_injection",
                 "run_bench", "append_history", "load_history", "write_baseline",
                 "load_baseline", "env_stamp"):
        assert callable(getattr(regress, name))


_VALUES = st.floats(min_value=0.0, max_value=1e6, allow_nan=False, allow_infinity=False)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(
    metric=st.sampled_from(sorted(regress.METRIC_POLICY) + ["m_lo", "unknown"]),
    higher=st.booleans(),
    samples=st.lists(_VALUES, min_size=1, max_size=7),
    base=st.one_of(st.none(), st.tuples(_VALUES, _VALUES)),
    z=st.floats(min_value=0.0, max_value=10.0),
    ratio=st.one_of(st.none(), st.floats(min_value=1.0, max_value=3.0)),
)
def test_compare_and_render_equal_reference(metric, higher, samples, base, z, ratio):
    """Random baselines, MADs, ratios and both directions: equal verdicts
    and byte-equal text from both packages."""
    baselines = {} if base is None else {metric: {"value": base[0], "mad": base[1]}}
    unit = "qps" if higher else "ms"
    mine = regress.compare([regress.MetricResult(metric, unit, higher, tuple(samples))],
                           baselines, z=z, max_ratio=ratio)
    ref = jregress.compare([jregress.MetricResult(metric, unit, higher, tuple(samples))],
                           baselines, z=z, max_ratio=ratio)
    assert [dataclasses.astuple(v) for v in mine] == [dataclasses.astuple(v) for v in ref]
    assert regress.render_verdicts(mine) == jregress.render_verdicts(ref)


# ----------------------------------------------------------------------------
# baselines and histories: either package reads the other's
# ----------------------------------------------------------------------------


def test_baselines_and_histories_cross_read(tmp_path):
    mine = [regress.MetricResult("serve_qps", "qps", True, (3.0, 4.0, 9.0)),
            regress.MetricResult("steiner_warm_ms_pallas", "ms", False, (1.5, 1.0, 2.0))]
    ref = [jregress.MetricResult(*dataclasses.astuple(r)) for r in mine]
    regress.write_baseline(tmp_path / "port.json", mine, device="cpu")
    jregress.write_baseline(tmp_path / "ref.json", ref)
    assert (jregress.load_baseline(tmp_path / "port.json")
            == regress.load_baseline(tmp_path / "ref.json")
            == regress.load_baseline(tmp_path / "port.json"))
    # a gate against either file gives the same verdicts
    for f in ("port.json", "ref.json"):
        assert ([dataclasses.astuple(v) for v in regress.compare(
            mine, jregress.load_baseline(tmp_path / f))]
            == [dataclasses.astuple(v) for v in jregress.compare(
                ref, regress.load_baseline(tmp_path / f))])
    regress.append_history(tmp_path / "h.jsonl", mine, quick=True, k=3, injected=2.0,
                           device="cpu")
    jregress.append_history(tmp_path / "h.jsonl", ref, quick=True, k=3, injected=2.0)
    rows = jregress.load_history(tmp_path / "h.jsonl")
    assert rows == regress.load_history(tmp_path / "h.jsonl") and len(rows) == 4
    port_rows, ref_rows = rows[:2], rows[2:]
    for a, b in zip(port_rows, ref_rows):
        assert a.keys() == b.keys()
        assert ({k: v for k, v in a.items() if k not in ("ts", "env")}
                == {k: v for k, v in b.items() if k not in ("ts", "env")})
        # the reference's env fields (its jax version aside) plus the port's
        assert set(b["env"]) - {"jax"} <= set(a["env"]) and "jax" not in a["env"]
        assert a["env"]["torch"] and a["env"]["device"] == "cpu"


# ----------------------------------------------------------------------------
# the pinned inputs are the reference's
# ----------------------------------------------------------------------------


class _Recorder:
    """Stands in for a package's SteinerSolver, SteinerServer and
    build_store and records what a bench group hands them."""

    def __init__(self):
        self.log = []

    def solver(self):
        rec = self

        class Out:
            total_distance, num_edges = 0.0, 0
            telemetry = type("T", (), {"messages": 0})()

        class Handle:
            def __init__(self, cfg):
                self.cfg = cfg

            def solve(self, seeds):
                rec.log.append(("solve", self.cfg, np.asarray(seeds).tolist()))
                return Out()

        class Solver:
            def __init__(self, cfg, device=None):
                self.cfg = cfg

            def prepare(self, g):
                rec.log.append(("prepare", self.cfg, [np.asarray(x).tolist()
                                                      for x in (g.src, g.dst, g.w)], g.n))
                return Handle(self.cfg)

        return Solver

    def server(self):
        rec = self

        class Server:
            def __init__(self, g, config, device=None):
                rec.log.append(("server", config.buckets, config.max_batch,
                                config.cache_capacity, g.n))

            def warmup(self):
                rec.log.append(("warmup",))

            def submit(self, seeds):
                rec.log.append(("submit", list(seeds)))

            def flush(self):
                rec.log.append(("flush",))

            def stats(self):
                return {"fresh_p50_ms": 1.0}

        return Server

    def build_store(self, source, path):
        chunks = list(source)
        self.log.append(("build_store", source.n, *(np.concatenate([c[i] for c in chunks])
                                                    .tolist() for i in range(3))))
        return Path(path), type("S", (), {"edges_per_sec": 1.0})()


def _cfg_key(cfg):
    return (cfg.backend, cfg.mode, cfg.ell_width, cfg.frontier_size, tuple(cfg.mesh_shape))


def _normalized(log):
    return [(e[0], _cfg_key(e[1]), *e[2:]) if e[0] in ("prepare", "solve") else e
            for e in log]


@pytest.mark.parametrize("group", ["steiner", "serve", "ingest"])
def test_bench_groups_hand_the_reference_inputs(group, monkeypatch):
    """Each group, run with recording stand-ins, hands the port's solver,
    server and store builder what the reference's hands its own: the same
    graph, configs and seeds in the same order, the same pool and Zipf
    stream with the same flushes, the same ingest edges."""
    logs = {}
    for name, mod, sv, srv, ing in (("port", regress, tsolver, tserve, tgs.ingest),
                                    ("ref", jregress, jsolver, jserve, jingest)):
        rec = _Recorder()
        monkeypatch.setattr(sv, "SteinerSolver", rec.solver())
        monkeypatch.setattr(srv, "SteinerServer", rec.server())
        monkeypatch.setattr(ing, "build_store", rec.build_store)
        fn = mod.GROUPS[group]
        for quick in (True, False):
            fn(2, quick, "cpu") if name == "port" else fn(2, quick)
        logs[name] = _normalized(rec.log)
    assert logs["port"] == logs["ref"] and len(logs["port"]) >= 4


def test_pinned_builders_equal_reference():
    """The factored builders: the graph (edge for edge), the seeds, the pool
    and stream, the ingest source."""
    (jg, n), (tg, tn) = jregress._rmat_graph(8), regress._rmat_graph(8, device="cpu")
    assert (n, tn, jg.n) == (256, 256, tg.n)
    for f in ("src", "dst", "w"):
        np.testing.assert_array_equal(np.asarray(getattr(jg, f)), getattr(tg, f).numpy())
    rng = np.random.default_rng(0)
    want = np.sort(rng.choice(n, size=8, replace=False)).astype(np.int32)
    got = regress.pinned_seeds(n)
    assert got.dtype == np.int32 and got.tolist() == want.tolist()
    for nq in (24, 60):
        rng = np.random.default_rng(1)
        pool = [sorted(rng.choice(n, size=6, replace=False).tolist()) for _ in range(8)]
        p = 1.0 / np.arange(1, 9) ** 1.1
        stream = rng.choice(8, size=nq, p=p / p.sum())
        got_pool, got_stream = regress.serve_workload(n, nq)
        assert got_pool == pool and got_stream.tolist() == stream.tolist()
    for quick, scale in ((True, 9), (False, 11)):
        src = regress.ingest_source(quick)
        assert (src.scale, src.edge_factor, src.seed, src.n) == (scale, 8, 0, 1 << scale)


# ----------------------------------------------------------------------------
# the pinned solves and the deterministic work metric
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("mode", regress.STEINER_MODES)
def test_pinned_solves_equal_reference(mode):
    """The pinned bucket, frontier and pallas solves on the CPU: the
    reference's total distance, edge count and counters."""
    jg, _ = jregress._rmat_graph(8)
    tg, n = regress._rmat_graph(8, device="cpu")
    seeds = regress.pinned_seeds(n)
    kw = dict(ell_width=16, frontier_size=256) if mode != "bucket" else {}
    ref = jsolver.SteinerSolver(jsolver.SolverConfig(backend="single", mode=mode, **kw)
                                ).prepare(jg).solve(seeds)
    out = tsolver.SteinerSolver(regress.steiner_config(mode), device="cpu").prepare(tg).solve(
        seeds)
    assert float(out.total_distance) == float(ref.total_distance)
    assert int(out.num_edges) == int(ref.num_edges)
    for f in ("iterations", "relaxations", "messages"):
        assert getattr(out.telemetry, f) == getattr(ref.telemetry, f), f


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """``python -m repro_torch.obs bench --device cpu --quick --k 1 --only
    steiner`` as a process (its mesh1d metric makes a world of its own),
    with ``jax`` and ``repro`` made unimportable ahead of ``src``."""
    tmp = tmp_path_factory.mktemp("bench")
    for pkg in ("jax", "repro"):
        (tmp / "block" / pkg).mkdir(parents=True)
        (tmp / "block" / pkg / "__init__.py").write_text(
            f"raise ImportError('{pkg} is not for the port')\n")
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(tmp / "block"), str(ROOT / "src")])}
    env.pop(regress.INJECT_ENV, None)
    hist, base = tmp / "h.jsonl", tmp / "b.json"
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "bench", "--device", "cpu", "--quick",
         "--k", "1", "--only", "steiner", "--history", str(hist), "--baseline", str(base)],
        capture_output=True, text=True, timeout=240, env=env, cwd=str(tmp))
    return p, hist, base


def test_bench_cli_process_on_the_cpu(cli_run):
    p, hist, base = cli_run
    assert p.returncode == 0, p.stdout + p.stderr
    assert "no baseline file" in p.stderr and not base.exists()  # warn-and-pass
    rows = regress.load_history(hist)
    assert [r["metric"] for r in rows] == [
        "steiner_warm_ms_bucket", "steiner_warm_ms_frontier", "steiner_warm_ms_pallas",
        "steiner_frontier_messages"]
    assert all(r["k"] == 1 and r["quick"] and r["env"]["device"] == "cpu" for r in rows)


def test_frontier_messages_equal_reference_live_solve(cli_run):
    """The port's mesh1d frontier solve at (1, 1) on the CPU counts exactly
    the reference's messages on the pinned graph and seeds."""
    _, hist, _ = cli_run
    got = {r["metric"]: r["value"] for r in regress.load_history(hist)}
    jg, n = jregress._rmat_graph(8)
    cfg = jsolver.SolverConfig(backend="mesh1d", mode="frontier", mesh_shape=(1, 1),
                               ell_width=16, frontier_size=256)
    ref = jsolver.SteinerSolver(cfg).prepare(jg).solve(regress.pinned_seeds(n))
    assert got["steiner_frontier_messages"] == float(ref.telemetry.messages) > 0


def test_default_device_raises_without_a_card(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(regress, "GROUPS", {"fake": lambda k, quick, device: []})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        regress.run_bench(["fake"], k=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        obs_main(["bench", "--only", "fake", "--history", str(tmp_path / "h"),
                  "--baseline", str(tmp_path / "b")])
    assert not (tmp_path / "h").exists()
    assert regress.run_bench(["fake"], k=1, device="cpu") == []


def test_env_stamp_names_torch_and_the_device():
    import torch

    stamp = regress.env_stamp("cpu")
    assert stamp["torch"] == torch.__version__ and stamp["device"] == "cpu"
    assert "jax" not in stamp and "power_limit" not in stamp
    assert set(jregress.env_stamp()) - {"jax"} <= set(stamp)


# ----------------------------------------------------------------------------
# available_backends and to_networkx
# ----------------------------------------------------------------------------


def test_available_backends_equal_reference():
    assert tsolver.available_backends() == jsolver.available_backends() == (
        "batch", "mesh1d", "mesh2d", "single")


def test_to_networkx_equals_reference():
    """A padded graph with parallel edges: the same nodes, edges and (min)
    weights."""
    src = np.array([0, 1, 2, 1, 3, 0, 4], np.int32)
    dst = np.array([1, 2, 3, 0, 4, 1, 0], np.int32)
    w = np.array([5, 3, 2, 4, 7, 9, 1], np.float32)
    jg, tg = both_graphs(src, dst, w, 6, pad_to=16)
    assert tg.num_edges == 16  # padding edges present
    a, b = tgraph.to_networkx(tg), jgraph.to_networkx(jg)
    assert sorted(a.nodes) == sorted(b.nodes) == list(range(6))
    assert (sorted(a.edges(data="weight")) == sorted(b.edges(data="weight"))
            and a[0][1]["weight"] == 4.0 and a.number_of_edges() == 5)
