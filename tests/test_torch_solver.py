"""The solver front door of ``repro_torch`` against ``repro``: the scale-10
fixed answers, telemetry, config parity, every backend, the device policy
and import isolation."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.graph as jgraph
import repro.solver as jsolver
from repro.data.graphs import rmat_edges
from _torch_parity import assert_same, both_graphs, host, instance
from repro_torch.core import graph as tgraph
from repro_torch.data.graphs import select_seeds
from repro_torch.solver import SolverConfig, SteinerSolver, get_backend
from repro_torch.solver.registry import telemetry_from_counts, to_host

SRC = Path(__file__).resolve().parents[1] / "src"


def _scale10():
    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    seeds = select_seeds(n, src, dst, 16, strategy="uniform", seed=1000)
    return src, dst, w, n, seeds


@pytest.mark.parametrize("src_block", [None, 256])
def test_scale10_fixed_answers_and_jax_parity(src_block):
    src, dst, w, n, seeds = _scale10()
    jg, tg = both_graphs(src, dst, w, n, pad_to=8)
    cfg = SolverConfig(backend="single", mode="pallas", src_block=src_block)
    handle = SteinerSolver(cfg, device="cpu").prepare(tg)
    assert tuple(handle.artifact("ell").nbr.shape) == (1360, 32)
    out = handle.solve(seeds)
    assert out.total_distance == 547.0
    assert out.num_edges == 44
    t = out.telemetry
    assert (t.iterations, t.relaxations, t.messages) == (10, 2638, 45912)
    jout = jsolver.SteinerSolver(
        jsolver.SolverConfig(backend="single", mode="pallas", src_block=src_block)
    ).prepare(jg).solve(seeds)
    assert_same(jout.telemetry.per_round, t.per_round)
    for f in ("dist", "lab", "pred"):
        assert_same(getattr(jout.raw.state, f), getattr(out.raw.state, f))
    assert_same(jout.raw.parent, out.raw.parent)
    assert_same(jout.raw.dmat, out.raw.dmat)
    for f in ("path_edge", "bridge_u", "bridge_v", "bridge_w", "bridge_valid"):
        assert_same(getattr(jout.raw.tree, f), getattr(out.raw.tree, f))


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_solve_output_matches_jax(trial):
    src, dst, w, n, seeds = instance(trial, n_seeds=6)
    jg, tg = both_graphs(src, dst, w, n)
    kw = dict(backend="single", mode="pallas", ell_width=4, block_rows=16,
              telemetry_rounds=5)
    out = SteinerSolver(SolverConfig(**kw), device="cpu").prepare(tg).solve(seeds)
    jout = jsolver.SteinerSolver(jsolver.SolverConfig(**kw)).prepare(jg).solve(seeds)
    assert out.total_distance == jout.total_distance
    assert out.num_edges == jout.num_edges
    for f in ("iterations", "relaxations", "messages"):
        assert getattr(out.telemetry, f) == getattr(jout.telemetry, f)
    assert_same(jout.telemetry.per_round, out.telemetry.per_round)
    assert out.telemetry.per_rank is None


def test_non_integer_weights_total_within_f32_tolerance():
    """Sums of non-integer f32 weights differ in order between frameworks;
    everything else stays exact."""
    src, dst, w, n, seeds = instance(4, n_seeds=6)
    w = (w / 7.0 + np.float32(0.1)).astype(np.float32)
    jg, tg = both_graphs(src, dst, w, n)
    kw = dict(backend="single", mode="pallas", ell_width=8)
    out = SteinerSolver(SolverConfig(**kw), device="cpu").prepare(tg).solve(seeds)
    jout = jsolver.SteinerSolver(jsolver.SolverConfig(**kw)).prepare(jg).solve(seeds)
    np.testing.assert_allclose(out.total_distance, jout.total_distance, rtol=1e-6)
    assert out.num_edges == jout.num_edges
    assert_same(jout.raw.state.dist, out.raw.state.dist)
    assert_same(jout.raw.tree.path_edge, out.raw.tree.path_edge)


def test_duplicate_seed_padding_inert():
    src, dst, w, n, seeds = instance(1)
    _, tg = both_graphs(src, dst, w, n)
    cfg = SolverConfig(backend="single", mode="pallas", block_rows=16)
    handle = SteinerSolver(cfg, device="cpu").prepare(tg)
    base = handle.solve(seeds)
    out = handle.solve(np.concatenate([seeds, np.full(3, seeds[0], np.int32)]))
    assert out.total_distance == base.total_distance
    assert out.num_edges == base.num_edges
    assert_same(out.raw.state.lab, base.raw.state.lab)
    assert_same(out.raw.state.dist, base.raw.state.dist)


def test_max_iters_honoured():
    src, dst, w, n, seeds = instance(1)
    _, tg = both_graphs(src, dst, w, n)
    cfg = SolverConfig(backend="single", mode="pallas", block_rows=16, max_iters=2)
    out = SteinerSolver(cfg, device="cpu").prepare(tg).solve(seeds)
    assert int(out.raw.stats.iterations) == out.telemetry.iterations == 2
    assert out.telemetry.per_round.shape == (2, 4)


def test_prepare_moves_graph_and_reuses_ell():
    src, dst, w, n, seeds = instance(0)
    _, tg = both_graphs(src, dst, w, n)
    solver = SteinerSolver(SolverConfig(backend="single", mode="pallas"), device="cpu")
    h1, h2 = solver.prepare(tg), solver.prepare(tg)
    assert h1.artifact("ell") is h2.artifact("ell")
    assert h1.graph is tg and h1.device == torch.device("cpu")
    assert h1.backend == "single" and h1.preprocessing
    with pytest.raises(ValueError, match=r"\(S,\) seeds"):
        h1.solve(np.stack([seeds, seeds]))


@pytest.mark.parametrize("kw,match", [
    (dict(backend="nope"), "unknown backend"),
    (dict(mode="nope"), "unknown mode"),
    (dict(backend="mesh2d", mode="pallas"), "not supported"),
    (dict(mst_algo="kruskal"), "unknown mst_algo"),
    (dict(delta=0.0), "delta"),
    (dict(max_iters=0), "max_iters"),
    (dict(block_rows=0), "block_rows"),
    (dict(mode="pallas", src_block=0), "src_block"),
    (dict(mode="pallas", interpret="yes"), "interpret"),
    (dict(mode="bucket", pallas_frontier=True), "pallas_frontier"),
    (dict(telemetry_rounds=-1), "telemetry_rounds"),
    (dict(telemetry_per_rank=True), "telemetry_per_rank"),
    (dict(mesh_shape=(0, 1)), "mesh_shape"),
    (dict(backend="mesh2d", lab_i16=True), "mesh1d-only"),
])
def test_config_validation_matches_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        jsolver.SolverConfig(**kw)
    with pytest.raises(ValueError, match=match):
        SolverConfig(**kw)


def test_config_fields_and_defaults_match_reference():
    import dataclasses

    jf = {f.name: f.default for f in dataclasses.fields(jsolver.SolverConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(SolverConfig)}
    assert jf == tf
    assert SolverConfig(mode="pallas").replace(src_block=64).src_block == 64


@pytest.mark.parametrize("kw", [
    dict(backend="mesh1d", mode="dense"),
    dict(backend="mesh2d", mode="bucket"),
    dict(backend="mesh1d", mode="frontier", mst_algo="boruvka"),
])
def test_not_ported_raises(kw):
    """The three mesh configs the solver once refused: each now prepares
    and solves at mesh (1, 1), equal to the reference (tests/test_torch_mesh.py
    holds every field; here the front door's outputs)."""
    src, dst, w, n, seeds = instance(1, n_seeds=6)
    jg, tg = both_graphs(src, dst, w, n)
    out = SteinerSolver(SolverConfig(**kw), device="cpu").prepare(tg).solve(seeds)
    jout = jsolver.SteinerSolver(jsolver.SolverConfig(**kw)).prepare(jg).solve(seeds)
    assert abs(out.total_distance - float(jout.total_distance)) <= 1e-4
    assert out.num_edges == int(jout.num_edges)
    assert out.raw.edge_set() == jout.raw.edge_set()
    for f in ("iterations", "relaxations", "messages"):
        assert getattr(out.telemetry, f) == getattr(jout.telemetry, f)
    assert_same(jout.telemetry.per_round, out.telemetry.per_round)


def test_graph_store_input_not_ported():
    """Graph stores are ported (tests/test_torch_store.py); prepare() of
    anything that is neither a Graph nor a GraphStore is refused."""
    solver = SteinerSolver(SolverConfig(backend="single", mode="pallas"), device="cpu")
    with pytest.raises(TypeError, match="a Graph or a GraphStore"):
        solver.prepare(object())


def test_default_device_is_cuda():
    """The default device is the card: without one it raises, never runs on
    the CPU."""
    cfg = SolverConfig(backend="single", mode="pallas")
    if torch.cuda.is_available():
        assert SteinerSolver(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SteinerSolver(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SteinerSolver(cfg, device="cuda:0")


def test_registry_and_host_fetch():
    assert get_backend("single").name == "single"
    assert get_backend("batch").name == "batch"
    assert get_backend("mesh1d").name == "mesh1d"
    assert get_backend("mesh2d").name == "mesh2d"
    with pytest.raises(KeyError, match="unknown backend"):
        get_backend("nope")
    a, b, c, d = to_host(torch.tensor(3, dtype=torch.int32), torch.tensor([1.5, np.inf]),
                         None, torch.tensor([True, False]))
    assert a.dtype == np.int32 and int(a) == 3
    assert b.tolist() == [1.5, np.inf] and c is None and d.dtype == np.bool_
    hist = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    t = telemetry_from_counts(torch.tensor(2, dtype=torch.int32), torch.tensor(5.0),
                              torch.tensor(9.0), hist, 2)
    assert (t.iterations, t.relaxations, t.messages) == (2, 5, 9)
    assert_same(t.per_round, host(hist)[:2])


def test_importing_the_port_loads_no_jax_and_no_repro():
    """Every module of repro_torch imports without jax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15


def test_importing_the_port_server_loads_no_jax_and_no_repro():
    """The serving entry points and the segment-min kernel import without jax
    or the JAX package, as a server process on the card imports them."""
    code = (
        "import sys\n"
        "from repro_torch.serve import SteinerServer, ServeConfig, steiner_tree_batch\n"
        "from repro_torch.kernels.segmin.ops import segmin_bucketed\n"
        "from repro_torch.obs import MetricsRegistry\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(SteinerServer.__module__)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "repro_torch.serve.engine"


def test_to_ell_of_port_matches_reference_for_solver_graph():
    src, dst, w, n, _ = _scale10()
    jg, tg = both_graphs(src, dst, w, n, pad_to=8)
    je, te = jgraph.ell_view_cached(jg, 32), tgraph.ell_view_cached(tg, 32)
    for f in ("nbr", "wgt", "row2v"):
        assert_same(getattr(je, f), getattr(te, f))
