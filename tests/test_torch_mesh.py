"""The mesh backends of ``repro_torch`` against ``repro`` at
``mesh_shape=(1, 1)``, in process: a world of one rank (gloo on the CPU)
that the backend creates itself, as the reference runs (1, 1) on one
device.  Bit for bit in every field but ``total_distance``, an f32 sum held
to abs 1e-4 (the tolerance of the reference's own parity test)."""

import numpy as np
import pytest
import torch.distributed as dist

import repro.solver as jsolver
from _torch_parity import both_graphs, instance
from repro.data.graphs import rmat_edges
from repro_torch.data.graphs import select_seeds
from repro_torch.obs import flight
from repro_torch.solver import SolverConfig, SteinerSolver

FIELDS = ("dist", "lab", "pred", "marked", "path_edge", "bridge_u", "bridge_v", "bridge_w",
          "bridge_valid")


def solve_both(kw, trial=1, seeds=None, n_seeds=6, graph=None):
    """The same config and inputs through both packages: (port, reference)."""
    src, dst, w, n, sd = instance(trial, n_seeds=n_seeds) if graph is None else graph
    seeds = sd if seeds is None else seeds
    jg, tg = both_graphs(src, dst, w, n)
    out = SteinerSolver(SolverConfig(**kw), device="cpu").prepare(tg).solve(seeds)
    jout = jsolver.SteinerSolver(jsolver.SolverConfig(**kw)).prepare(jg).solve(seeds)
    return out, jout


def assert_mesh_same(out, jout):
    """Every field bit for bit, ``total_distance`` to abs 1e-4."""
    r, q = out.raw, jout.raw
    for f in FIELDS:
        want, got = np.asarray(getattr(q, f)), getattr(r, f)
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("num_edges", "iterations", "relaxations", "messages"):
        assert getattr(r, f) == getattr(q, f), f
    assert abs(r.total_distance - float(q.total_distance)) <= 1e-4
    assert out.num_edges == jout.num_edges
    t, jt = out.telemetry, jout.telemetry
    assert (t.iterations, t.relaxations, t.messages) == (
        jt.iterations, jt.relaxations, jt.messages)
    for f in ("per_round", "per_rank"):
        a, b = getattr(t, f), getattr(jt, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)


SCHEDULES = [
    dict(backend="mesh1d", mode="dense"),
    dict(backend="mesh1d", mode="bucket"),
    dict(backend="mesh1d", mode="frontier", ell_width=4, frontier_size=8),
    dict(backend="mesh2d", mode="bucket"),
]


@pytest.mark.parametrize("trial", [0, 1, 2])  # ER, RMAT, grid
@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: f"{kw['backend']}-{kw['mode']}")
def test_schedules_match_reference(kw, trial):
    assert_mesh_same(*solve_both(kw, trial))


@pytest.mark.parametrize("kw", [
    dict(mode="dense", local_steps=3),
    dict(mode="bucket", local_steps=3),
    dict(mode="bucket", pair_chunks=4),
    dict(mode="dense", pair_chunks=3, mst_algo="boruvka"),
    dict(mode="bucket", fuse_gather=False),
    dict(mode="bucket", lab_i16=True),
    dict(mode="frontier", lab_i16=True, ell_width=4, frontier_size=8),
    dict(mode="bucket", mst_algo="boruvka"),
    dict(mode="bucket", delta=3.0),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_knobs_match_reference(kw):
    assert_mesh_same(*solve_both(dict(backend="mesh1d", **kw), trial=4))


@pytest.mark.parametrize("kw", [
    dict(backend="mesh1d", mode="bucket"),
    dict(backend="mesh1d", mode="frontier", ell_width=4, frontier_size=8),
    dict(backend="mesh2d", mode="dense"),
], ids=lambda kw: f"{kw['backend']}-{kw['mode']}")
def test_per_rank_telemetry_matches_reference(kw):
    out, jout = solve_both(dict(kw, telemetry_rounds=64, telemetry_per_rank=True), trial=3)
    assert_mesh_same(out, jout)
    t = out.telemetry
    assert t.per_rank.shape == (t.per_round.shape[0], 1, 4)
    flight.check_consistency(t.per_rank, t.per_round, label=kw["mode"])
    # the recorder changes nothing else
    base, _ = solve_both(dict(kw, telemetry_rounds=64), trial=3)
    assert base.telemetry.per_rank is None
    np.testing.assert_array_equal(base.telemetry.per_round, t.per_round)
    assert base.raw.edge_set() == out.raw.edge_set()


@pytest.mark.parametrize("kw", [
    dict(backend="mesh1d", mode="bucket", max_iters=3),
    dict(backend="mesh1d", mode="frontier", ell_width=4, frontier_size=2, max_iters=4),
    dict(backend="mesh2d", mode="dense", max_iters=2),
], ids=lambda kw: f"{kw['backend']}-{kw['mode']}")
def test_max_iters_cap(kw):
    out, jout = solve_both(dict(kw, telemetry_rounds=8))
    assert_mesh_same(out, jout)
    assert out.telemetry.iterations == kw["max_iters"]
    assert out.telemetry.per_round.shape == (kw["max_iters"], 4)


@pytest.mark.parametrize("mode", ["bucket", "frontier"])
def test_duplicate_seeds_inert(mode):
    """Seeds padded with duplicates of the first (the serve planner's
    contract): the same answer as the reference's on the padded seeds, and
    the same tree as the unpadded solve."""
    src, dst, w, n, seeds = instance(1, n_seeds=6)
    padded = np.concatenate([seeds, np.full(3, seeds[0], np.int32)])
    kw = dict(backend="mesh1d", mode=mode, ell_width=4, frontier_size=8)
    out, jout = solve_both(kw, seeds=padded)
    assert_mesh_same(out, jout)
    base, _ = solve_both(kw, seeds=seeds)
    assert out.total_distance == base.total_distance
    assert out.num_edges == base.num_edges
    np.testing.assert_array_equal(out.raw.dist, base.raw.dist)
    assert out.raw.edge_set() == base.raw.edge_set()


@pytest.mark.parametrize("mode,counters", [
    ("bucket", (17, 2550, 257061)),
    ("frontier", (10, 2248, 31047)),
])
def test_scale10_fixed_answers(mode, counters):
    """BENCH_steiner.json's mesh rows: total 547.0 and its counters."""
    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    seeds = select_seeds(n, src, dst, 16, strategy="uniform", seed=1000)
    kw = dict(backend="mesh1d", mode=mode, frontier_size=256)
    out, jout = solve_both(kw, graph=(src, dst, w, n, seeds))
    assert out.total_distance == 547.0
    t = out.telemetry
    assert (t.iterations, t.relaxations, t.messages) == counters
    assert_mesh_same(out, jout)


def test_world_of_one_and_mesh_errors():
    """(1, 1) runs on a group of one the backend made; a larger mesh needs
    the caller's process group, with the reference's message."""
    SteinerSolver(SolverConfig(backend="mesh1d"), device="cpu").prepare(
        both_graphs(*instance(0)[:4])[1])
    assert dist.is_initialized() and dist.get_world_size() == 1
    for backend in ("mesh1d", "mesh2d"):
        solver = SteinerSolver(SolverConfig(backend=backend, mesh_shape=(2, 4)), device="cpu")
        with pytest.raises(ValueError, match=r"needs 8 devices, only 1 available"):
            solver.prepare(both_graphs(*instance(0)[:4])[1])
    with pytest.raises(TypeError, match="a Graph or a GraphStore"):
        SteinerSolver(SolverConfig(backend="mesh1d"), device="cpu").prepare(object())
