"""The mesh backends' partitions of ``repro_torch`` against ``repro``: the
host partitioners' arrays, the shard files and manifest entries each
package writes (the same bytes), each package loading the other's shards,
the hub sort, stale shards refused, and the mesh solvers prepared from
shards equal to the reference's."""

import json

import numpy as np
import pytest

import repro.core.dist_steiner as jd1
import repro.core.dist_steiner_2d as jd2
import repro.core.graph as jgraph
import repro.graphstore as jgs
import repro.solver as jsolver
from repro.data.graphs import er_edges, rmat_edges
from repro_torch import graphstore as tgs
from repro_torch.core import dist_steiner as td1
from repro_torch.core import dist_steiner_2d as td2
from repro_torch.core.graph import from_edges, to_ell
from repro_torch.delta import append_deltas
from repro_torch.solver import SolverConfig, SteinerSolver

from test_torch_mesh import assert_mesh_same


def _edges(trial):
    if trial == 0:
        return er_edges(60, 0.1, max_weight=9, seed=trial)
    return rmat_edges(7, 5, max_weight=20, seed=trial)


def _same_dataclass(a, b):
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == np.asarray(y).dtype, f
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=f)
        else:
            assert x == y, f


@pytest.mark.parametrize("trial", [0, 1])
@pytest.mark.parametrize("R,B", [(1, 1), (2, 4), (3, 2)])
def test_host_partitioners_match_reference(trial, R, B):
    src, dst, w, n = _edges(trial)
    _same_dataclass(td1.partition_edges(src, dst, w, n, n_replica=R, n_blocks=B),
                    jd1.partition_edges(src, dst, w, n, n_replica=R, n_blocks=B))
    _same_dataclass(td2.partition_edges_2d(src, dst, w, n, R=R, C=B),
                    jd2.partition_edges_2d(src, dst, w, n, R=R, C=B))
    tell = to_ell(from_edges(src, dst, w, n, device="cpu"), 5)
    jell = jgraph.to_ell(jgraph.from_edges(src, dst, w, n), 5)
    _same_dataclass(td1.partition_ell(tell, n_replica=R, n_blocks=B),
                    jd1.partition_ell(jell, n_replica=R, n_blocks=B))


def _both_stores(tmp_path, src, dst, w, n):
    pj, _ = jgs.build_store(jgs.ArraySource(src, dst, w, n), tmp_path / "j.gstore")
    pt, _ = tgs.build_store(tgs.ArraySource(src, dst, w, n), tmp_path / "t.gstore")
    return pj, pt


def _shard_bytes(path):
    return {f.name: f.read_bytes() for f in sorted((path / "shards").glob("*.bin"))}


def _cut(pkg, path, scheme):
    """Writes ``scheme``'s shards with package ``pkg`` (the 1D scheme with
    its ELL shards too); returns the manifest."""
    store = pkg.open_store(path, verify=False)
    if scheme == "1d":
        pkg.partition_store(store, n_replica=2, n_blocks=3, chunk_edges=97)
        pkg.partition_ell_store(pkg.open_store(path, verify=False), k=6, chunk_vertices=17)
    else:
        pkg.partition_store_2d(store, R=2, C=2, chunk_edges=97)
    return json.loads((path / "manifest.json").read_text())


LOADERS = {"1d": ("load_partition", "load_partition_ell"), "2d": ("load_partition_2d",)}


@pytest.mark.parametrize("scheme", ["1d", "2d"])
def test_shards_same_bytes_and_cross_load(tmp_path, scheme):
    src, dst, w, n = _edges(1)
    pj, pt = _both_stores(tmp_path, src, dst, w, n)
    mj, mt = _cut(jgs, pj, scheme), _cut(tgs, pt, scheme)
    assert mj["partition"] == mt["partition"]
    assert mj["arrays"] == mt["arrays"]  # names, shapes, dtypes, CRCs
    assert _shard_bytes(pj) == _shard_bytes(pt)
    # the whole manifest but the ingest's own timing
    for m in (mj, mt):
        m["ingest"].pop("edges_per_sec"), m["ingest"].pop("seconds")
    assert mj == mt
    for loader in LOADERS[scheme]:
        want = getattr(jgs.open_store(pj), loader)()
        # the port reads the reference's shards, the reference the port's
        _same_dataclass(getattr(tgs.open_store(pj), loader)(), want)
        _same_dataclass(getattr(jgs.open_store(pt), loader)(), want)
        _same_dataclass(getattr(tgs.open_store(pt), loader)(), want)
    if scheme == "1d":
        tell = tgs.open_store(pt).ell(6, device="cpu")
        _same_dataclass(td1.partition_ell(tell, n_replica=2, n_blocks=3),
                        tgs.open_store(pt).load_partition_ell())


def test_hub_sort_same_bytes(tmp_path):
    src, dst, w, n = _edges(1)
    pj, pt = _both_stores(tmp_path, src, dst, w, n)
    hj, perm_j = jgs.hub_sort_store(jgs.open_store(pj), tmp_path / "hj.gstore")
    ht, perm_t = tgs.hub_sort_store(tgs.open_store(pt), tmp_path / "ht.gstore")
    np.testing.assert_array_equal(perm_j, perm_t)
    for f in sorted(p.name for p in hj.iterdir()):
        assert (hj / f).read_bytes() == (ht / f).read_bytes(), f


def test_stale_shards_refused(tmp_path):
    src, dst, w, n = _edges(0)
    _, pt = _both_stores(tmp_path, src, dst, w, n)
    tgs.partition_store(tgs.open_store(pt, verify=False), n_replica=1, n_blocks=1)
    store = tgs.open_store(pt, verify=False)
    assert store.partition_fresh
    store.load_partition()
    append_deltas(store, [("add", 0, 1, 2.0)])
    store = tgs.open_store(pt, verify=False)
    assert not store.partition_fresh
    for loader in ("load_partition", "load_partition_2d", "load_partition_ell"):
        with pytest.raises(tgs.StoreFormatError, match="predate the delta log"):
            getattr(store, loader)()
        with pytest.raises(tgs.StoreFormatError, match="predate the delta log"):
            getattr(tgs.partition, loader)(store)
    # the mesh backend partitions the effective graph on the host instead
    solver = SteinerSolver(SolverConfig(backend="mesh1d", mode="bucket"), device="cpu")
    assert solver.prepare(store).artifact("from_shards") is False
    # and re-partitioning makes the shards loadable again
    tgs.partition_store(store, n_replica=1, n_blocks=1)
    store = tgs.open_store(pt, verify=False)
    assert store.partition_fresh
    assert solver.prepare(store).artifact("from_shards") is True


def test_missing_partition_raises(tmp_path):
    src, dst, w, n = _edges(0)
    _, pt = _both_stores(tmp_path, src, dst, w, n)
    store = tgs.open_store(pt)
    with pytest.raises(tgs.StoreFormatError, match="no 1D partition"):
        store.load_partition()
    with pytest.raises(tgs.StoreFormatError, match="no 2D partition"):
        store.load_partition_2d()
    with pytest.raises(tgs.StoreFormatError, match="no 1D ELL partition"):
        store.load_partition_ell()
    with pytest.raises(tgs.StoreFormatError, match="ride the 1D partition"):
        tgs.partition_ell_store(store, k=4)


MESH_RUNS = [dict(backend="mesh1d", mode="bucket"), dict(backend="mesh1d", mode="dense"),
             dict(backend="mesh1d", mode="frontier", ell_width=6, frontier_size=16),
             dict(backend="mesh2d", mode="bucket")]


@pytest.mark.parametrize("kw", MESH_RUNS, ids=lambda kw: f"{kw['backend']}-{kw['mode']}")
def test_mesh_prepare_from_shards_matches_reference(tmp_path, kw):
    """(1, 1) shards of the matching scheme load per shard; the answer
    equals the reference's from its own store, bit for bit."""
    src, dst, w, n = _edges(1)
    pj, pt = _both_stores(tmp_path, src, dst, w, n)
    seeds = np.random.default_rng(7).choice(n, size=6, replace=False).astype(np.int32)
    for pkg, path in ((jgs, pj), (tgs, pt)):
        store = pkg.open_store(path, verify=False)
        if kw["backend"] == "mesh1d":
            pkg.partition_store(store, n_replica=1, n_blocks=1)
            pkg.partition_ell_store(pkg.open_store(path, verify=False), k=6)
        else:
            pkg.partition_store_2d(store, R=1, C=1)
    handle = SteinerSolver(SolverConfig(**kw), device="cpu").prepare(tgs.open_store(pt))
    assert handle.artifact("from_shards") is True
    out = handle.solve(seeds)
    jout = jsolver.SteinerSolver(jsolver.SolverConfig(**kw)).prepare(
        jgs.open_store(pj)).solve(seeds)
    assert_mesh_same(out, jout)
    # the same answer from the in-memory graph (host partition)
    mem = SteinerSolver(SolverConfig(**kw), device="cpu").prepare(
        from_edges(src, dst, w, n, device="cpu")).solve(seeds)
    assert mem.total_distance == out.total_distance and mem.num_edges == out.num_edges
    np.testing.assert_array_equal(mem.raw.dist, out.raw.dist)
