"""Graph stores of ``repro_torch`` against ``repro``: the ``.gstore`` bytes
each package writes, each reading the other's, the views built from a store
(COO, effective CSR, ELL with spare rows), the integrity errors, and
``prepare``/``refresh`` of a store in every mode, all exact.

The port runs on the CPU (its plain PyTorch path); the JAX package runs its
Pallas kernels in interpret mode, as its own tests do.
"""

import json

import numpy as np
import pytest
import torch

import repro.delta as jdelta
import repro.graphstore as jgs
import repro.solver as jsolver
from repro.data.graphs import er_edges, rmat_edges
from _torch_parity import assert_same
from repro_torch import graphstore as tgs
from repro_torch.core.dist_steiner import partition_edges
from repro_torch.core.graph import from_edges, to_ell
from repro_torch.delta import append_deltas
from repro_torch.kernels.minplus import minplus as tmp
from repro_torch.kernels.minplus.ref import minplus_blocked_torch, minplus_torch
from repro_torch.solver import SolverConfig, SteinerSolver

STATE = ("dist", "lab", "pred")


def _edges(trial):
    if trial == 0:
        return er_edges(60, 0.1, seed=trial)
    return rmat_edges(7, 5, seed=trial)


def _both_stores(tmp_path, src, dst, w, n, **kw):
    """The same source written by each package: (reference path, port path)."""
    pj, _ = jgs.build_store(jgs.ArraySource(src, dst, w, n, **kw), tmp_path / "j.gstore")
    pt, _ = tgs.build_store(tgs.ArraySource(src, dst, w, n, **kw), tmp_path / "t.gstore")
    return pj, pt


def _mixed_ops(rng, n, src, dst, k):
    """k random add/delete/reweight records; deletes and reweights hit base
    pairs."""
    ops = []
    for _ in range(k):
        kind = int(rng.integers(0, 3))
        if kind == 0:
            u, v = (int(x) for x in rng.integers(0, n, size=2))
            ops.append(("add", u, v if u != v else (v + 1) % n, float(rng.integers(1, 50))))
        else:
            i = int(rng.integers(0, len(src)))
            u, v = int(src[i]), int(dst[i])
            ops.append(("delete", u, v) if kind == 1
                       else ("reweight", u, v, float(rng.integers(1, 50))))
    return ops


@pytest.mark.parametrize("trial,chunk_edges,symmetrize", [
    (0, 97, True), (1, 1 << 16, True), (2, 31, False)])
def test_store_bytes_equal_reference(tmp_path, trial, chunk_edges, symmetrize):
    src, dst, w, n = _edges(trial)
    pj, sj = jgs.build_store(jgs.ArraySource(src, dst, w, n, chunk_edges=chunk_edges),
                             tmp_path / "j.gstore", symmetrize=symmetrize)
    pt, st = tgs.build_store(tgs.ArraySource(src, dst, w, n, chunk_edges=chunk_edges),
                             tmp_path / "t.gstore", symmetrize=symmetrize)
    for name in ("indptr", "indices", "weights"):
        assert (pj / f"{name}.bin").read_bytes() == (pt / f"{name}.bin").read_bytes(), name
    mj, mt = (json.loads((p / "manifest.json").read_text()) for p in (pj, pt))
    for key in ("format", "format_version", "n", "m", "symmetric", "weight_range",
                "partition", "source"):
        assert mj[key] == mt[key], key
    assert mj["arrays"] == mt["arrays"]  # files, dtypes, shapes, CRCs
    timed = ("seconds", "edges_per_sec")
    assert {k: v for k, v in vars(sj).items() if k not in timed} == {
        k: v for k, v in vars(st).items() if k not in timed}


def test_rmat_source_store_equals_reference(tmp_path):
    kw = dict(seed=4, chunk_edges=1000, block_edges=512)
    pj, _ = jgs.build_store(jgs.RmatEdgeSource(7, 4, **kw), tmp_path / "j.gstore")
    pt, _ = tgs.build_store(tgs.RmatEdgeSource(7, 4, **kw), tmp_path / "t.gstore")
    for name in ("indptr", "indices", "weights"):
        assert (pj / f"{name}.bin").read_bytes() == (pt / f"{name}.bin").read_bytes(), name
    ref = tgs.csr_from_chunks(1 << 7, tgs.RmatEdgeSource(7, 4, **kw))
    for a, b in zip(ref, tgs.open_store(pt).effective_csr()):
        assert_same(a, b)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_reads_the_others_store(tmp_path, writer):
    """Arrays, COO, effective CSR (with a delta log too), degrees and the
    COO graph agree whichever package wrote the store."""
    src, dst, w, n = _edges(1)
    build = jgs.build_store if writer == "reference" else tgs.build_store
    source = (jgs if writer == "reference" else tgs).ArraySource(src, dst, w, n, chunk_edges=200)
    path, _ = build(source, tmp_path / "g.gstore")
    rng = np.random.default_rng(3)
    for deltas in (False, True):
        if deltas:
            ops = _mixed_ops(rng, n, src, dst, 20)
            (jdelta.append_deltas if writer == "reference" else append_deltas)(path, ops)
        js, ts = jgs.open_store(path), tgs.open_store(path)
        assert (js.n, js.m, js.epoch) == (ts.n, ts.m, ts.epoch)
        for name in ("indptr", "indices", "weights"):
            assert_same(getattr(js, name), getattr(ts, name))
        assert_same(js.degrees(), ts.degrees())
        for a, b in zip(js.coo(), ts.coo()):
            assert_same(a, b)
        for a, b in zip(js.effective_csr(), ts.effective_csr()):
            assert_same(a, b)
        for ca, cb in zip(js.iter_coo(chunk_edges=150), ts.iter_coo(chunk_edges=150)):
            for a, b in zip(ca, cb):
                assert_same(a, b)
        jg, tg = js.to_graph(pad_to=8), ts.to_graph(pad_to=8, device="cpu")
        for f in ("src", "dst", "w"):
            assert_same(getattr(jg, f), getattr(tg, f))


@pytest.mark.parametrize("k,pad_rows", [(4, 1), (8, 64), (32, 7)])
def test_ell_from_store_matches_to_ell(tmp_path, k, pad_rows):
    """The store's ELL fill equals ``to_ell(to_graph())`` of the port and the
    reference's ``store.ell``, spare rows included, with and without a
    delta log."""
    src, dst, w, n = _edges(2)
    pj, pt = _both_stores(tmp_path, src, dst, w, n, chunk_edges=100)
    for deltas in (False, True):
        if deltas:
            ops = _mixed_ops(np.random.default_rng(k), n, src, dst, 15)
            jdelta.append_deltas(pj, ops)
            append_deltas(pt, ops)
        ts = tgs.open_store(pt)
        ell = ts.ell(k, pad_rows_to=pad_rows, device="cpu")
        want = to_ell(ts.to_graph(device="cpu"), k, pad_rows_to=pad_rows)
        jell = jgs.open_store(pj).ell(k, pad_rows_to=pad_rows)
        assert ell.nbr.shape[0] % pad_rows == 0
        for f in ("nbr", "wgt", "row2v"):
            assert torch.equal(getattr(ell, f), getattr(want, f)), f
            assert_same(getattr(jell, f), getattr(ell, f))


def _corrupt_crc(path):
    raw = bytearray((path / "weights.bin").read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    (path / "weights.bin").write_bytes(bytes(raw))


def _truncate(path):
    (path / "indices.bin").write_bytes((path / "indices.bin").read_bytes()[:-8])


def _bad_version(path):
    mf = path / "manifest.json"
    manifest = json.loads(mf.read_text())
    manifest["format_version"] = 999
    mf.write_text(json.dumps(manifest))


@pytest.mark.parametrize("case", ["crc", "truncated", "version", "manifest"])
def test_integrity_errors(tmp_path, case):
    src, dst, w, n = _edges(1)
    path, _ = tgs.build_store(tgs.ArraySource(src, dst, w, n), tmp_path / "g.gstore")
    # the mesh backends' shards load, and are checksummed with the rest
    tgs.partition_store(tgs.open_store(path), n_replica=1, n_blocks=2)
    store = tgs.open_store(path)
    want = partition_edges(*store.coo(), n, n_replica=1, n_blocks=2, symmetrize=False)
    got = store.load_partition()
    for f in ("src", "dst", "w"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    if case == "crc":
        _corrupt_crc(path)
        with pytest.raises(tgs.ChecksumError, match="crc32"):
            tgs.open_store(path)
        with pytest.raises(tgs.ChecksumError):  # verify=False defers it
            tgs.open_store(path, verify=False).verify()
    elif case == "truncated":
        _truncate(path)
        with pytest.raises(tgs.StoreFormatError, match="size"):
            tgs.open_store(path, verify=False).indices
    elif case == "version":
        _bad_version(path)
        with pytest.raises(tgs.StoreFormatError, match="format_version 999"):
            tgs.open_store(path)
    else:
        with pytest.raises(tgs.StoreFormatError, match="no manifest"):
            tgs.open_store(tmp_path / "nope.gstore")


SINGLE_RUNS = [dict(mode="dense"), dict(mode="bucket"), dict(mode="frontier", frontier_size=16),
               dict(mode="pallas"), dict(mode="pallas", pallas_frontier=True, frontier_size=16),
               dict(mode="pallas", mst_algo="boruvka")]


@pytest.fixture(scope="module")
def store_setup(tmp_path_factory):
    src, dst, w, n = rmat_edges(8, 6, seed=11)
    path, _ = tgs.build_store(tgs.ArraySource(src, dst, w, n),
                              tmp_path_factory.mktemp("s") / "g.gstore")
    rng = np.random.default_rng(5)
    seeds = rng.choice(n, size=7, replace=False).astype(np.int32)
    return src, dst, w, n, path, seeds


def _same_output(j, t):
    assert np.array_equal(np.asarray(j.total_distance), np.asarray(t.total_distance))
    assert np.array_equal(np.asarray(j.num_edges), np.asarray(t.num_edges))
    for f in ("iterations", "relaxations", "messages"):
        assert getattr(j.telemetry, f) == getattr(t.telemetry, f), f
    for f in STATE:
        assert_same(getattr(j.raw.state, f), getattr(t.raw.state, f))
    assert_same(j.raw.parent, t.raw.parent)
    assert_same(j.raw.dmat, t.raw.dmat)


@pytest.mark.parametrize("kw", SINGLE_RUNS, ids=lambda kw: "-".join(map(str, kw.values())))
def test_prepare_store_single_matches_reference_and_memory(store_setup, kw):
    src, dst, w, n, path, seeds = store_setup
    cfg = dict(backend="single", ell_width=8, ell_pad_rows=16, **kw)
    j = jsolver.SteinerSolver(jsolver.SolverConfig(**cfg)).prepare(jgs.open_store(path))
    t = SteinerSolver(SolverConfig(**cfg), device="cpu").prepare(tgs.open_store(path))
    assert t.epoch == j.epoch == 0
    assert isinstance(t.artifact("store"), tgs.GraphStore)
    jo, to = j.solve(seeds), t.solve(seeds)
    _same_output(jo, to)
    mem = SteinerSolver(SolverConfig(**cfg), device="cpu").prepare(
        from_edges(src, dst, w, n, device="cpu")).solve(seeds)
    for f in STATE:
        assert_same(getattr(mem.raw.state, f), getattr(to.raw.state, f))
    assert (mem.total_distance, mem.num_edges) == (to.total_distance, to.num_edges)


@pytest.mark.parametrize("mode", ["dense", "bucket", "pallas"])
def test_prepare_store_batch_matches_reference(store_setup, mode):
    src, dst, w, n, path, seeds = store_setup
    batch = np.stack([seeds, (seeds + 1) % n, seeds])
    cfg = dict(backend="batch", mode=mode, ell_width=8, ell_pad_rows=16, batch_size=3)
    jo = jsolver.SteinerSolver(jsolver.SolverConfig(**cfg)).prepare(
        jgs.open_store(path)).solve(batch)
    to = SteinerSolver(SolverConfig(**cfg), device="cpu").prepare(
        tgs.open_store(path)).solve(batch)
    _same_output(jo, to)


def test_store_ell_pad_rows_and_src_block(store_setup):
    """With ``ell_pad_rows`` the store's ELL has spare all-+inf rows, so its
    row count differs from the in-memory view's: a blocked layout built
    from the prepared ELL describes those rows, its plain fold equals the
    kernel's plain version on that ELL, and the answers equal the
    in-memory graph's with and without ``src_block``."""
    src, dst, w, n, path, seeds = store_setup
    cfg = SolverConfig(backend="single", mode="pallas", ell_width=8, ell_pad_rows=64,
                       src_block=64)
    h = SteinerSolver(cfg, device="cpu").prepare(tgs.open_store(path))
    mem = SteinerSolver(cfg, device="cpu").prepare(from_edges(src, dst, w, n, device="cpu"))
    ell, mell = h.artifact("ell"), mem.artifact("ell")
    assert ell.nbr.shape[0] % 64 == 0 and ell.nbr.shape[0] > mell.nbr.shape[0]
    spare = torch.arange(ell.nbr.shape[0]) >= mell.nbr.shape[0]
    assert bool(torch.isinf(ell.wgt[spare]).all()) and not bool(ell.row2v[spare].any())
    # the CPU's plain path reads the ELL: no layout is built here
    assert h.artifact("blocked_layout") is None
    out = h.solve(seeds)
    want = mem.solve(seeds)
    for f in STATE:
        assert_same(getattr(want.raw.state, f), getattr(out.raw.state, f))
    assert (out.total_distance, out.num_edges) == (want.total_distance, want.num_edges)
    st = out.raw.state
    layout = tmp.blocked_layout(ell.nbr, ell.wgt, n, 64)
    assert layout.rows == ell.nbr.shape[0]
    for a, b in zip(minplus_blocked_torch(layout, st.dist, st.lab),
                    minplus_torch(ell.nbr, ell.wgt, st.dist, st.lab)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cfg", [dict(backend="single", mode="bucket"),
                                 dict(backend="single", mode="pallas", ell_pad_rows=32),
                                 dict(backend="batch", mode="pallas", batch_size=2)],
                         ids=["single-bucket", "single-pallas", "batch-pallas"])
def test_refresh_matches_reference(tmp_path, cfg):
    """refresh(): a no-op at the same epoch, then the reference's report and
    answers after an append, equal to a freshly opened store's."""
    src, dst, w, n = rmat_edges(8, 5, seed=31)
    pj, pt = _both_stores(tmp_path, src, dst, w, n)
    j = jsolver.SteinerSolver(jsolver.SolverConfig(**cfg)).prepare(jgs.open_store(pj))
    t = SteinerSolver(SolverConfig(**cfg), device="cpu").prepare(tgs.open_store(pt))
    rng = np.random.default_rng(0)
    seeds = rng.choice(n, size=6, replace=False).astype(np.int32)
    q = seeds if cfg["backend"] == "single" else np.stack([seeds, seeds[::-1]])
    assert t.refresh() == j.refresh()
    ops = _mixed_ops(rng, n, src, dst, 30)
    jdelta.append_deltas(pj, ops)
    append_deltas(pt, ops)
    rj, rt = j.refresh(), t.refresh()
    assert rt == rj and rt["epoch"] == t.epoch == 1
    _same_output(j.solve(q), t.solve(q))
    fresh = SteinerSolver(SolverConfig(**cfg), device="cpu").prepare(tgs.open_store(pt)).solve(q)
    assert np.array_equal(np.asarray(fresh.total_distance), np.asarray(t.solve(q).total_distance))


def test_hub_sorted_store_takes_original_ids(tmp_path):
    """A store hub-sorted by the reference: the port's handle translates
    original seed ids through ``vertex_perm`` as the reference's does."""
    from repro.graphstore import hub_sort_store

    src, dst, w, n = rmat_edges(8, 6, seed=5)
    path, _ = jgs.build_store(jgs.ArraySource(src, dst, w, n), tmp_path / "g.gstore")
    hpath, perm = hub_sort_store(jgs.open_store(path), tmp_path / "h.gstore")
    hub = tgs.open_store(hpath)
    assert np.array_equal(hub.vertex_perm, perm)
    assert np.array_equal(hub.map_ids(np.arange(n)), perm)
    seeds = np.random.default_rng(1).choice(n, size=6, replace=False).astype(np.int32)
    cfg = dict(backend="single", mode="pallas")
    jo = jsolver.SteinerSolver(jsolver.SolverConfig(**cfg)).prepare(
        jgs.open_store(hpath)).solve(seeds)
    th = SteinerSolver(SolverConfig(**cfg), device="cpu").prepare(hub)
    to = th.solve(seeds)
    _same_output(jo, to)
    assert th.solve(torch.from_numpy(seeds)).total_distance == to.total_distance
    plain = SteinerSolver(SolverConfig(**cfg), device="cpu").prepare(
        tgs.open_store(path)).solve(seeds)
    assert plain.total_distance == to.total_distance
