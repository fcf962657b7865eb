"""Compaction and the TSV edge source of ``repro_torch`` against ``repro``.

``compact`` folds a store's delta log into a fresh base CSR: the result
equals a fresh ingest of the final edge set (the reference's own fold
model gives it), equals the reference's ``compact`` of a copy of the same
store byte for byte (every array, every shard, the manifest), refreshes 1D
and 2D shards incrementally with the reference's counts of rewritten and
hardlinked files, and lets stale shards load again.  The overlay, the
compacted store and a fresh ingest answer alike on every backend.

Tolerance: exact everywhere but ``CompactStats.seconds``.  The port runs
on the CPU (its plain PyTorch path).
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

import repro.graphstore as jgs
import repro.solver as jsolver
from repro.data.graphs import rmat_edges
from _torch_parity import assert_same_output
from test_delta import apply_ops_model
from test_torch_store import _mixed_ops
from repro_torch import graphstore as tgs
from repro_torch.graphstore.format import read_manifest
from repro_torch.solver import SolverConfig, SteinerSolver


class _Chunks:
    """An edge source over an explicit, re-iterable chunk list."""

    def __init__(self, n, chunks):
        self.n = int(n)
        self._chunks = chunks
        self.describe = "chunks"

    def __iter__(self):
        yield from self._chunks


def _fresh_ingest(path, n, src, dst, w, ops_segments, chunk_edges):
    """A fresh ingest of the final edge set through the port's build_store,
    in the order compaction streams it: the surviving base edges in the
    base ingest's chunks, then one chunk a segment of surviving additions."""
    base = list(zip(src.tolist(), dst.tolist(), w.tolist()))
    keep, adds = apply_ops_model(base, ops_segments)
    chunks = []
    for lo in range(0, len(base), chunk_edges):
        part = [(u, v, x) for (i, u, v, x) in keep if lo <= i < lo + chunk_edges]
        chunks += [part] if part else []
    chunks += [seg for seg in adds if seg]
    arrays = [tuple(np.asarray(c, dt) for c, dt in zip(zip(*ch), (np.int32, np.int32,
                                                                   np.float32)))
              for ch in chunks]
    p, _ = tgs.build_store(_Chunks(n, arrays), path)
    return tgs.open_store(p, verify=False)


def _csr(store):
    return tuple(np.asarray(a) for a in (store.indptr, store.indices, store.weights))


@pytest.mark.parametrize("trial", range(3))
def test_append_compact_equals_fresh_ingest(tmp_path, trial):
    """Two segments of mixed records appended then compacted: the base CSR
    equals a fresh ingest of the final edges bit for bit, as the effective
    CSR did before compaction; the store verifies and keeps its epoch."""
    src, dst, w, n = rmat_edges(7, 4, seed=trial)
    rng = np.random.default_rng(100 + trial)
    ops = [_mixed_ops(rng, n, src, dst, 25), _mixed_ops(rng, n, src, dst, 15)]
    p, _ = tgs.build_store(tgs.ArraySource(src, dst, w, n, chunk_edges=200),
                           tmp_path / "g.gstore")
    store = tgs.open_store(p, verify=False)
    for seg in ops:
        tgs.append_deltas(store, seg)
    fresh = _fresh_ingest(tmp_path / "fresh.gstore", n, src, dst, w, ops, 200)
    eff = store.effective_csr()
    stats = tgs.compact(store)
    assert store.overlay is None and store.epoch == stats.epoch == 2
    assert (stats.segments_folded, stats.records_folded) == (2, 40)
    assert stats.m_after == store.m == fresh.m
    for a, b, c in zip(_csr(store), _csr(fresh), eff):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert store.manifest["weight_range"] == fresh.manifest["weight_range"]
    assert store.manifest["compacted"] == {"at_epoch": 2, "segments": 2, "records": 40}
    assert store.manifest["format_version"] == 1 and "deltas" not in store.manifest
    tgs.verify_store(store.path)


def _store_files(path):
    return sorted(os.path.relpath(os.path.join(d, f), path)
                  for d, _, fs in os.walk(path) for f in fs)


def _mutated_store(tmp_path, layout, seed=3):
    """A port-written store with ``layout``'s shards and two delta segments."""
    src, dst, w, n = rmat_edges(8, 5, seed=seed)
    p, _ = tgs.build_store(tgs.ArraySource(src, dst, w, n), tmp_path / "base.gstore")
    if layout == "hub-sorted":
        p, _ = tgs.hub_sort_store(tgs.open_store(p), tmp_path / "hub.gstore")
    store = tgs.open_store(p, verify=False)
    if layout == "1d + ell":
        tgs.partition_store(store, n_replica=2, n_blocks=3)
        tgs.partition_ell_store(tgs.open_store(p, verify=False), k=8)
    elif layout == "2d":
        tgs.partition_store_2d(store, R=2, C=2)
    rng = np.random.default_rng(seed)
    for k in (30, 12):
        tgs.append_deltas(p, _mixed_ops(rng, n, src, dst, k), map_ids=False)
    return p


def _stats_untimed(stats):
    return {k: v for k, v in dataclasses.asdict(stats).items() if k != "seconds"}


@pytest.mark.parametrize("layout", ["no shards", "1d + ell", "2d", "hub-sorted"])
def test_compact_bytes_equal_reference(tmp_path, layout):
    """The port's compact and the reference's compact of a copy of the same
    store and log write the same files, byte for byte (arrays, shards,
    vertex_perm), the same manifest and the same stats."""
    p = _mutated_store(tmp_path, layout)
    pj = tmp_path / "ref" / p.name
    shutil.copytree(p, pj)
    stats = tgs.compact(p)
    jstats = jgs.compact(pj)
    assert _stats_untimed(stats) == _stats_untimed(jstats)
    files = _store_files(p)
    assert files == _store_files(pj) and "manifest.json" in files
    for f in files:
        assert (p / f).read_bytes() == (pj / f).read_bytes(), f
    assert read_manifest(p) == read_manifest(pj)
    assert not (tmp_path / f"{p.name}.compact.tmp").exists()
    assert not (tmp_path / f"{p.name}.pre-compact").exists()


def _localized_ops(rng, meta, scheme):
    """Records that touch few shards: both endpoints in block 0 (1D), or
    sources in row block 0 and destinations in column block 1 (2D)."""
    if scheme == "1d":
        nb = meta["nb"]
        pairs = [(int(u), int(v) if v != u else (int(v) + 1) % nb)
                 for u, v in rng.integers(0, nb, size=(20, 2))]
    else:
        nf = meta["nf"]
        pairs = [(int(rng.integers(0, nf)), int(rng.integers(nf, 2 * nf))) for _ in range(10)]
    return [("add", u, v, 3.0) for u, v in pairs]


@pytest.mark.parametrize("scheme", ["1d", "2d"])
def test_shards_refreshed_incrementally(tmp_path, scheme):
    """Deltas local to a few blocks: compact rewrites only their shards (the
    reference's counts), hardlinks the rest (mtimes kept), and every shard
    equals a from-scratch partition of the compacted CSR."""
    src, dst, w, n = rmat_edges(9, 6, seed=11)
    p, _ = tgs.build_store(tgs.ArraySource(src, dst, w, n), tmp_path / "g.gstore")
    store = tgs.open_store(p, verify=False)
    if scheme == "1d":
        tgs.partition_store(store, n_replica=2, n_blocks=4)
        tgs.partition_ell_store(tgs.open_store(p, verify=False), k=8)
    else:
        tgs.partition_store_2d(store, R=2, C=2)
    store = tgs.open_store(p, verify=False)
    tgs.append_deltas(store, _localized_ops(np.random.default_rng(3), store.partition_meta,
                                            scheme))
    pj = tmp_path / "ref" / "g.gstore"
    shutil.copytree(p, pj, copy_function=shutil.copy2)
    shards = sorted(f for f in _store_files(p) if f.startswith("shards"))
    mtimes = {f: os.stat(p / f).st_mtime_ns for f in shards}
    stats = tgs.compact(store)
    jstats = jgs.compact(pj)
    assert stats.scheme == scheme
    assert 0 < stats.shard_files_rewritten < stats.shard_files_total
    assert (stats.shard_files_rewritten, stats.shard_files_total) == (
        jstats.shard_files_rewritten, jstats.shard_files_total)
    kept = [f for f in shards if os.stat(p / f).st_mtime_ns == mtimes[f]]
    assert len(kept) == stats.shard_files_total - stats.shard_files_rewritten
    scratch = tmp_path / "scratch.gstore"
    shutil.copytree(p, scratch)
    again = tgs.open_store(scratch, verify=False)
    if scheme == "1d":
        tgs.partition_store(again, n_replica=2, n_blocks=4)
        tgs.partition_ell_store(tgs.open_store(scratch, verify=False), k=8)
    else:
        tgs.partition_store_2d(again, R=2, C=2)
    for f in shards:
        assert (p / f).read_bytes() == (scratch / f).read_bytes() == (pj / f).read_bytes(), f


def test_stale_shards_refused_until_compact(tmp_path):
    """After an append the shards are stale: the loaders refuse them and a
    mesh prepare partitions afresh; after compact they load again (shard
    epoch = store epoch), and both prepares answer alike."""
    src, dst, w, n = rmat_edges(8, 4, seed=6)
    p, _ = tgs.build_store(tgs.ArraySource(src, dst, w, n), tmp_path / "g.gstore")
    tgs.partition_store(tgs.open_store(p, verify=False), n_replica=1, n_blocks=1)
    store = tgs.open_store(p, verify=False)
    tgs.append_deltas(store, [("add", 0, 1, 2.0), ("delete", int(src[0]), int(dst[0]))])
    assert not store.partition_fresh
    with pytest.raises(tgs.StoreFormatError, match="predate the delta log"):
        tgs.load_partition(store)
    cfg = SolverConfig(backend="mesh1d", mode="bucket", mesh_shape=(1, 1))
    seeds = np.array([0, 5, 9, 17], np.int32)
    before = SteinerSolver(cfg, device="cpu").prepare(store)
    assert before.artifact("from_shards") is False
    tgs.compact(store)
    assert store.partition_fresh and store.partition_meta["epoch"] == 1
    assert tgs.load_partition(store).n == n
    after = SteinerSolver(cfg, device="cpu").prepare(tgs.open_store(p, verify=False))
    assert after.artifact("from_shards") is True
    assert_same_output(before.solve(seeds), after.solve(seeds))


BACKENDS = [
    ("single", {}),
    ("batch", {"batch_size": 2}),
    ("mesh1d", {"mesh_shape": (1, 1)}),
    ("mesh2d", {"mesh_shape": (1, 1)}),
]


@pytest.fixture(scope="module")
def parity_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compact_parity")
    src, dst, w, n = rmat_edges(9, 6, seed=21)
    rng = np.random.default_rng(42)
    ops = [_mixed_ops(rng, n, src, dst, 120), _mixed_ops(rng, n, src, dst, 80)]
    p, _ = tgs.build_store(tgs.ArraySource(src, dst, w, n), tmp / "g.gstore")
    for seg in ops:
        tgs.append_deltas(p, seg)
    pj = tmp / "ref" / "g.gstore"
    shutil.copytree(p, pj)
    c = tmp / "c.gstore"
    shutil.copytree(p, c)
    tgs.compact(c)
    fresh = _fresh_ingest(tmp / "fresh.gstore", n, src, dst, w, ops, 1 << 16)
    seeds = rng.choice(n, size=8, replace=False).astype(np.int32)
    return p, c, fresh.path, pj, seeds


@pytest.mark.parametrize("backend,kw", BACKENDS, ids=[b for b, _ in BACKENDS])
def test_overlay_compacted_and_fresh_answer_alike(parity_setup, backend, kw):
    """The overlay (the log replayed at open), the compacted store and a
    fresh ingest of the final edges: the same output bit for bit (state,
    tree, counters, per-round rows), and the reference's totals."""
    p, c, fresh, pj, seeds = parity_setup
    q = np.stack([seeds, seeds[::-1]]) if backend == "batch" else seeds
    cfg = SolverConfig(backend=backend, mode="bucket", **kw)
    overlay = tgs.open_store(p, verify=False)
    assert overlay.overlay is not None
    outs = [SteinerSolver(cfg, device="cpu").prepare(tgs.open_store(x, verify=False)).solve(q)
            for x in (p, c, fresh)]
    assert_same_output(outs[0], outs[1])
    assert_same_output(outs[0], outs[2])
    j = jsolver.SteinerSolver(jsolver.SolverConfig(backend=backend, mode="bucket", **kw))
    jout = j.prepare(jgs.open_store(pj, verify=False)).solve(q)
    np.testing.assert_array_equal(np.asarray(outs[0].num_edges), np.asarray(jout.num_edges))
    np.testing.assert_allclose(np.asarray(outs[0].total_distance, np.float64),
                               np.asarray(jout.total_distance, np.float64), rtol=0, atol=1e-4)


# ----------------------------------------------------------------------------
# TsvEdgeSource
# ----------------------------------------------------------------------------

TSV_FILES = {
    "snap header": "# Directed graph: x.txt\n# Nodes: 6 Edges: 5\n# FromNodeId\tToNodeId\n"
                   "0\t1\n1\t2\n2\t3\n3\t4\n4\t5\n",
    "indented comments and blanks": "0 1 2.5\n   # indented\n\n\t# tabbed\n1 2 4\n  2 3 1.25  \n",
    "missing weights": "0 4\n4 2 7\n2 9\n9 0 3.5\n",
    "no edges": "# only a header\n\n",
}


@pytest.mark.parametrize("chunk_edges", [2, 1 << 16])
@pytest.mark.parametrize("case", list(TSV_FILES))
@pytest.mark.parametrize("given_n", [None, 12])
def test_tsv_source_matches_reference(tmp_path, case, chunk_edges, given_n):
    """The same file through both sources: the same chunks, ``n`` (given or
    discovered in one extra pass), describe string and store bytes."""
    path = tmp_path / "edges.txt"
    path.write_text(TSV_FILES[case])
    kw = dict(n=given_n, default_weight=2.0, chunk_edges=chunk_edges)
    t, j = tgs.TsvEdgeSource(path, **kw), jgs.TsvEdgeSource(path, **kw)
    assert t.describe == j.describe == "tsv(edges.txt)"
    tc, jc = list(t), list(j)
    assert len(tc) == len(jc)
    for a, b in zip(tc, jc):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert t.n == j.n == (given_n if given_n else
                          {"snap header": 6, "indented comments and blanks": 4,
                           "missing weights": 10, "no edges": 0}[case])
    if t.n == 0:
        return
    pt, _ = tgs.build_store(t, tmp_path / "t.gstore")
    pj, _ = jgs.build_store(j, tmp_path / "j.gstore")
    for name in ("indptr", "indices", "weights"):
        assert (pt / f"{name}.bin").read_bytes() == (pj / f"{name}.bin").read_bytes()
