"""Edge deltas of ``repro_torch`` against ``repro``: the segments each
package appends and the other reads, the folded overlay, the affected-cell
reset, the ELL row surgery, the incremental session epoch by epoch and the
epoch-aware server, all exact.

The port runs on the CPU (its plain PyTorch path); the JAX package runs its
Pallas kernels in interpret mode, as its own tests do.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.delta as jdelta
import repro.graphstore as jgs
from repro.core.voronoi import VoronoiState as JState
from repro.data.graphs import rmat_edges
from repro.serve import ServeConfig as JServeConfig
from repro.serve import SteinerServer as JServer
from _torch_parity import assert_same
from repro_torch import delta as tdelta
from repro_torch import graphstore as tgs
from repro_torch.core.graph import ell_view_cached
from repro_torch.core.voronoi import VoronoiState
from repro_torch.serve import ServeConfig, SteinerServer
from repro_torch.solver import SolverConfig, SteinerSolver

STATE = ("dist", "lab", "pred")


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


def _stores(tmp_path, scale=8, ef=6, seed=3):
    """One RMAT graph written twice (the reference's store and the port's,
    byte-equal): each package mutates its own copy."""
    src, dst, w, n = rmat_edges(scale, ef, seed=seed)
    pj, _ = jgs.build_store(jgs.ArraySource(src, dst, w, n), tmp_path / "j.gstore")
    pt, _ = tgs.build_store(tgs.ArraySource(src, dst, w, n), tmp_path / "t.gstore")
    return src, dst, w, n, pj, pt


def _same_overlay(a, b):
    assert (a.epoch, a.counts) == (b.epoch, b.counts)
    for f in ("removed", "rw_keys", "rw_w", "add_u", "add_v", "add_w", "add_epoch", "changed"):
        assert_same(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_segments_cross_read_and_fold_equal(tmp_path, writer):
    """Segments appended by either package are byte-equal and read by the
    other; the folded overlay and the effective views are equal."""
    src, dst, w, n, pj, pt = _stores(tmp_path)
    rng = np.random.default_rng(7)
    ours, theirs = (pt, pj) if writer == "port" else (pj, pt)
    append = tdelta.append_deltas if writer == "port" else jdelta.append_deltas
    other = jdelta.append_deltas if writer == "port" else tdelta.append_deltas
    for _ in range(3):
        ops = _mixed_ops(rng, n, src, dst, 25)
        a, b = append(ours, ops), other(theirs, ops)
        assert a == b
        assert (ours / a["file"]).read_bytes() == (theirs / b["file"]).read_bytes()
    for path in (pj, pt):
        js, ts = jgs.open_store(path), tgs.open_store(path)
        assert js.manifest == ts.manifest
        _same_overlay(js.overlay, ts.overlay)
        for sa, sb in zip(jdelta.read_segments(path, js.manifest),
                          tdelta.read_segments(path, ts.manifest)):
            assert sa.epoch == sb.epoch
            for f in ("ops", "u", "v", "w"):
                assert_same(getattr(sa, f), getattr(sb, f))
        for x, y in zip(js.effective_csr(), ts.effective_csr()):
            assert_same(x, y)
        assert tdelta.segment_name(3) == jdelta.segment_name(3)


@pytest.mark.parametrize("rec,match", [
    (("move", 0, 1, 1.0), "unknown delta op"),
    (("delete", 0, 1, 2.0), "delete takes"),
    (("add", 0, 1), "add takes"),
    (("add", 0, 1, -1.0), "finite and > 0"),
    (("add", 2, 2, 1.0), "self-loop"),
    (("reweight", 0, 10**6, 1.0), "out of range"),
])
def test_append_validates_records_as_reference(tmp_path, rec, match):
    _, _, _, _, pj, pt = _stores(tmp_path, scale=6, ef=2)
    with pytest.raises(ValueError, match=match):
        jdelta.append_deltas(pj, [rec])
    with pytest.raises(ValueError, match=match):
        tdelta.append_deltas(pt, [rec])
    assert tgs.open_store(pt).epoch == 0  # nothing was appended


def test_delta_segment_crc_and_orphan(tmp_path):
    """A corrupted segment fails verification; an orphan segment the
    manifest does not list is invisible."""
    src, dst, w, n, _, pt = _stores(tmp_path, scale=6, ef=3)
    info = tdelta.append_deltas(pt, _mixed_ops(np.random.default_rng(0), n, src, dst, 5))
    (pt / tdelta.segment_name(9)).write_bytes(b"GDLT junk")
    assert tgs.open_store(pt).epoch == 1
    raw = bytearray((pt / info["file"]).read_bytes())
    raw[-1] ^= 0xFF
    (pt / info["file"]).write_bytes(bytes(raw))
    with pytest.raises(tgs.ChecksumError, match="delta segment"):
        tgs.open_store(pt)


def test_effective_adjacency_matches_reference(tmp_path):
    src, dst, w, n, pj, pt = _stores(tmp_path, scale=7, ef=4)
    ops = _mixed_ops(np.random.default_rng(2), n, src, dst, 30)
    jdelta.append_deltas(pj, ops)
    tdelta.append_deltas(pt, ops)
    verts = np.unique(np.random.default_rng(3).integers(0, n, size=20))
    for a, b in zip(jdelta.effective_adjacency(jgs.open_store(pj), verts),
                    tdelta.effective_adjacency(tgs.open_store(pt), verts)):
        assert_same(a, b)


def _converged(n, path, seeds, cfg):
    out = SteinerSolver(SolverConfig(**cfg), device="cpu").prepare(
        tgs.open_store(path)).solve(seeds)
    return out.raw.state


@pytest.mark.parametrize("trial", range(3))
def test_reset_affected_and_entry_survives_match(tmp_path, trial):
    """The warm state, the affected cells and the reset count equal the
    reference's, on states with unreached vertices and duplicate seeds."""
    src, dst, w, n, _, pt = _stores(tmp_path, scale=7, ef=3, seed=trial)
    rng = np.random.default_rng(trial)
    seeds = rng.choice(n, size=6, replace=False).astype(np.int32)
    seeds[-1] = seeds[0]  # a padded duplicate
    st = _converged(n, pt, seeds, dict(mode="dense", max_iters=2 + trial))  # unreached left
    jst = JState(*(jnp.asarray(getattr(st, f).numpy()) for f in STATE))
    changed = np.unique(rng.integers(0, n, size=4 + 3 * trial))
    jw, jc, jr = jdelta.reset_affected(jst, seeds, changed, len(seeds))
    tw, tc, tr = tdelta.reset_affected(st, seeds, changed, len(seeds))
    assert jr == tr and tr > 0
    assert_same(jc, tc)
    assert_same(jdelta.affected_cells(jst, changed, len(seeds)), tc)
    for f in STATE:
        assert_same(getattr(jw, f), getattr(tw, f))
    lab = st.lab.numpy()
    for ch in (changed, np.nonzero(lab == len(seeds))[0][:3], np.empty(0, np.int64)):
        assert tdelta.entry_survives(lab, ch, len(seeds)) == jdelta.entry_survives(
            lab, ch, len(seeds))
    same, _, zero = tdelta.reset_affected(st, seeds, np.empty(0, np.int64), len(seeds))
    assert same is st and zero == 0


def test_ell_patcher_matches_reference(tmp_path):
    """Patched nbr/wgt/row2v equal the reference's epoch by epoch (spare rows
    claimed for degree growth included); a shared view is copied before the
    first patch; running out of spare rows raises."""
    src, dst, w, n, pj, pt = _stores(tmp_path, scale=7, ef=4)
    js, ts = jgs.open_store(pj, verify=False), tgs.open_store(pt, verify=False)
    jp = jdelta.EllPatcher(js.ell(4, pad_rows_to=64), np.asarray(js.indptr), owns_buffers=True)
    tp = tdelta.EllPatcher(ts.ell(4, pad_rows_to=64, device="cpu"), np.asarray(ts.indptr),
                           owns_buffers=True)
    assert jp.free_rows == tp.free_rows > 0
    rng = np.random.default_rng(1)
    hub = int(np.argmax(np.diff(np.asarray(ts.indptr))))
    for epoch in range(3):
        ops = _mixed_ops(rng, n, src, dst, 10)
        ops += [("add", hub, (hub + 3 + i + 7 * epoch) % n, float(1 + i)) for i in range(6)]
        jdelta.append_deltas(js, ops)
        tdelta.append_deltas(ts, ops)
        changed = np.unique([r[1] for r in ops] + [r[2] for r in ops])
        je, te = jp.apply(js, changed), tp.apply(ts, changed)
        for f in ("nbr", "wgt", "row2v"):
            assert_same(getattr(je, f), getattr(te, f))
        assert jp.free_rows == tp.free_rows
    assert tp.free_rows < 64

    # a shared view (the memoized in-memory one) survives the patch
    g = ts.to_graph(device="cpu")
    shared = ell_view_cached(g, 4)
    before = shared.nbr.clone()
    patched = tdelta.EllPatcher(shared, np.asarray(ts.effective_csr()[0])).apply(
        ts, [hub])
    assert torch.equal(shared.nbr, before) and patched is not shared

    # no spare rows: growth raises instead of aliasing rows
    bare = tdelta.EllPatcher(ts.ell(4, device="cpu"), ts.effective_csr()[0], owns_buffers=True)
    assert bare.free_rows == 0
    grow = [("add", hub, (hub + 40 + i) % n, 1.0) for i in range(8)]
    tdelta.append_deltas(ts, grow)
    with pytest.raises(RuntimeError, match="padding exhausted"):
        bare.apply(ts, np.unique([hub] + [r[2] for r in grow]))


@pytest.mark.parametrize("mst_algo", ["prim", "boruvka"])
def test_incremental_session_matches_reference(tmp_path, mst_algo):
    """Epoch by epoch: the EpochResult, state, MST parent and pair table
    equal the reference session's and the port's own cold frontier solve
    of the mutated store."""
    src, dst, w, n, pj, pt = _stores(tmp_path, scale=8, ef=6)
    rng = np.random.default_rng(0)
    seeds = rng.choice(n, size=16, replace=False).astype(np.int32)
    kw = dict(ell_width=8, ell_pad_rows=256, frontier_size=32, mst_algo=mst_algo)
    js = jdelta.IncrementalSession(jgs.open_store(pj, verify=False), seeds, **kw)
    ts = tdelta.IncrementalSession(tgs.open_store(pt, verify=False), seeds, device="cpu", **kw)
    assert dataclasses.asdict(js.last) == dataclasses.asdict(ts.last)
    cfg = SolverConfig(mode="frontier", ell_width=8, frontier_size=32, mst_algo=mst_algo)
    cold = SteinerSolver(cfg, device="cpu").prepare(tgs.open_store(pt, verify=False))
    for _ in range(3):
        ops = _mixed_ops(rng, n, src, dst, 25)
        a, b = js.apply_deltas(ops), ts.apply_deltas(ops)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert_same(js.dmat, ts.dmat)
        assert_same(js.parent, ts.parent)
        for f in STATE:
            assert_same(getattr(js.state, f), getattr(ts.state, f))
        cold.refresh()
        c = cold.solve(seeds)
        assert (b.total_distance, b.num_edges) == (c.total_distance, c.num_edges)
        assert_same(c.raw.dmat, ts.dmat)
        assert_same(c.raw.parent, ts.parent)
        for f in STATE:
            assert_same(getattr(c.raw.state, f), getattr(ts.state, f))
    with pytest.raises(ValueError, match="unknown mst_algo"):
        tdelta.IncrementalSession(ts.store, seeds, mst_algo="kruskal", device="cpu")


def _served(results):
    return [(r.key, r.bucket, r.total_distance, r.num_edges, r.from_cache) for r in results]


UNTIMED = ("completed", "cache_hits", "cache_entries", "lanes_run", "lanes_padded",
           "batches_per_bucket", "epoch", "cache_invalidations", "cache_revalidations",
           "warm_resolves", "retained_states")


@pytest.mark.parametrize("mode,hub", [("bucket", False), ("pallas", False), ("pallas", True)])
def test_store_server_matches_reference(tmp_path, mode, hub):
    """Two epochs of deltas through the store-backed server: the answers,
    cache hits and revalidation counts equal the reference server's on
    the same store and records (a hub-sorted store too), and every answer
    equals a fresh server's on the mutated store."""
    src, dst, w, n, pj, pt = _stores(tmp_path, scale=8, ef=6, seed=51)
    if hub:
        from repro.graphstore import hub_sort_store

        pj, _ = hub_sort_store(jgs.open_store(pj), tmp_path / "jh.gstore")
        pt, _ = hub_sort_store(jgs.open_store(pt), tmp_path / "th.gstore")
    rng = np.random.default_rng(8)
    qsets = [sorted(rng.choice(n, size=int(rng.integers(3, 12)), replace=False).tolist())
             for _ in range(6)]
    kw = dict(max_batch=4, mode=mode, buckets=(8, 16), state_capacity=4)
    js = JServer(graph_path=str(pj), config=JServeConfig(**kw))
    ts = SteinerServer(graph_path=str(pt), config=ServeConfig(**kw), device="cpu")
    assert _served(js.query_many(qsets)) == _served(ts.query_many(qsets))
    for _ in range(2):
        ops = _mixed_ops(rng, n, src, dst, 20)
        assert js.apply_deltas(ops) == ts.apply_deltas(ops)
        got = ts.query_many(qsets + qsets[:2])
        assert _served(js.query_many(qsets + qsets[:2])) == _served(got)
        sj, st = js.stats(), ts.stats()
        assert {k: sj[k] for k in UNTIMED} == {k: st[k] for k in UNTIMED}
    fresh = SteinerServer(graph_path=str(pt), config=ServeConfig(**kw), device="cpu")
    want = fresh.query_many(qsets)
    assert [(r.total_distance, r.num_edges) for r in got[:len(qsets)]] == [
        (r.total_distance, r.num_edges) for r in want]
    assert st["warm_resolves"] > 0 and st["epoch"] == 2


def test_store_server_revalidates_unaffected_entries(tmp_path):
    """Deltas confined to an unreached component keep the entry (revalidated);
    deltas inside a served cell evict it and re-solve it warm: the
    reference's counts, state for state."""
    n = 18  # a ring over 0..15 and an isolated pair 16-17
    s = np.asarray(list(range(16)) + [16])
    d = np.asarray([(i + 1) % 16 for i in range(16)] + [17])
    w = np.full(s.shape, 2.0, np.float32)
    tgs.build_store(tgs.ArraySource(s, d, w, n), tmp_path / "t.gstore")
    jgs.build_store(jgs.ArraySource(s, d, w, n), tmp_path / "j.gstore")
    kw = dict(max_batch=2, buckets=(4,), mode="bucket")
    ts = SteinerServer(graph_path=str(tmp_path / "t.gstore"), config=ServeConfig(**kw),
                       device="cpu")
    js = JServer(graph_path=str(tmp_path / "j.gstore"), config=JServeConfig(**kw))
    r0 = ts.query([0, 5, 9])
    assert js.query([0, 5, 9]).total_distance == r0.total_distance
    for ops in ([("reweight", 16, 17, 7.0)], [("reweight", 0, 1, 50.0)]):
        assert ts.apply_deltas(ops) == js.apply_deltas(ops)
        a, b = ts.query([0, 5, 9]), js.query([0, 5, 9])
        assert (a.total_distance, a.from_cache) == (b.total_distance, b.from_cache)
    st = ts.stats()
    assert (st["epoch"], st["cache_invalidations"], st["cache_revalidations"],
            st["warm_resolves"]) == (2, 1, 1, 1)
    assert a.total_distance != r0.total_distance
    assert "cache_invalidations_total" in ts.prometheus_text()
    # an externally appended segment: bump_epoch(None) flushes the cache
    tdelta.append_deltas(tmp_path / "t.gstore", [("add", 3, 12, 1.0)])
    rep = ts.bump_epoch()
    assert (rep["epoch"], rep["invalidated"]) == (3, 1)
    assert not ts.query([0, 5, 9]).from_cache


@pytest.mark.parametrize("mode", ["dense", "frontier"])
def test_warm_state_resolve_equals_cold(tmp_path, mode):
    """prepare(store) + refresh + a warm start from reset_affected reaches
    the cold fixpoint bit for bit (as the reference's does)."""
    src, dst, w, n, _, pt = _stores(tmp_path, scale=8, ef=5, seed=33)
    cfg = SolverConfig(backend="single", mode=mode, frontier_size=64)
    store = tgs.open_store(pt, verify=False)
    handle = SteinerSolver(cfg, device="cpu").prepare(store)
    rng = np.random.default_rng(1)
    seeds = rng.choice(n, size=6, replace=False).astype(np.int32)
    cold0 = handle.solve(seeds)
    info = tdelta.append_deltas(store, _mixed_ops(rng, n, src, dst, 25))
    seg = tdelta.read_segment(pt / info["file"], info["epoch"])
    changed = np.unique(np.concatenate([seg.u, seg.v]).astype(np.int64))
    handle.refresh()
    warm0, _, _ = tdelta.reset_affected(cold0.raw.state, seeds, changed, len(seeds))
    warm, cold = handle.solve(seeds, warm_state=warm0), handle.solve(seeds)
    assert warm.total_distance == cold.total_distance
    for f in STATE:
        assert_same(getattr(warm.raw.state, f), getattr(cold.raw.state, f))
    if mode == "frontier":  # a converged init: every row clean, 0 rounds
        st = VoronoiState(*(getattr(cold.raw.state, f) for f in STATE))
        assert handle.solve(seeds, warm_state=st).telemetry.iterations == 0
