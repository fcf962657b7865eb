"""Compaction: folding a store's delta log back into a base CSR.

A numpy-only copy of ``repro.delta.compact``: from the same store and log,
both packages write the same compacted store, byte for byte, shards
included.

``compact(store)`` builds a brand-new ``.gstore`` next to the old one by
streaming the EFFECTIVE edge list (base minus deletions, reweights
applied, additions appended: exactly ``GraphStore.iter_coo``) through
the same two-pass builder ingest uses, then atomically swaps directories:

    build  <store>.compact.tmp          (full new store + shards)
    rename <store>   -> <store>.pre-compact
    rename <tmp>     -> <store>
    rmtree <store>.pre-compact

Readers holding open memmaps keep the pre-compact epoch readable
throughout (the rename moves the directory entry, not the mapped inodes);
new ``open_store`` calls see either the complete old store or the
complete new one, never a half-written mix.  The new manifest keeps the
monotonic ``epoch`` but carries no delta segments, so it drops back to
layout revision 1.

Persisted shards are maintained **incrementally**: a shard whose block
contains no changed vertex is byte-identical before and after folding
(modified edges always land in blocks owning a changed endpoint, and
shard content is a deterministic function of each block's own edge
subsequence), so those files are *hardlinked* from the old store,
which keeps their mtimes (tests use them to assert that only changed
blocks were rewritten).  Affected blocks are re-cut from the new CSR with the same
streaming assignment the full partitioners use, so the refreshed
partition is bit-for-bit equal to re-partitioning from scratch.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.delta.log import read_segments
from repro_torch.graphstore.format import StoreWriter
from repro_torch.graphstore.loader import GraphStore, _EffectiveSource

_COMPACT_CHUNK_EDGES = 1 << 20


@dataclasses.dataclass(frozen=True)
class CompactStats:
    """What one compaction folded and what it rewrote."""

    epoch: int
    segments_folded: int
    records_folded: int
    m_before: int
    m_after: int
    seconds: float
    scheme: Optional[str]  # refreshed partition scheme (None = no shards)
    shard_files_total: int
    shard_files_rewritten: int  # the rest were hardlinked, bit-identical


def _iter_csr_chunks(indptr, indices, weights, n, chunk_edges):
    """Directed (src, dst, w) chunks of an in-memory/memmapped CSR."""
    v = 0
    while v < n:
        hi = (
            int(np.searchsorted(indptr, indptr[v] + chunk_edges, side="right"))
            - 1
        )
        v_hi = max(v + 1, min(n, hi))
        e0, e1 = int(indptr[v]), int(indptr[v_hi])
        counts = np.diff(indptr[v : v_hi + 1]).astype(np.int64)
        src = np.repeat(np.arange(v, v_hi, dtype=np.int32), counts)
        yield src, np.asarray(indices[e0:e1]), np.asarray(weights[e0:e1])
        v = v_hi


def _link_or_copy(src: Path, dst: Path) -> None:
    """Hardlink (preserves mtime/inode) with copy fallback (e.g. if the
    filesystem refuses links)."""
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def _register(writer: StoreWriter, stem: str, fields, counts_shape) -> None:
    for (field, dtype), shape in zip(fields, counts_shape):
        writer.register_file(
            f"shard_{stem}_{field}", f"shards/{stem}_{field}.bin", dtype, shape
        )


def _refresh_shards_1d(
    store: GraphStore,
    writer: StoreWriter,
    tmp: Path,
    indptr,
    indices,
    weights,
    aff_blocks: set,
) -> Tuple[dict, int, int]:
    """Incremental 1D (+ELL) shard refresh.  Returns (part_meta, total,
    rewritten) file counts."""
    from repro_torch.graphstore.partition import (
        _ELL_FIELDS,
        _SHARD_FIELDS,
        _append_shard,
        _rank_within_key,
        _shard_stem,
    )

    meta = dict(store.partition_meta)
    R, B, nb = meta["n_replica"], meta["n_blocks"], meta["nb"]
    n = store.n
    old_sh = store.path / "shards"
    new_sh = tmp / "shards"
    new_sh.mkdir(exist_ok=True)
    counts = np.asarray(meta["counts"], np.int64).copy()
    total = rewritten = 0

    aff = np.asarray(sorted(aff_blocks), np.int64)
    for b in aff_blocks:
        counts[:, b] = 0
    if aff.size:
        running = np.zeros(B, np.int64)
        for s, d, w in _iter_csr_chunks(
            indptr, indices, weights, n, _COMPACT_CHUNK_EDGES
        ):
            blk = d.astype(np.int64) // nb
            keep = np.isin(blk, aff)
            if not keep.any():
                continue
            s, d, w, blk = s[keep], d[keep], w[keep], blk[keep]
            # rank-within-block is invariant to dropping other blocks'
            # edges, so this equals the full partitioner's assignment
            rep = _rank_within_key(blk, running) % R
            for r in range(R):
                mr = rep == r
                if not mr.any():
                    continue
                blk_r, s_r, d_r, w_r = blk[mr], s[mr], d[mr], w[mr]
                for b in np.unique(blk_r):
                    mb = blk_r == b
                    _append_shard(
                        new_sh, _shard_stem("1d", r, int(b)),
                        s_r[mb], d_r[mb], w_r[mb],
                    )
                    counts[r, int(b)] += int(mb.sum())

    for (r, b), c in np.ndenumerate(counts):
        if c == 0:
            continue
        stem = _shard_stem("1d", r, b)
        if b in aff_blocks:
            rewritten += len(_SHARD_FIELDS)
        else:
            for field, _ in _SHARD_FIELDS:
                _link_or_copy(
                    old_sh / f"{stem}_{field}.bin", new_sh / f"{stem}_{field}.bin"
                )
        total += len(_SHARD_FIELDS)
        _register(writer, stem, _SHARD_FIELDS, [(int(c),)] * 3)
    meta["counts"] = counts.tolist()
    meta["epoch"] = int(store.epoch)

    if "ell" in meta:
        k = int(meta["ell"]["k"])
        ecounts = np.asarray(meta["ell"]["counts"], np.int64).copy()
        deg = np.diff(np.asarray(indptr)).astype(np.int64)
        rows_per_v = np.maximum(1, -(-deg // k))
        row_off = np.concatenate([[0], np.cumsum(rows_per_v)])
        for b in aff_blocks:
            ecounts[:, b] = 0
        for b in sorted(aff_blocks):
            v0, v1 = b * nb, min((b + 1) * nb, n)
            if v0 >= v1:
                continue
            r0 = int(row_off[v0])
            rows_c = int(row_off[v1]) - r0
            nbr = np.zeros((rows_c, k), np.int32)
            wgt = np.full((rows_c, k), np.inf, np.float32)
            row2v = np.repeat(
                np.arange(v0, v1, dtype=np.int32), rows_per_v[v0:v1]
            )
            e0, e1 = int(indptr[v0]), int(indptr[v1])
            if e1 > e0:
                c = deg[v0:v1]
                edge_v = np.repeat(np.arange(v0, v1, dtype=np.int64), c)
                within = np.arange(e0, e1) - np.repeat(
                    np.asarray(indptr[v0:v1]), c
                )
                flat = (row_off[edge_v] - r0) * k + within
                nbr.reshape(-1)[flat] = indices[e0:e1]
                wgt.reshape(-1)[flat] = weights[e0:e1]
            # replica deal is block-relative row order (matches
            # partition_ell_store on the full graph)
            rep = np.arange(rows_c) % R
            for r in range(R):
                mr = rep == r
                if not mr.any():
                    continue
                stem = _shard_stem("ell", r, int(b))
                for (field, dtype), arr in zip(
                    _ELL_FIELDS, (nbr[mr], wgt[mr], row2v[mr])
                ):
                    with open(new_sh / f"{stem}_{field}.bin", "ab") as h:
                        h.write(
                            np.ascontiguousarray(arr, dtype=dtype).tobytes()
                        )
                ecounts[r, int(b)] += int(mr.sum())
        for (r, b), c in np.ndenumerate(ecounts):
            if c == 0:
                continue
            stem = _shard_stem("ell", r, b)
            if b in aff_blocks:
                rewritten += len(_ELL_FIELDS)
            else:
                for field, _ in _ELL_FIELDS:
                    _link_or_copy(
                        old_sh / f"{stem}_{field}.bin",
                        new_sh / f"{stem}_{field}.bin",
                    )
            total += len(_ELL_FIELDS)
            _register(
                writer, stem, _ELL_FIELDS,
                [(int(c), k), (int(c), k), (int(c),)],
            )
        meta["ell"] = {"k": k, "counts": ecounts.tolist()}
    return meta, total, rewritten


def _refresh_shards_2d(
    store: GraphStore,
    writer: StoreWriter,
    tmp: Path,
    indptr,
    indices,
    weights,
    aff_devices: set,
) -> Tuple[dict, int, int]:
    from repro_torch.graphstore.partition import (
        _SHARD_FIELDS,
        _append_shard,
        _shard_stem,
    )

    meta = dict(store.partition_meta)
    R, C, nf = meta["R"], meta["C"], meta["nf"]
    old_sh = store.path / "shards"
    new_sh = tmp / "shards"
    new_sh.mkdir(exist_ok=True)
    counts = np.asarray(meta["counts"], np.int64).copy()
    total = rewritten = 0

    aff = np.asarray(sorted(aff_devices), np.int64)
    for dv in aff_devices:
        counts[dv] = 0
    if aff.size:
        for s, d, w in _iter_csr_chunks(
            indptr, indices, weights, store.n, _COMPACT_CHUNK_EDGES
        ):
            s64 = s.astype(np.int64)
            d64 = d.astype(np.int64)
            r = np.minimum((s64 // nf) // C, R - 1)
            dev = r * C + (d64 // nf) % C
            keep = np.isin(dev, aff)
            if not keep.any():
                continue
            s, d, w, dev = s[keep], d[keep], w[keep], dev[keep]
            for dv in np.unique(dev):
                md = dev == dv
                _append_shard(
                    new_sh, _shard_stem("2d", int(dv), 0), s[md], d[md], w[md]
                )
                counts[int(dv)] += int(md.sum())

    for dv in range(R * C):
        c = int(counts[dv])
        if c == 0:
            continue
        stem = _shard_stem("2d", dv, 0)
        if dv in aff_devices:
            rewritten += len(_SHARD_FIELDS)
        else:
            for field, _ in _SHARD_FIELDS:
                _link_or_copy(
                    old_sh / f"{stem}_{field}.bin", new_sh / f"{stem}_{field}.bin"
                )
        total += len(_SHARD_FIELDS)
        _register(writer, stem, _SHARD_FIELDS, [(c,)] * 3)
    meta["counts"] = counts.tolist()
    meta["epoch"] = int(store.epoch)
    return meta, total, rewritten


def _affected_devices_2d(store: GraphStore, meta: dict) -> set:
    """Devices touched by any delta record, both stored directions."""
    R, C, nf = meta["R"], meta["C"], meta["nf"]
    devs: set = set()
    for seg in read_segments(store.path, store.manifest):
        u = np.asarray(seg.u, np.int64)
        v = np.asarray(seg.v, np.int64)
        for s, d in ((u, v), (v, u)):
            r = np.minimum((s // nf) // C, R - 1)
            dev = r * C + (d // nf) % C
            devs.update(int(x) for x in np.unique(dev))
    return devs


def compact(store_or_path, *, verify: bool = False) -> CompactStats:
    """Folds the delta log into a fresh base store, in place (atomic swap).

    A no-op (zero-cost) on a store with an empty log.  ``verify``
    re-checks all checksums of the swapped-in store before returning.
    """
    store = (
        store_or_path
        if isinstance(store_or_path, GraphStore)
        else GraphStore(store_or_path, verify=False)
    )
    scheme = (store.partition_meta or {}).get("scheme")
    if store.overlay is None:
        return CompactStats(
            epoch=store.epoch, segments_folded=0, records_folded=0,
            m_before=store.m, m_after=store.m, seconds=0.0,
            scheme=scheme, shard_files_total=0, shard_files_rewritten=0,
        )
    t0 = time.perf_counter()
    path = store.path
    n = store.n
    m_before = store.m
    deltas = store.manifest.get("deltas", ())
    records = sum(int(e["count"]) for e in deltas)
    tmp = path.parent / (path.name + ".compact.tmp")
    backup = path.parent / (path.name + ".pre-compact")
    for stale in (tmp, backup):
        if stale.exists():
            shutil.rmtree(stale)

    with obs.span(
        "delta:compact", store=str(path), epoch=store.epoch,
        segments=len(deltas), records=records,
    ):
        from repro_torch.graphstore.ingest import csr_two_pass

        writer = StoreWriter(tmp)
        indptr_mm = writer.create_array("indptr", np.int64, (n + 1,))

        def alloc(m: int):
            return (
                writer.create_array("indices", np.int32, (m,)),
                writer.create_array("weights", np.float32, (m,)),
            )

        indptr, indices, weights, stats = csr_two_pass(
            n, _EffectiveSource(store), alloc, symmetrize=False
        )
        indptr_mm[...] = indptr
        perm = store.vertex_perm
        if perm is not None:
            writer.put_array("vertex_perm", np.asarray(perm))

        part_meta, total, rewritten = None, 0, 0
        if scheme == "1d":
            nb = int(store.partition_meta["nb"])
            aff = {int(v) // nb for v in np.asarray(store.overlay.changed)}
            part_meta, total, rewritten = _refresh_shards_1d(
                store, writer, tmp, indptr, indices, weights, aff
            )
        elif scheme == "2d":
            aff = _affected_devices_2d(store, store.partition_meta)
            part_meta, total, rewritten = _refresh_shards_2d(
                store, writer, tmp, indptr, indices, weights, aff
            )

        carry = {
            k: v
            for k, v in store.manifest.items()
            if k
            not in (
                "format", "format_version", "arrays", "deltas",
                "partition", "n", "m", "weight_range", "epoch", "compacted",
            )
        }
        writer.set_meta(
            **carry,
            n=n,
            m=int(stats["m_directed"]),
            weight_range=[stats["weight_min"], stats["weight_max"]],
            partition=part_meta,
            epoch=int(store.epoch),
            compacted={
                "at_epoch": int(store.epoch),
                "segments": len(deltas),
                "records": records,
            },
        )
        writer.close()

        # atomic swap: readers with open memmaps keep the old inodes alive
        os.rename(path, backup)
        os.rename(tmp, path)
        shutil.rmtree(backup)

    g = obs.gauge("delta_epoch", "current epoch of the last touched store")
    if g is not None:
        g.set(float(store.epoch))
    epoch = store.epoch
    store.reload(verify=verify)
    return CompactStats(
        epoch=int(epoch),
        segments_folded=len(deltas),
        records_folded=records,
        m_before=m_before,
        m_after=int(stats["m_directed"]),
        seconds=time.perf_counter() - t0,
        scheme=scheme,
        shard_files_total=total,
        shard_files_rewritten=rewritten,
    )
