"""Partitioning a stored graph into per-shard files + hub-sort reorder.

A copy of ``repro.graphstore.partition`` (numpy only): both packages write
the same shard files and manifest entries, byte for byte, and each loads
the other's.

Two schemes, each matching its mesh backend bit-for-bit:

* **1D vertex-block** (paper §IV, ``repro_torch.core.dist_steiner.partition_edges``):
  every directed edge goes to the column owning its destination block
  (``dst // nb``), dealt round-robin across replicas within the block.
* **2D edge-grid** (``repro_torch.core.dist_steiner_2d.partition_edges_2d``): device
  ``(r, c)`` owns edges whose source falls in row-block r and whose
  destination's fine block is congruent to c.

Shards are written *streamingly* from the store's CSR edge order —
assignment uses running per-block counters, so the shard contents equal
what the in-memory partitioners produce on the same edge sequence, and
``load_partition``/``load_partition_2d`` rebuild the exact padded
``Partition``/``Partition2D`` the mesh engines consume.  Shard
files hold *global* vertex ids; localization to block-relative
coordinates happens at load, keeping the on-disk shards scheme-agnostic.

The 1D scheme additionally supports **ELL shards**
(:func:`partition_ell_store`): the split-row ELLPACK view bucketed by
*source* vertex block, persisted next to the edge shards so the mesh
frontier mode (``SolverConfig(backend="mesh1d", mode="frontier")``)
loads its per-device priority-queue layout straight off disk —
``load_partition_ell`` rebuilds the exact padded
:class:`~repro_torch.core.dist_steiner.EllPartition` without ever expanding
the edge list on the host.  Re-partitioning (either scheme) drops the
ELL shards: their geometry is derived from the 1D meta.

Hub-sort (:func:`hub_sort_store`) writes a new store whose vertex ids
are ranked by descending degree — the analogue of HavoqGT's hub
delegation, concentrating high-degree rows in the leading blocks — with
the old→new permutation persisted as ``vertex_perm`` so callers can
translate query seeds (``GraphStore.map_ids``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

import numpy as np

from repro_torch.graphstore import format as fmt
from repro_torch.graphstore.format import StoreFormatError, StoreWriter
from repro_torch.graphstore.loader import GraphStore

DEFAULT_CHUNK_EDGES = 1 << 20

_SHARD_FIELDS = (("src", np.int32), ("dst", np.int32), ("w", np.float32))


def _shard_stem(scheme: str, r: int, b: int) -> str:
    return f"{scheme}_r{r}_b{b}"


def _clean_shards(shdir: Path, scheme: str) -> None:
    """Removes a scheme's shard files (re-partitioning appends from zero)."""
    for f in shdir.glob(f"{scheme}_r*_b*_*.bin"):
        f.unlink()


def _append_shard(shdir: Path, stem: str,
                  s: np.ndarray, d: np.ndarray, w: np.ndarray) -> None:
    # open-append-close per call: the fd footprint stays O(1) regardless
    # of shard count (3 * replicas * blocks files would blow the ulimit)
    for (field, dtype), arr in zip(_SHARD_FIELDS, (s, d, w)):
        with open(shdir / f"{stem}_{field}.bin", "ab") as h:
            h.write(np.ascontiguousarray(arr, dtype=dtype).tobytes())


def _drop_manifest_arrays(manifest: dict, prefixes) -> None:
    """Removes stale shard rows — their files were removed by
    ``_clean_shards``, and stale manifest rows would make every later
    ``open_store`` fail checksum verification on missing files."""
    for prefix in prefixes:
        for name in [k for k in manifest["arrays"] if k.startswith(prefix)]:
            del manifest["arrays"][name]


def _add_shard_array(
    store: GraphStore, stem: str, field: str, dtype, shape
) -> None:
    rel = f"shards/{stem}_{field}.bin"
    store.manifest["arrays"][f"shard_{stem}_{field}"] = {
        "file": rel,
        "dtype": np.dtype(dtype).newbyteorder("<").str,
        "shape": [int(s) for s in shape],
        "crc32": fmt.crc32_file(store.path / rel),
    }


def _write_manifest(store: GraphStore) -> None:
    """Atomically rewrites the store manifest (tmp write + replace)."""
    tmp = store.path / (fmt.MANIFEST_NAME + ".tmp")
    tmp.write_text(json.dumps(store.manifest, indent=1, sort_keys=True))
    tmp.replace(store.path / fmt.MANIFEST_NAME)


def _register_shards(
    store: GraphStore, scheme: str, counts: np.ndarray, part_meta: dict
) -> None:
    """Adds shard arrays + the partition block to the store manifest."""
    manifest = store.manifest
    # a fresh edge partition replaces the whole "partition" block, which
    # also carries the ELL-shard meta — drop both sets of stale entries
    _drop_manifest_arrays(manifest, (f"shard_{scheme}_", "shard_ell_"))
    for (r, b), c in np.ndenumerate(counts):
        if c == 0:
            continue
        stem = _shard_stem(scheme, r, b)
        for field, dtype in _SHARD_FIELDS:
            _add_shard_array(store, stem, field, dtype, (c,))
    manifest["partition"] = part_meta
    _write_manifest(store)


def _rank_within_key(key: np.ndarray, running: np.ndarray) -> np.ndarray:
    """Per-edge sequence number within its key, continuing ``running``.

    Updates ``running`` in place with this chunk's key counts.
    """
    o = np.argsort(key, kind="stable")
    ks = key[o]
    run_start = np.r_[0, np.flatnonzero(ks[1:] != ks[:-1]) + 1]
    run_len = np.diff(np.r_[run_start, ks.shape[0]])
    within = np.arange(ks.shape[0]) - np.repeat(run_start, run_len)
    seq = np.empty(key.shape[0], np.int64)
    seq[o] = running[ks] + within
    running += np.bincount(key, minlength=running.shape[0])
    return seq


# ----------------------------------------------------------------------------
# 1D vertex-block partition (paper §IV)
# ----------------------------------------------------------------------------


def partition_store(
    store: GraphStore,
    *,
    n_replica: int,
    n_blocks: int,
    block_multiple: int = 8,
    chunk_edges: int = DEFAULT_CHUNK_EDGES,
) -> dict:
    """Writes 1D dst-block shards into ``<store>/shards/`` and records the
    scheme in the manifest.  Streaming: one edge chunk in flight."""
    nb = -(-store.n // n_blocks)
    nb = -(-nb // block_multiple) * block_multiple
    shdir = store.path / "shards"
    shdir.mkdir(exist_ok=True)
    _clean_shards(shdir, "1d")  # appends must start from empty files
    _clean_shards(shdir, "ell")  # geometry derives from the 1d meta
    counts = np.zeros((n_replica, n_blocks), np.int64)
    running = np.zeros(n_blocks, np.int64)
    for s, d, w in store.iter_coo(chunk_edges):
        blk = d.astype(np.int64) // nb
        rep = _rank_within_key(blk, running) % n_replica
        for r in range(n_replica):
            mr = rep == r
            if not mr.any():
                continue
            blk_r, s_r, d_r, w_r = blk[mr], s[mr], d[mr], w[mr]
            for b in np.unique(blk_r):
                mb = blk_r == b
                _append_shard(
                    shdir, _shard_stem("1d", r, int(b)),
                    s_r[mb], d_r[mb], w_r[mb],
                )
                counts[r, int(b)] += int(mb.sum())
    meta = {
        "scheme": "1d",
        "n_replica": int(n_replica),
        "n_blocks": int(n_blocks),
        "nb": int(nb),
        "block_multiple": int(block_multiple),
        "counts": counts.tolist(),
        # delta-log epoch these shards were cut at: shard loads refuse a
        # store whose epoch has moved on (GraphStore.partition_fresh)
        "epoch": int(getattr(store, "epoch", 0)),
    }
    _register_shards(store, "1d", counts, meta)
    return meta


def _check_shards_current(store: GraphStore) -> None:
    """Refuses shards cut before the store's current delta epoch — they
    describe the pre-delta edge set; re-partition or compact first."""
    # a store with no partition at all gets the loaders' clearer error
    if not getattr(store, "partition_meta", None):
        return
    if not getattr(store, "partition_fresh", True):
        raise StoreFormatError(
            f"{store.path}: persisted shards predate the delta log "
            f"(shard epoch "
            f"{int((store.partition_meta or {}).get('epoch', 0))} != "
            f"store epoch {store.epoch}); re-partition or compact "
            f"before loading shards"
        )


def load_partition(store: GraphStore):
    """Per-shard loads → the exact padded 1D ``Partition`` layout."""
    from repro_torch.core.dist_steiner import Partition

    _check_shards_current(store)
    meta = store.partition_meta
    if not meta or meta.get("scheme") != "1d":
        raise StoreFormatError(
            f"{store.path}: no 1D partition in manifest "
            f"(found {meta and meta.get('scheme')!r}) — run "
            f"`partition_store` first"
        )
    R, B, nb = meta["n_replica"], meta["n_blocks"], meta["nb"]
    bm = meta["block_multiple"]
    counts = np.asarray(meta["counts"], np.int64)
    eb = max(1, int(counts.max()))
    eb = -(-eb // bm) * bm
    osrc = np.zeros((R, B, eb), np.int32)
    odst = np.zeros((R, B, eb), np.int32)
    ow = np.full((R, B, eb), np.inf, np.float32)
    for b in range(B):
        odst[:, b, :] = b * nb  # padding dst = block base (local id 0)
    for (r, b), c in np.ndenumerate(counts):
        if c == 0:
            continue
        stem = _shard_stem("1d", r, b)
        osrc[r, b, :c] = store.array(f"shard_{stem}_src")
        odst[r, b, :c] = store.array(f"shard_{stem}_dst")
        ow[r, b, :c] = store.array(f"shard_{stem}_w")
    return Partition(
        src=osrc.reshape(-1),
        dst=odst.reshape(-1),
        w=ow.reshape(-1),
        n=store.n,
        nb=nb,
        eb=eb,
        n_blocks=B,
        n_replica=R,
    )


# ----------------------------------------------------------------------------
# 1D ELL shards (mesh frontier mode)
# ----------------------------------------------------------------------------

_ELL_FIELDS = (("nbr", np.int32), ("wgt", np.float32), ("row2v", np.int32))


def _register_ell_shards(store: GraphStore, counts: np.ndarray, k: int) -> None:
    """Adds ELL shard arrays + the ``partition.ell`` block to the manifest."""
    _drop_manifest_arrays(store.manifest, ("shard_ell_",))
    for (r, b), c in np.ndenumerate(counts):
        if c == 0:
            continue
        stem = _shard_stem("ell", r, b)
        for field, dtype in _ELL_FIELDS:
            shape = (c, k) if field != "row2v" else (c,)
            _add_shard_array(store, stem, field, dtype, shape)
    store.manifest["partition"]["ell"] = {"k": int(k), "counts": counts.tolist()}
    _write_manifest(store)


def partition_ell_store(
    store: GraphStore,
    *,
    k: int,
    chunk_vertices: int = 1 << 16,
) -> dict:
    """Writes 1D source-block ELL shards next to the existing edge shards.

    The split-row ELLPACK view (row width ``k``, high-degree rows split —
    exactly :func:`repro_torch.core.graph.to_ell`'s layout) is built chunkwise
    from the memmapped CSR and bucketed by the vertex block owning each
    row's *source*, dealt round-robin across replicas in global row
    order — bit-for-bit what
    :func:`repro_torch.core.dist_steiner.partition_ell` produces from the
    materialized graph.  Requires a 1D edge partition (its ``nb`` /
    replica / block geometry is reused).
    """
    if not (isinstance(k, int) and k >= 1):
        raise ValueError(f"ELL row width k must be a positive int, got {k!r}")
    meta = store.partition_meta
    if not meta or meta.get("scheme") != "1d":
        raise StoreFormatError(
            f"{store.path}: ELL shards ride the 1D partition geometry — "
            f"run `partition_store` first "
            f"(found {meta and meta.get('scheme')!r})"
        )
    R, B, nb = meta["n_replica"], meta["n_blocks"], meta["nb"]
    n = store.n
    if store.overlay is None:
        indptr = np.asarray(store.indptr)
        indices, weights = store.indices, store.weights
    else:
        # ELL shards must describe the EFFECTIVE graph, like the edge
        # shards cut from iter_coo above
        indptr, indices, weights = store.effective_csr()
    deg = np.diff(indptr).astype(np.int64)
    rows_per_v = np.maximum(1, -(-deg // k))
    row_off = np.concatenate([[0], np.cumsum(rows_per_v)])
    # first global row index of each block (blocks are vertex-contiguous)
    block_first_row = row_off[np.minimum(np.arange(B, dtype=np.int64) * nb, n)]

    shdir = store.path / "shards"
    shdir.mkdir(exist_ok=True)
    _clean_shards(shdir, "ell")
    counts = np.zeros((R, B), np.int64)
    for v0 in range(0, n, chunk_vertices):
        v1 = min(v0 + chunk_vertices, n)
        r0, r1 = int(row_off[v0]), int(row_off[v1])
        rows_c = r1 - r0
        nbr = np.zeros((rows_c, k), np.int32)
        wgt = np.full((rows_c, k), np.inf, np.float32)
        row2v = np.repeat(
            np.arange(v0, v1, dtype=np.int32), rows_per_v[v0:v1]
        )
        e0, e1 = int(indptr[v0]), int(indptr[v1])
        if e1 > e0:
            c = deg[v0:v1]
            edge_v = np.repeat(np.arange(v0, v1, dtype=np.int64), c)
            within = np.arange(e0, e1) - np.repeat(indptr[v0:v1], c)
            flat = (row_off[edge_v] - r0) * k + within
            nbr.reshape(-1)[flat] = indices[e0:e1]
            wgt.reshape(-1)[flat] = weights[e0:e1]
        blk = row2v.astype(np.int64) // nb
        rep = (np.arange(r0, r1) - block_first_row[blk]) % R
        for r in range(R):
            mr = rep == r
            if not mr.any():
                continue
            blk_r = blk[mr]
            for b in np.unique(blk_r):
                mb = mr.copy()
                mb[mr] = blk_r == b
                stem = _shard_stem("ell", r, int(b))
                for (field, dtype), arr in zip(
                    _ELL_FIELDS, (nbr[mb], wgt[mb], row2v[mb])
                ):
                    with open(shdir / f"{stem}_{field}.bin", "ab") as h:
                        h.write(
                            np.ascontiguousarray(arr, dtype=dtype).tobytes()
                        )
                counts[r, int(b)] += int(mb.sum())
    _register_ell_shards(store, counts, k)
    return store.manifest["partition"]["ell"]


def load_partition_ell(store: GraphStore):
    """Per-shard loads → the exact padded 1D ``EllPartition`` layout
    (bucket geometry shared with the host partitioner via
    ``ell_bucket_arrays`` — bit-for-bit agreement is a contract)."""
    from repro_torch.core.dist_steiner import EllPartition, ell_bucket_arrays

    _check_shards_current(store)
    meta = store.partition_meta
    if not meta or meta.get("scheme") != "1d" or "ell" not in meta:
        raise StoreFormatError(
            f"{store.path}: no 1D ELL partition in manifest — run "
            f"`partition_store`, then `partition_ell_store(k=K)` first"
        )
    nb, bm = meta["nb"], meta["block_multiple"]
    k = meta["ell"]["k"]
    counts = np.asarray(meta["ell"]["counts"], np.int64)
    nbr, wgt, row2v, _ = ell_bucket_arrays(counts, k, nb, bm)
    for (r, b), c in np.ndenumerate(counts):
        if c == 0:
            continue
        stem = _shard_stem("ell", r, b)
        nbr[r, b, :c] = store.array(f"shard_{stem}_nbr")
        wgt[r, b, :c] = store.array(f"shard_{stem}_wgt")
        row2v[r, b, :c] = store.array(f"shard_{stem}_row2v")
    return EllPartition.from_buckets(nbr, wgt, row2v, n=store.n, nb=nb)


# ----------------------------------------------------------------------------
# 2D edge-grid partition
# ----------------------------------------------------------------------------


def partition_store_2d(
    store: GraphStore,
    *,
    R: int,
    C: int,
    block_multiple: int = 8,
    chunk_edges: int = DEFAULT_CHUNK_EDGES,
) -> dict:
    """Writes 2D (src-row × dst-col) shards; one shard per device (r, c)."""
    nf = -(-store.n // (R * C))
    nf = -(-nf // block_multiple) * block_multiple
    shdir = store.path / "shards"
    shdir.mkdir(exist_ok=True)
    _clean_shards(shdir, "2d")  # appends must start from empty files
    _clean_shards(shdir, "ell")  # keyed to the replaced partition meta
    counts = np.zeros((R * C,), np.int64)
    for s, d, w in store.iter_coo(chunk_edges):
        s64 = s.astype(np.int64)
        d64 = d.astype(np.int64)
        r = np.minimum((s64 // nf) // C, R - 1)
        c = (d64 // nf) % C
        dev = r * C + c
        for dv in np.unique(dev):
            md = dev == dv
            _append_shard(
                shdir, _shard_stem("2d", int(dv), 0),
                s[md], d[md], w[md],
            )
            counts[int(dv)] += int(md.sum())
    meta = {
        "scheme": "2d",
        "R": int(R),
        "C": int(C),
        "nf": int(nf),
        "block_multiple": int(block_multiple),
        "counts": counts.tolist(),
        "epoch": int(getattr(store, "epoch", 0)),
    }
    _register_shards(store, "2d", counts.reshape(-1, 1), meta)
    return meta


def load_partition_2d(store: GraphStore):
    """Per-shard loads → the exact padded ``Partition2D`` layout, with
    global ids localized to (row, column) coordinates."""
    from repro_torch.core.dist_steiner_2d import Partition2D

    _check_shards_current(store)
    meta = store.partition_meta
    if not meta or meta.get("scheme") != "2d":
        raise StoreFormatError(
            f"{store.path}: no 2D partition in manifest "
            f"(found {meta and meta.get('scheme')!r})"
        )
    R, C, nf = meta["R"], meta["C"], meta["nf"]
    bm = meta["block_multiple"]
    counts = np.asarray(meta["counts"], np.int64)
    eb = -(-int(counts.max()) // bm) * bm
    osrc = np.zeros((R * C, eb), np.int32)
    odst = np.zeros((R * C, eb), np.int32)
    ow = np.full((R * C, eb), np.inf, np.float32)
    for dv in range(R * C):
        c = int(counts[dv])
        if c == 0:
            continue
        stem = _shard_stem("2d", dv, 0)
        s = np.asarray(store.array(f"shard_{stem}_src"), np.int64)
        d = np.asarray(store.array(f"shard_{stem}_dst"), np.int64)
        rr = dv // C
        osrc[dv, :c] = s - rr * C * nf
        fi = d // nf
        odst[dv, :c] = (fi // C) * nf + (d % nf)
        ow[dv, :c] = store.array(f"shard_{stem}_w")
    return Partition2D(
        src_row=osrc.reshape(-1),
        dst_col=odst.reshape(-1),
        w=ow.reshape(-1),
        n=store.n,
        nf=nf,
        R=R,
        C=C,
        eb=eb,
    )


# ----------------------------------------------------------------------------
# Hub-sort (degree-descending) reorder
# ----------------------------------------------------------------------------


def hub_sort_store(
    store: GraphStore,
    out_path,
    *,
    chunk_vertices: int = 1 << 16,
) -> Tuple[Path, np.ndarray]:
    """Writes a degree-descending-reordered copy of ``store``.

    Returns ``(path, perm)`` with ``perm[old_id] = new_id``.  If the
    input store is itself reordered, the stored ``vertex_perm`` is the
    composition back to *original* ids, so ``map_ids`` always translates
    caller-facing ids regardless of how many reorders happened.
    """
    n, m = store.n, store.m
    deg = np.asarray(store.degrees(), np.int64)
    order = np.argsort(-deg, kind="stable")  # old ids in new-id order
    perm = np.empty(n, np.int64)
    perm[order] = np.arange(n)

    writer = StoreWriter(out_path)
    indptr_mm = writer.create_array("indptr", np.int64, (n + 1,))
    indices_mm = writer.create_array("indices", np.int32, (m,))
    weights_mm = writer.create_array("weights", np.float32, (m,))
    new_indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg[order], out=new_indptr[1:])
    indptr_mm[...] = new_indptr

    old_indptr = np.asarray(store.indptr)
    for v0 in range(0, n, chunk_vertices):
        v1 = min(v0 + chunk_vertices, n)
        ovs = order[v0:v1]
        lens = deg[ovs]
        tot = int(lens.sum())
        if tot == 0:
            continue
        offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
        gather = np.repeat(old_indptr[ovs], lens) + (
            np.arange(tot) - np.repeat(offs, lens)
        )
        e0, e1 = int(new_indptr[v0]), int(new_indptr[v1])
        indices_mm[e0:e1] = perm[np.asarray(store.indices[gather], np.int64)]
        weights_mm[e0:e1] = store.weights[gather]

    prior = store.vertex_perm
    full_perm = perm if prior is None else perm[np.asarray(prior, np.int64)]
    writer.put_array("vertex_perm", full_perm.astype(np.int32))
    writer.set_meta(
        n=n,
        m=m,
        symmetric=store.manifest.get("symmetric", True),
        weight_range=store.manifest.get("weight_range"),
        partition=None,
        reorder="degree_desc",
        source=f"hub_sort({store.manifest.get('source', '?')})",
    )
    return writer.close(), perm
