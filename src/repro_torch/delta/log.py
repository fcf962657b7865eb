"""The on-disk delta log: binary append segments inside a ``.gstore``.

A numpy-only copy of ``repro.delta.log``: both packages write and read the
same segments.

A mutated graph is the base CSR plus an ordered log of edge operations.
Each ``append_deltas`` call writes ONE immutable segment file

    delta_{epoch:06d}.bin

into the store directory and registers it (file, epoch, count, crc32)
under ``manifest["deltas"]``, bumping the manifest's monotonically
increasing ``epoch``.  Segments are columnar and memmap-friendly::

    [0:4)    magic  b"GDLT"
    [4:8)    u32    segment format version (1)
    [8:16)   u64    record count k
    [16:..)  u8[k]  op codes (0 add, 1 delete, 2 reweight)
    pad to 4-byte alignment
    i32[k]   u endpoints
    i32[k]   v endpoints
    f32[k]   weights (0.0 for deletes)

Crash safety: the segment is written to a temp file, fsynced and renamed
before the manifest is atomically rewritten.  A crash between the two
leaves an orphan ``delta_*.bin`` the manifest does not list — replay
ignores it, so a torn append is invisible rather than half-applied.

Record semantics (folded by :mod:`repro_torch.delta.overlay`):

* ``("add", u, v, w)``      — append one undirected edge (both directions
  are stored at application, like ingest).  Parallel edges are allowed.
* ``("delete", u, v)``      — remove EVERY live edge between u and v, in
  both directions: all matching base edges and all earlier live adds.
  Deleting a pair with no live edges is a no-op.
* ``("reweight", u, v, w)`` — set the weight of every live edge between
  u and v (base and added).  No-op when no live edge matches.

Endpoints are in the store's *stored* id space; :func:`append_deltas`
translates caller-facing original ids through ``vertex_perm`` for
hub-sorted stores (``map_ids=False`` opts out).
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Iterable, Sequence, Tuple, Union

import numpy as np

from repro_torch import obs
from repro_torch.graphstore import format as fmt

SEGMENT_MAGIC = b"GDLT"
SEGMENT_VERSION = 1
_HEADER_BYTES = 16

OP_ADD = 0
OP_DELETE = 1
OP_REWEIGHT = 2
_OP_NAMES = {"add": OP_ADD, "delete": OP_DELETE, "reweight": OP_REWEIGHT}


def segment_name(epoch: int) -> str:
    return f"delta_{int(epoch):06d}.bin"


@dataclasses.dataclass(frozen=True)
class DeltaSegment:
    """One decoded delta segment (columnar record arrays, log order)."""

    epoch: int
    ops: np.ndarray  # (k,) u8
    u: np.ndarray  # (k,) i32
    v: np.ndarray  # (k,) i32
    w: np.ndarray  # (k,) f32

    @property
    def count(self) -> int:
        return int(self.ops.shape[0])


def _normalize_records(
    records: Iterable[Sequence], n: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Validated columnar (ops, u, v, w) from record tuples."""
    ops, us, vs, ws = [], [], [], []
    for rec in records:
        op = _OP_NAMES.get(rec[0])
        if op is None:
            raise ValueError(
                f"unknown delta op {rec[0]!r} (add | delete | reweight)"
            )
        u, v = int(rec[1]), int(rec[2])
        if op == OP_DELETE:
            if len(rec) != 3:
                raise ValueError(f"delete takes (u, v), got {rec!r}")
            w = 0.0
        else:
            if len(rec) != 4:
                raise ValueError(f"{rec[0]} takes (u, v, w), got {rec!r}")
            w = float(rec[3])
            if not (np.isfinite(w) and w > 0):
                raise ValueError(
                    f"delta weight must be finite and > 0, got {w!r} in {rec!r}"
                )
        if u == v:
            raise ValueError(f"self-loop delta rejected: {rec!r}")
        if not (0 <= u < n and 0 <= v < n):
            raise ValueError(
                f"delta endpoint out of range [0, {n}): {rec!r}"
            )
        ops.append(op)
        us.append(u)
        vs.append(v)
        ws.append(w)
    return (
        np.asarray(ops, np.uint8),
        np.asarray(us, np.int32),
        np.asarray(vs, np.int32),
        np.asarray(ws, np.float32),
    )


def _encode_segment(ops: np.ndarray, u: np.ndarray, v: np.ndarray,
                    w: np.ndarray) -> bytes:
    k = ops.shape[0]
    pad = (-(_HEADER_BYTES + k)) % 4
    return b"".join(
        (
            SEGMENT_MAGIC,
            np.uint32(SEGMENT_VERSION).tobytes(),
            np.uint64(k).tobytes(),
            np.ascontiguousarray(ops, np.uint8).tobytes(),
            b"\x00" * pad,
            np.ascontiguousarray(u, "<i4").tobytes(),
            np.ascontiguousarray(v, "<i4").tobytes(),
            np.ascontiguousarray(w, "<f4").tobytes(),
        )
    )


def read_segment(path: Union[str, Path], epoch: int) -> DeltaSegment:
    """Decodes one segment file (memmap-backed columnar views)."""
    path = Path(path)
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    if raw.shape[0] < _HEADER_BYTES or bytes(raw[:4]) != SEGMENT_MAGIC:
        raise fmt.StoreFormatError(f"{path}: not a delta segment (bad magic)")
    ver = int(raw[4:8].view("<u4")[0])
    if ver != SEGMENT_VERSION:
        raise fmt.StoreFormatError(
            f"{path}: delta segment version {ver} not supported "
            f"(supported: {SEGMENT_VERSION})"
        )
    k = int(raw[8:16].view("<u8")[0])
    o0 = _HEADER_BYTES
    o1 = o0 + k + ((-(_HEADER_BYTES + k)) % 4)
    expect = o1 + 12 * k
    if raw.shape[0] != expect:
        raise fmt.StoreFormatError(
            f"{path}: segment size {raw.shape[0]} != expected {expect} "
            f"for {k} records (truncated?)"
        )
    return DeltaSegment(
        epoch=int(epoch),
        ops=raw[o0 : o0 + k].view(np.uint8),
        u=raw[o1 : o1 + 4 * k].view("<i4"),
        v=raw[o1 + 4 * k : o1 + 8 * k].view("<i4"),
        w=raw[o1 + 8 * k : o1 + 12 * k].view("<f4"),
    )


def read_segments(path: Union[str, Path], manifest: dict) -> list:
    """All manifest-listed segments in epoch order."""
    path = Path(path)
    out = []
    for entry in sorted(
        manifest.get("deltas", ()), key=lambda e: int(e["epoch"])
    ):
        out.append(read_segment(path / entry["file"], int(entry["epoch"])))
    return out


def append_deltas(
    store_or_path,
    records: Iterable[Sequence],
    *,
    map_ids: bool = True,
) -> dict:
    """Crash-safely appends one delta segment to a store.

    Args:
      store_or_path: an open :class:`~repro_torch.graphstore.GraphStore` or a
        store directory path.  An open handle is reloaded in place so its
        overlay reflects the new epoch.
      records: ordered ``("add", u, v, w)`` / ``("delete", u, v)`` /
        ``("reweight", u, v, w)`` tuples.
      map_ids: translate endpoints through the store's ``vertex_perm``
        (hub-sorted stores) so callers keep using original ids.

    Returns:
      ``{"epoch", "count", "file"}`` for the new segment.
    """
    from repro_torch.graphstore.loader import GraphStore

    store = None
    if isinstance(store_or_path, GraphStore):
        store = store_or_path
        path = store.path
        manifest = store.manifest
    else:
        path = Path(store_or_path)
        manifest = fmt.read_manifest(path)
    n = int(manifest["n"])
    ops, u, v, w = _normalize_records(records, n)
    if map_ids and "vertex_perm" in manifest["arrays"]:
        perm = np.asarray(fmt.map_array(path, manifest, "vertex_perm"))
        u = perm[u.astype(np.int64)].astype(np.int32)
        v = perm[v.astype(np.int64)].astype(np.int32)
    epoch = int(manifest.get("epoch", 0)) + 1
    rel = segment_name(epoch)
    with obs.span("delta:append", store=str(path), epoch=epoch,
                  records=int(ops.shape[0])):
        payload = _encode_segment(ops, u, v, w)
        tmp = path / (rel + ".tmp")
        with open(tmp, "wb") as h:
            h.write(payload)
            h.flush()
            os.fsync(h.fileno())
        tmp.replace(path / rel)
        entry = {
            "file": rel,
            "epoch": epoch,
            "count": int(ops.shape[0]),
            "crc32": fmt.crc32_file(path / rel),
        }
        manifest.setdefault("deltas", []).append(entry)
        manifest["epoch"] = epoch
        # delta-bearing stores are a newer layout revision: pre-delta
        # readers must refuse them instead of silently solving the stale
        # base graph
        manifest["format_version"] = fmt.FORMAT_VERSION_DELTA
        mtmp = path / (fmt.MANIFEST_NAME + ".tmp")
        mtmp.write_text(json.dumps(manifest, indent=1, sort_keys=True))
        mtmp.replace(path / fmt.MANIFEST_NAME)
    g = obs.gauge("delta_epoch", "current epoch of the last touched store")
    if g is not None:
        g.set(float(epoch))
    if store is not None:
        store.reload(verify=False)
    return {"epoch": epoch, "count": int(ops.shape[0]), "file": rel}
