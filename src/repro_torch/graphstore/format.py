"""The versioned ``*.gstore`` on-disk graph layout.

A numpy-only copy of ``repro.graphstore.format``: both packages read and
write the same stores, byte for byte.

A store is a directory holding the symmetrized CSR of one weighted graph
as raw little-endian arrays that :func:`numpy.memmap` can map lazily,
plus a ``manifest.json`` describing them:

    g.gstore/
      manifest.json         version, n, m, dtypes, weight range,
                            partition scheme, per-array checksums
      indptr.bin            (n+1,) int64   CSR row offsets
      indices.bin           (m,)   int32   neighbor ids (directed edges)
      weights.bin           (m,)   float32 edge weights
      vertex_perm.bin       (n,)   int32   [optional] old id -> stored id
      shards/               [optional] per-device COO shards (partition.py)

``m`` counts *directed* edges — both directions of every undirected edge
are stored, matching the paper's ``2|E|`` representation and
:func:`repro_torch.core.graph.from_edges`.  Within a row, neighbors keep edge
arrival order (ingest is stable), so round-trips are reproducible.

Every array carries a streaming CRC32 in the manifest; ``open_store``
verifies them by default so a truncated copy or bit-rot fails loudly
instead of producing a silently wrong tree.  The layout is versioned:
readers refuse manifests whose ``format_version`` they do not know.
"""

from __future__ import annotations

import json
import zlib
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np

FORMAT_VERSION = 1
# Revision 2 = revision 1 plus a delta log (``manifest["deltas"]`` append
# segments and a monotonic ``epoch``; see repro_torch.delta).  Written only when
# the log is non-empty, so pre-delta readers refuse mutated stores instead
# of silently solving the stale base CSR; compaction folds the log away
# and drops back to revision 1.
FORMAT_VERSION_DELTA = 2
SUPPORTED_VERSIONS = (FORMAT_VERSION, FORMAT_VERSION_DELTA)
MANIFEST_NAME = "manifest.json"
STORE_SUFFIX = ".gstore"

# crc32 is streamed in bounded slices so checksumming never materializes
# a whole array in RAM (the arrays may be far larger than the host).
_CRC_CHUNK_BYTES = 16 << 20


class StoreFormatError(RuntimeError):
    """Malformed / unknown-version / missing-file store."""


class ChecksumError(StoreFormatError):
    """An array's bytes do not match the checksum in the manifest."""


def crc32_file(path: Union[str, Path]) -> int:
    """Streaming CRC32 of a file's bytes (bounded memory)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(_CRC_CHUNK_BYTES)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


def _dtype_tag(dtype) -> str:
    """Endianness-explicit dtype tag ('<i8', '<f4', ...)."""
    return np.dtype(dtype).newbyteorder("<").str


# ----------------------------------------------------------------------------
# Writing
# ----------------------------------------------------------------------------


class StoreWriter:
    """Builds a ``.gstore`` directory array by array.

    Arrays are created as writable memmaps (so ingest can fill them in
    chunks without holding them in RAM) and checksummed + registered in
    the manifest at :meth:`close`.  The manifest is written last — a
    crashed ingest leaves a directory with no manifest, which
    :func:`open_store` rejects, rather than a plausible-looking store.
    """

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self._arrays: Dict[str, dict] = {}
        self._open: Dict[str, np.memmap] = {}
        self._meta: Dict[str, object] = {}

    def create_array(self, name: str, dtype, shape: Tuple[int, ...]) -> np.memmap:
        """Allocates ``<name>.bin`` on disk and returns a writable memmap."""
        if name in self._arrays:
            raise StoreFormatError(f"array {name!r} already created")
        rel = f"{name}.bin"
        shape = tuple(int(s) for s in shape)
        self._arrays[name] = {
            "file": rel,
            "dtype": _dtype_tag(dtype),
            "shape": list(shape),
        }
        if int(np.prod(shape, dtype=np.int64)) == 0:
            # np.memmap cannot map an empty file; an empty graph is still
            # a valid store, so write the zero-byte file directly
            (self.path / rel).write_bytes(b"")
            return np.empty(shape, dtype=np.dtype(dtype))
        mm = np.memmap(self.path / rel, dtype=np.dtype(dtype), mode="w+",
                       shape=shape)
        self._open[name] = mm
        return mm

    def put_array(self, name: str, values: np.ndarray) -> None:
        """create_array + fill in one step (small arrays: perm, shards)."""
        mm = self.create_array(name, values.dtype, values.shape)
        mm[...] = values
        del mm
        self._open.pop(name, None)  # absent for zero-size arrays

    def register_file(self, name: str, rel: str, dtype, shape) -> None:
        """Registers an already-written file (e.g. a shard hardlinked from
        a previous epoch during compaction) as a manifest array.  The file
        must exist under the store directory; it is checksummed with the
        rest at :meth:`close`."""
        if name in self._arrays:
            raise StoreFormatError(f"array {name!r} already created")
        if not (self.path / rel).is_file():
            raise StoreFormatError(
                f"register_file({name!r}): {rel} missing under {self.path}"
            )
        self._arrays[name] = {
            "file": rel,
            "dtype": _dtype_tag(dtype),
            "shape": [int(s) for s in shape],
        }

    def set_meta(self, **kw) -> None:
        """Top-level manifest fields (n, m, weight_range, partition, ...)."""
        self._meta.update(kw)

    def close(self) -> Path:
        """Flushes arrays, checksums them, writes the manifest."""
        for name, mm in self._open.items():
            mm.flush()
            del mm
        self._open.clear()
        for name, entry in self._arrays.items():
            entry["crc32"] = crc32_file(self.path / entry["file"])
        manifest = {
            "format": "gstore",
            "format_version": FORMAT_VERSION,
            "arrays": self._arrays,
            **self._meta,
        }
        tmp = self.path / (MANIFEST_NAME + ".tmp")
        tmp.write_text(json.dumps(manifest, indent=1, sort_keys=True))
        tmp.replace(self.path / MANIFEST_NAME)
        return self.path


# ----------------------------------------------------------------------------
# Reading
# ----------------------------------------------------------------------------


def read_manifest(path: Union[str, Path]) -> dict:
    """Loads + structurally validates ``manifest.json`` of a store dir."""
    path = Path(path)
    mf = path / MANIFEST_NAME
    if not path.is_dir() or not mf.is_file():
        raise StoreFormatError(f"{path} is not a .gstore directory (no manifest)")
    try:
        manifest = json.loads(mf.read_text())
    except json.JSONDecodeError as e:
        raise StoreFormatError(f"{mf}: manifest is not valid JSON: {e}") from None
    if manifest.get("format") != "gstore":
        raise StoreFormatError(f"{mf}: not a gstore manifest")
    ver = manifest.get("format_version")
    if ver not in SUPPORTED_VERSIONS:
        raise StoreFormatError(
            f"{mf}: format_version {ver!r} is not supported by this reader "
            f"(supported: {', '.join(map(str, SUPPORTED_VERSIONS))})"
        )
    for req in ("arrays", "n", "m"):
        if req not in manifest:
            raise StoreFormatError(f"{mf}: missing required field {req!r}")
    for entry in manifest.get("deltas", ()):
        for req in ("file", "epoch", "count", "crc32"):
            if req not in entry:
                raise StoreFormatError(
                    f"{mf}: delta segment entry missing {req!r}: {entry!r}"
                )
    return manifest


def map_array(
    path: Union[str, Path], manifest: dict, name: str, *, verify: bool = False
) -> np.memmap:
    """Memmaps one manifest-registered array read-only."""
    path = Path(path)
    try:
        entry = manifest["arrays"][name]
    except KeyError:
        raise StoreFormatError(f"{path}: no array {name!r} in manifest") from None
    f = path / entry["file"]
    if not f.is_file():
        raise StoreFormatError(f"{path}: array file {entry['file']} missing")
    dtype = np.dtype(entry["dtype"])
    shape = tuple(entry["shape"])
    expect = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if f.stat().st_size != expect:
        raise StoreFormatError(
            f"{f}: size {f.stat().st_size} != expected {expect} "
            f"for shape {shape} dtype {entry['dtype']}"
        )
    if verify:
        verify_array(path, manifest, name)
    if expect == 0:  # np.memmap cannot map an empty file
        return np.empty(shape, dtype=dtype)
    return np.memmap(f, dtype=dtype, mode="r", shape=shape)


def verify_array(path: Union[str, Path], manifest: dict, name: str) -> None:
    """Checks one array's streaming CRC32 against the manifest."""
    path = Path(path)
    entry = manifest["arrays"][name]
    if not (path / entry["file"]).is_file():
        raise StoreFormatError(
            f"{path}: array file {entry['file']} missing (manifest lists it)"
        )
    got = crc32_file(path / entry["file"])
    want = int(entry["crc32"])
    if got != want:
        raise ChecksumError(
            f"{path / entry['file']}: crc32 {got:#010x} != manifest {want:#010x} "
            f"(corrupted or truncated store)"
        )


def verify_store(path: Union[str, Path], manifest: Optional[dict] = None) -> None:
    """Verifies every array AND delta segment checksum in the store."""
    path = Path(path)
    if manifest is None:
        manifest = read_manifest(path)
    for name in manifest["arrays"]:
        verify_array(path, manifest, name)
    for entry in manifest.get("deltas", ()):
        f = path / entry["file"]
        if not f.is_file():
            raise StoreFormatError(
                f"{path}: delta segment {entry['file']} missing "
                f"(manifest lists it)"
            )
        got = crc32_file(f)
        want = int(entry["crc32"])
        if got != want:
            raise ChecksumError(
                f"{f}: crc32 {got:#010x} != manifest {want:#010x} "
                f"(corrupted or truncated delta segment)"
            )
