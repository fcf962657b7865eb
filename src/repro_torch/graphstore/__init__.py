"""Out-of-core graph storage and streaming ingestion (the ``*.gstore`` layout).

Counterpart of ``repro.graphstore``; both packages read and write the same
stores.

* :mod:`repro_torch.graphstore.format`  the ``.gstore`` layout, manifest,
  checksums, version gate
* :mod:`repro_torch.graphstore.ingest`  the streaming CSR builder and edge
  sources (chunked RMAT, in-memory arrays)
* :mod:`repro_torch.graphstore.loader`  ``open_store`` -> :class:`GraphStore`
  (lazy ``to_graph``, the ELL view filled on the device, shard loads)
* :mod:`repro_torch.graphstore.partition`  per-shard partitioning for the
  mesh backends (1D edge and ELL shards, 2D shards) and the hub-sort
  reorder

Mutation rides on top as the delta log (:mod:`repro_torch.delta`);
``append_deltas`` is re-exported here.  Not ported: the ``graphstore``
CLI, ``TsvEdgeSource`` and ``compact`` (ROADMAP.md).
"""

from repro_torch.graphstore.format import (
    FORMAT_VERSION,
    FORMAT_VERSION_DELTA,
    ChecksumError,
    StoreFormatError,
    StoreWriter,
    verify_store,
)
from repro_torch.graphstore.ingest import (
    ArraySource,
    IngestStats,
    RmatEdgeSource,
    build_store,
    csr_from_chunks,
)
from repro_torch.graphstore.loader import GraphStore, open_store
from repro_torch.graphstore.partition import (
    hub_sort_store,
    load_partition,
    load_partition_2d,
    load_partition_ell,
    partition_ell_store,
    partition_store,
    partition_store_2d,
)


def __getattr__(name: str):
    # lazy (PEP 562): repro_torch.delta imports this package's modules at
    # import time, so an eager import here would be circular
    if name == "append_deltas":
        from repro_torch.delta.log import append_deltas

        return append_deltas
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "FORMAT_VERSION",
    "FORMAT_VERSION_DELTA",
    "ChecksumError",
    "StoreFormatError",
    "StoreWriter",
    "append_deltas",
    "verify_store",
    "ArraySource",
    "IngestStats",
    "RmatEdgeSource",
    "build_store",
    "csr_from_chunks",
    "GraphStore",
    "open_store",
    "hub_sort_store",
    "load_partition",
    "load_partition_2d",
    "load_partition_ell",
    "partition_ell_store",
    "partition_store",
    "partition_store_2d",
]
