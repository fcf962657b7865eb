"""Log-structured edge deltas over ``.gstore`` graphs (counterpart of
``repro.delta``).

A mutated graph is its base CSR plus an ordered, crash-safe, checksummed
log of ``add`` / ``delete`` / ``reweight`` records (:mod:`.log`), folded at
open into a COO overlay (:mod:`.overlay`) that every ``GraphStore`` view
applies.  :func:`compact` (:mod:`.compact`) folds the log back into a
fresh base store, atomically, refreshing persisted shards incrementally.
:mod:`.resolve` turns a previous epoch's converged Voronoi state into a
sound warm start for re-solving only the delta-affected cells, and
:class:`IncrementalSession` (:mod:`.incremental`) keeps a solve resident
across epochs: in-place ELL row surgery, warm frontier rounds and exact
pair-table repair, bit-identical to a cold solve of the mutated store.
"""

from repro_torch.delta.compact import CompactStats, compact
from repro_torch.delta.log import (
    OP_ADD,
    OP_DELETE,
    OP_REWEIGHT,
    DeltaSegment,
    append_deltas,
    read_segment,
    read_segments,
    segment_name,
)
from repro_torch.delta.overlay import DeltaOverlay, fold_overlay, pair_key

# The names of the two modules that need torch load on first use (PEP 562),
# so the host tools (the graphstore CLI, appends, compaction) never import
# it.
_TORCH_EXPORTS = {
    "EllPatcher": "repro_torch.delta.incremental",
    "EpochResult": "repro_torch.delta.incremental",
    "IncrementalSession": "repro_torch.delta.incremental",
    "effective_adjacency": "repro_torch.delta.incremental",
    "affected_cells": "repro_torch.delta.resolve",
    "entry_survives": "repro_torch.delta.resolve",
    "reset_affected": "repro_torch.delta.resolve",
}


def __getattr__(name: str):
    mod = _TORCH_EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


__all__ = [
    "OP_ADD",
    "OP_DELETE",
    "OP_REWEIGHT",
    "CompactStats",
    "DeltaOverlay",
    "DeltaSegment",
    "EllPatcher",
    "EpochResult",
    "IncrementalSession",
    "affected_cells",
    "append_deltas",
    "compact",
    "effective_adjacency",
    "entry_survives",
    "fold_overlay",
    "pair_key",
    "read_segment",
    "read_segments",
    "reset_affected",
    "segment_name",
]
