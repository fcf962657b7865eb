"""Log-structured edge deltas over ``.gstore`` graphs (counterpart of
``repro.delta``).

A mutated graph is its base CSR plus an ordered, crash-safe, checksummed
log of ``add`` / ``delete`` / ``reweight`` records (:mod:`.log`), folded at
open into a COO overlay (:mod:`.overlay`) that every ``GraphStore`` view
applies.  :mod:`.resolve` turns a previous epoch's converged Voronoi state
into a sound warm start for re-solving only the delta-affected cells, and
:class:`IncrementalSession` (:mod:`.incremental`) keeps a solve resident
across epochs: in-place ELL row surgery, warm frontier rounds and exact
pair-table repair, bit-identical to a cold solve of the mutated store.
Not ported: ``compact`` (ROADMAP.md).
"""

from repro_torch.delta.incremental import (
    EllPatcher,
    EpochResult,
    IncrementalSession,
    effective_adjacency,
)
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
from repro_torch.delta.resolve import affected_cells, entry_survives, reset_affected

__all__ = [
    "OP_ADD",
    "OP_DELETE",
    "OP_REWEIGHT",
    "DeltaOverlay",
    "DeltaSegment",
    "EllPatcher",
    "EpochResult",
    "IncrementalSession",
    "affected_cells",
    "append_deltas",
    "effective_adjacency",
    "entry_survives",
    "fold_overlay",
    "pair_key",
    "read_segment",
    "read_segments",
    "reset_affected",
    "segment_name",
]
