"""Writes into buffers the region does not own (DN01).

The counterpart of ``repro.analysis.spmd.donation``.  JAX's hazard is a
read after donation: a buffer given to an inner jit and read again.  The
port's counterpart is the in-place write: PyTorch lets any op write into
any tensor, so a region that writes into the storage of a tensor it was
handed (a prepared ELL view, a memoized layout, the caller's seeds)
changes what every other holder of that storage reads.  That is the
``EllPatcher`` class (``delta/incremental.py``: a patch into a shared
view unless it copies first) and the stale blocked layout of a refreshed
ELL.

  DN01  an in-place write, inside the recorded region, to the storage of
        a tensor that the region neither made nor was declared to own;
        and a read of a view taken before such a write (it sees the
        overwritten values).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set

from repro_torch.analysis.spmd.dispatch_tools import Recording, Violation


def analyze(recs: Sequence[Recording]) -> List[Violation]:
    out: List[Violation] = []
    for rec in recs:
        _rank(rec, out)
    return out


def _rank(rec: Recording, out: List[Violation]) -> None:
    made: Set[int] = set(rec.owned)  # storages the region allocated or owns
    seen: Set[int] = set()  # tensors seen so far
    born: Dict[int, int] = {}  # tensor -> index of the op that first showed it
    written: Dict[int, int] = {}  # foreign storage -> index of its last write
    stale: Set[int] = set()
    for op in rec.ops:
        for t in op.inputs:
            st = rec.tensors[t].storage
            if t not in seen:
                seen.add(t)
                born[t] = op.index
            w = written.get(st)
            if (w is not None and born[t] < w and t not in stale
                    and t not in op.writes):
                stale.add(t)
                out.append(Violation(
                    "DN01",
                    "reads a view taken before an in-place write into a buffer the "
                    "region does not own: it sees the overwritten values", op))
        for t in op.writes:
            st = rec.tensors[t].storage
            if st not in made:
                written[st] = op.index
                out.append(Violation(
                    "DN01",
                    "in-place write into a buffer the region was handed and does not "
                    "own: every other holder of it reads the new values (copy first, "
                    "or own the buffer)", op))
        for t in op.outputs:
            st = rec.tensors[t].storage
            if t not in seen:
                seen.add(t)
                born[t] = op.index
                if t not in op.writes and not op.is_view:
                    made.add(st)
