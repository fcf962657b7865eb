"""nccl_share.mesh: % of rank 0's busy device time (the union of its
activities) in which an NCCL kernel ran (a name holding "nccl", any case),
the union of those kernels' intervals.  An NCCL kernel runs from its launch
until every rank of its group has joined, so the share includes waiting
on the other ranks.  None where the trace holds no NCCL kernel."""

from perfkit.solvespans import union


def read(rec):
    if rec.device is None:
        return None
    nccl = [(s, e) for name, s, e in rec.device.events if "nccl" in name.lower()]
    busy = rec.device.busy_s()
    if not nccl or busy <= 0:
        return None
    return 100.0 * sum(e - s for s, e in union(nccl)) / 1e9 / busy
