"""The least time of the min-plus relaxation, from the work of its inputs.

One relaxation of B query lanes over a graph of N vertices and E directed
edges reads each edge's neighbour id and weight once (8 B an edge, the
padding of any layout excluded), each lane's ``dist`` and ``lab`` once
(8 B a vertex a lane) and writes each vertex's new ``(dist, lab, pred)``
once a lane (12 B a vertex a lane).  Its operations, two a candidate, are
far below the card's rate, so its bound is these bytes at the memory rate.

:func:`ell_bytes` counts what the port's ELL layout makes a relaxation
read instead (every slot of every row, padding included, and an output
triple a row): the bound that ``PERF.md``'s table of kernels states.
"""

from __future__ import annotations

from perfkit.devtrace import HBM_BYTES_PER_S


def relax_bytes(E: int, N: int, B: int = 1) -> int:
    """Bytes one relaxation of B lanes needs: the work of its inputs."""
    return 8 * E + 8 * B * N + 12 * B * N


def ell_bytes(R: int, K: int, N: int, B: int = 1) -> int:
    """Bytes one relaxation reads and writes over an (R, K) ELL view:
    every slot's id and weight, each lane's dist and lab, an output triple
    a row and lane."""
    return 8 * R * K + 8 * B * N + 12 * B * R


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def roofline_share(rec, kernels, main: str, lanes: int):
    """% of the relaxation's least time in its device time over the traced
    window: rounds (launches of ``main``) times :func:`relax_bytes` at the
    memory rate, over the device time of ``kernels``.  None where the trace
    holds no launch of ``main`` (the path does not run it)."""
    if rec.device is None:
        return None
    seen = rec.device.by_kernel(kernels)
    if main not in seen:
        return None
    rounds = seen[main][0]
    device_s = sum(t for _, t in seen.values())
    least_s = rounds * relax_bytes(rec.graph_edges, rec.graph_n, lanes) / HBM_BYTES_PER_S
    return 100.0 * least_s / device_s
