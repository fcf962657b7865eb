"""Prim's MST in one launch: the wrapper over the Hopper kernel in csrc/prim.cu.

:func:`prim_call` runs every step of Prim's algorithm over a dense (S, S)
float32 matrix in one kernel on the card.  Its plain version is
:func:`repro_torch.core.mst.prim_loop`; :func:`repro_torch.core.mst.prim_dense`
calls this wrapper for a CUDA tensor and the loop for a CPU one.  Every
launch of the kernel, at any cluster size, adds 1 to ``prim_call.launches``.

The kernel's blocks follow S (:func:`cluster_blocks`): one block up to
``BLOCK_MAX`` vertices, and above it a thread-block cluster of up to 16
blocks, each owning a slice of the vertices.  The count changes which SMs
read each row, never the result.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# One block holds up to BLOCK_MAX vertices (640 threads owning 16 each).
# On an H100 one block is the fastest count up to there, and above it the
# fewest blocks that hold S: each block of a cluster adds a cluster barrier
# to every step (~0.7 us a step at S = 1024).  chip_smoke.py --only-prim
# times every count; PERF.md keeps the numbers.
BLOCK_MAX = 16 * 640
MAX_CLUSTER = 16
MAX_S = MAX_CLUSTER * BLOCK_MAX
_P = ctypes.c_void_p
_ARGTYPES = [ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int, _P]


def _entry():
    lib = _build.library("mst")
    fn = lib.prim_dense
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.prim_error_string.argtypes = [ctypes.c_int]
        lib.prim_error_string.restype = ctypes.c_char_p
    return lib, fn


def cluster_blocks(S: int) -> int:
    """Blocks of the kernel's cluster for S vertices: the fewest that hold
    them."""
    return -(-S // BLOCK_MAX)


def _check_inputs(wmat):
    if wmat.dim() != 2 or wmat.shape[0] != wmat.shape[1] or wmat.shape[0] < 1:
        raise ValueError(f"wmat must be (S, S) with S >= 1, got {tuple(wmat.shape)}")
    if wmat.dtype != torch.float32:
        raise ValueError(f"wmat must be float32, got {wmat.dtype}")
    if wmat.shape[0] > MAX_S:
        raise ValueError(f"S = {wmat.shape[0]} is above the kernel's {MAX_S}")
    if not wmat.is_contiguous():
        raise ValueError("wmat must be contiguous")
    if wmat.device.type != "cuda":
        raise ValueError(
            f"unsupported device {wmat.device}: the kernel runs on cuda "
            "(core.mst.prim_loop is its plain version)"
        )


def _launch(wmat: torch.Tensor, blocks: int) -> torch.Tensor:
    S = wmat.shape[0]
    dev = wmat.device
    parent = torch.empty(S, dtype=torch.int32, device=dev)
    lib, fn = _entry()
    rc = fn(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        wmat.data_ptr(), parent.data_ptr(), S, blocks,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:  # jitlint: ignore[TS02] rc: the C entry point's int error code
        msg = lib.prim_error_string(rc).decode()
        raise RuntimeError(f"prim_dense launch failed: CUDA error {rc} ({msg})")
    prim_call.launches += 1
    return parent


def prim_call(wmat: torch.Tensor) -> torch.Tensor:
    """Prim's MST over a dense (S, S) float32 matrix on the card, one launch.

    Args:
      wmat: (S, S) float32, contiguous, on a CUDA device; +inf = non-edge;
        finite or +inf entries (no NaN).  The diagonal is never read as an
        edge.

    Returns:
      parent: (S,) int32, parent[0] == 0, bit for bit the plain loop's:
      start from vertex 0; each step adds the lowest id among the least
      best weights outside the tree; stop when that weight is +inf
      (vertices of other components keep ``parent[v] == v``); an entry
      improves only where a new row is strictly less.  The launch runs on
      the current stream and makes no host read.
    """
    _check_inputs(wmat)
    return _launch(wmat, cluster_blocks(wmat.shape[0]))


prim_call.launches = 0
