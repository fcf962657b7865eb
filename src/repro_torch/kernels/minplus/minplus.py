"""Min-plus ELL relaxation: wrappers over the Hopper kernels in csrc/minplus.cu.

Counterparts of ``repro.kernels.minplus.minplus`` with the same signatures.
A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version :func:`~repro_torch.kernels.minplus.ref.minplus_torch`.  Each
wrapper counts its launches in ``<wrapper>.launches``.

``dist`` and ``lab`` may carry a leading (B,) lane axis, one row per query
of a batch over the same graph (what ``jax.vmap`` of the Pallas calls
computes); the outputs are then (B, R).  An (N,) input launches the
single-query kernel as before.  ``<wrapper>.lane_launches`` counts the
launches that had a lane axis.

``block_rows`` is the number of ELL rows one thread block owns; it never
changes results.  ``interpret`` is accepted for signature parity with the
Pallas wrappers and ignored: there is no interpreter for a CUDA kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.minplus.ref import minplus_torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448  # bytes of shared memory one block can use on Hopper

_P = ctypes.c_void_p
_ARGTYPES = {
    "minplus_resident": [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P, _P,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P,
    ],
    "minplus_resident_lanes": [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P, _P,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
    ],
    "minplus_blocked": [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P, _P,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _P,
    ],
}
_MAX_LANES = 65535  # gridDim.y of the blocked kernel


def _entry(name: str):
    lib = _build.library("minplus")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        lib.minplus_error_string.argtypes = [ctypes.c_int]
        lib.minplus_error_string.restype = ctypes.c_char_p
    return lib, fn


def _check_inputs(nbr, wgt, dist, lab, block_rows):
    dev = nbr.device
    for name, t in (("wgt", wgt), ("dist", dist), ("lab", lab)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, nbr on {dev}")
    if nbr.dim() != 2 or nbr.dtype != torch.int32:
        raise ValueError(f"nbr must be (R, K) int32, got {tuple(nbr.shape)} {nbr.dtype}")
    if wgt.shape != nbr.shape or wgt.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"wgt must be {tuple(nbr.shape)} f32/bf16, got {tuple(wgt.shape)} {wgt.dtype}"
        )
    if dist.dim() not in (1, 2) or dist.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"dist must be (N,) or (B, N) f32/bf16, got {tuple(dist.shape)} {dist.dtype}"
        )
    if dist.dim() == 2 and not 1 <= dist.shape[0] <= _MAX_LANES:
        raise ValueError(f"dist has {dist.shape[0]} lanes; 1..{_MAX_LANES} are supported")
    if lab.shape != dist.shape or lab.dtype != torch.int32:
        raise ValueError(f"lab must be {tuple(dist.shape)} int32, got {lab.dtype}")
    if not (isinstance(block_rows, int) and block_rows >= 1):
        raise ValueError(f"block_rows must be a positive int, got {block_rows!r}")
    if dev.type == "cuda":
        for name, t in (("nbr", nbr), ("wgt", wgt), ("dist", dist), ("lab", lab)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: the kernels run on cuda")


def _launch(name, nbr, wgt, dist, lab, *extra, lanes=None):
    """Launches ``name`` with (R,) outputs, or (lanes, R) ones."""
    R, K = nbr.shape
    dev = nbr.device
    shape = (R,) if lanes is None else (lanes, R)
    m = torch.empty(shape, dtype=torch.float32, device=dev)
    ml = torch.empty(shape, dtype=torch.int32, device=dev)
    ms = torch.empty(shape, dtype=torch.int32, device=dev)
    if R == 0:
        return m, ml, ms
    lib, fn = _entry(name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        _DTYPE_CODES[dist.dtype], _DTYPE_CODES[wgt.dtype],
        nbr.data_ptr(), wgt.data_ptr(), dist.data_ptr(), lab.data_ptr(),
        m.data_ptr(), ml.data_ptr(), ms.data_ptr(), R, K, *extra, stream,
    )
    if rc != 0:
        msg = lib.minplus_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    return m, ml, ms


def minplus_call(
    nbr: torch.Tensor,
    wgt: torch.Tensor,
    dist: torch.Tensor,
    lab: torch.Tensor,
    *,
    block_rows: int = 256,
    interpret=None,
):
    """Resident min-plus relaxation (replaces the Pallas ``minplus_call``).

    Args:
      nbr: (R, K) int32 neighbor ids (padding: any id with wgt=+inf).
      wgt: (R, K) f32/bf16 weights (+inf padding).
      dist: (N,) or (B, N) f32/bf16 distances (no NaN, no -inf).
      lab: int32 labels, the shape of ``dist``.
      block_rows: rows per thread block; any R is accepted.
      interpret: ignored (no interpreter for a CUDA kernel).

    Returns:
      (m, ml, ms): (R,) or (B, R) f32 / i32 / i32 per-row lexicographic
      minima.
    """
    _check_inputs(nbr, wgt, dist, lab, block_rows)
    if nbr.device.type == "cpu":
        return minplus_torch(nbr, wgt, dist, lab)
    launched = nbr.shape[0] > 0
    if dist.dim() == 1:
        out = _launch("minplus_resident", nbr, wgt, dist, lab, block_rows)
    else:
        # the lane kernel gathers (N, B) lane-minor copies: the B values of
        # one vertex share a 32-byte sector (one device-memory read at B = 8)
        B = dist.shape[0]
        out = _launch(
            "minplus_resident_lanes", nbr, wgt, dist.t().contiguous(),
            lab.t().contiguous(), B, block_rows, lanes=B,
        )
        minplus_call.lane_launches += launched
    minplus_call.launches += launched
    return out


minplus_call.launches = 0
minplus_call.lane_launches = 0


def minplus_blocked_call(
    nbr: torch.Tensor,
    wgt: torch.Tensor,
    dist: torch.Tensor,
    lab: torch.Tensor,
    *,
    block_rows: int = 256,
    src_block: int = 1024,
    interpret=None,
):
    """Source-blocked min-plus relaxation (replaces ``minplus_blocked_call``).

    The distance and label vectors are staged through shared memory in
    (src_block,) slices; the output is bitwise equal to :func:`minplus_call`,
    with or without a lane axis (one grid row of blocks a lane).  N need not
    be a multiple of ``src_block``.  ``block_rows`` (at most
    1024) is the number of rows, one thread each, of a thread block.
    ``interpret`` is ignored.
    """
    _check_inputs(nbr, wgt, dist, lab, block_rows)
    if not (isinstance(src_block, int) and src_block >= 1):
        raise ValueError(f"src_block must be a positive int, got {src_block!r}")
    if nbr.device.type == "cpu":
        return minplus_torch(nbr, wgt, dist, lab)
    if block_rows > 1024:
        raise ValueError(f"block_rows={block_rows} exceeds 1024 threads a block")
    if src_block * (4 + dist.element_size()) > _MAX_SMEM:
        raise ValueError(
            f"src_block={src_block} needs more than {_MAX_SMEM} B of shared memory"
        )
    B = dist.shape[0] if dist.dim() == 2 else 1
    launched = nbr.shape[0] > 0
    out = _launch(
        "minplus_blocked", nbr, wgt, dist, lab, dist.shape[-1], src_block, B, block_rows,
        lanes=B if dist.dim() == 2 else None,
    )
    minplus_blocked_call.launches += launched
    if dist.dim() == 2:
        minplus_blocked_call.lane_launches += launched
    return out


minplus_blocked_call.launches = 0
minplus_blocked_call.lane_launches = 0
