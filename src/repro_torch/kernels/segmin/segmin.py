"""Bucketed segment min: the wrapper over the Hopper kernel in csrc/segmin.cu.

Counterpart of ``repro.kernels.segmin.segmin.segmin_bucketed_call`` with the
same signature.  A CUDA tensor launches the kernel (or raises); a CPU
tensor takes the plain version
:func:`~repro_torch.kernels.segmin.ref.segmin_bucketed_torch`.  The wrapper
counts its launches in ``segmin_bucketed_call.launches``.

``edge_block`` is the reference's chunk of a bucket's edges a grid step;
it must divide EB, as there, and never changes results (the kernel walks
all of a bucket's edges in one block).  ``interpret`` is ignored.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segmin.ref import segmin_bucketed_torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448  # bytes of shared memory one block can use on Hopper
_P = ctypes.c_void_p
_ARGTYPES = [
    ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P, _P,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _P,
]


def _entry():
    lib = _build.library("segmin")
    fn = lib.segmin_bucketed
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.segmin_error_string.argtypes = [ctypes.c_int]
        lib.segmin_error_string.restype = ctypes.c_char_p
    return lib, fn


def _check_inputs(cand, ldst, lab, src, vb, edge_block):
    dev = cand.device
    if cand.dim() != 2 or cand.dtype not in _DTYPE_CODES:
        raise ValueError(f"cand must be (NB, EB) f32/bf16, got {tuple(cand.shape)} {cand.dtype}")
    for name, t in (("ldst", ldst), ("lab", lab), ("src", src)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cand on {dev}")
        if t.shape != cand.shape or t.dtype != torch.int32:
            raise ValueError(
                f"{name} must be {tuple(cand.shape)} int32, got {tuple(t.shape)} {t.dtype}"
            )
    for name, v in (("vb", vb), ("edge_block", edge_block)):
        if not (isinstance(v, int) and v >= 1):
            raise ValueError(f"{name} must be a positive int, got {v!r}")
    if cand.shape[1] % edge_block:
        raise ValueError(f"EB={cand.shape[1]} is not a multiple of edge_block={edge_block}")
    if dev.type == "cuda":
        for name, t in (("cand", cand), ("ldst", ldst), ("lab", lab), ("src", src)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if 12 * vb > _MAX_SMEM:
            raise ValueError(f"vb={vb} needs more than {_MAX_SMEM} B of shared memory")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: the kernels run on cuda")


def segmin_bucketed_call(
    cand: torch.Tensor,
    ldst: torch.Tensor,
    lab: torch.Tensor,
    src: torch.Tensor,
    *,
    vb: int,
    edge_block: int = 512,
    interpret=None,
):
    """Bucketed lexicographic segment min (replaces the Pallas
    ``segmin_bucketed_call``).

    Args:
      cand: (NB, EB) f32/bf16 per-edge candidates (+inf = inert padding; no
        NaN, no -inf).
      ldst: (NB, EB) int32 destination local to the bucket, in [0, vb).
      lab:  (NB, EB) int32 per-edge label payload.
      src:  (NB, EB) int32 per-edge source payload.
      vb: vertices per bucket.
      edge_block: must divide EB (as in the reference); no effect on results.
      interpret: ignored (no interpreter for a CUDA kernel).

    Returns:
      (m, ml, ms): (NB, vb) lexicographic minima per bucket vertex.
    """
    _check_inputs(cand, ldst, lab, src, vb, edge_block)
    if cand.device.type == "cpu":
        return segmin_bucketed_torch(cand, ldst, lab, src, vb)
    NB, EB = cand.shape
    dev = cand.device
    m = torch.empty((NB, vb), dtype=torch.float32, device=dev)
    ml = torch.empty((NB, vb), dtype=torch.int32, device=dev)
    ms = torch.empty((NB, vb), dtype=torch.int32, device=dev)
    if NB == 0:
        return m, ml, ms
    lib, fn = _entry()
    rc = fn(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        _DTYPE_CODES[cand.dtype], cand.data_ptr(), ldst.data_ptr(), lab.data_ptr(),
        src.data_ptr(), m.data_ptr(), ml.data_ptr(), ms.data_ptr(), NB, EB, vb,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:  # jitlint: ignore[TS02] rc: the C entry point's int error code
        msg = lib.segmin_error_string(rc).decode()
        raise RuntimeError(f"segmin_bucketed launch failed: CUDA error {rc} ({msg})")
    segmin_bucketed_call.launches += 1
    return m, ml, ms


segmin_bucketed_call.launches = 0
