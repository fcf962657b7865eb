"""Min-plus ELL relaxation: wrappers over the Hopper kernels in csrc/minplus.cu.

Counterparts of ``repro.kernels.minplus.minplus`` with the same signatures.
A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version :func:`~repro_torch.kernels.minplus.ref.minplus_torch`.  Each
wrapper counts its launches in ``<wrapper>.launches``.

``dist`` and ``lab`` may carry a leading (B,) lane axis, one row per query
of a batch over the same graph (what ``jax.vmap`` of the Pallas calls
computes); the outputs are then (B, R).  An (N,) or a (1, N) input
launches the single-query kernel (outputs (R,) or (1, R)).
``<wrapper>.lane_launches`` counts the launches that had a lane axis.

The resident kernels gather one record a live slot: :func:`pack_records`
builds that table from ``dist`` and ``lab`` on every call (a kernel of its
own on the card), and the resident kernel's time includes it.

``block_rows`` is the size of one thread block's tile of work: ELL rows for
an (N,) input, (row, lane pair) items with a lane axis (see
:func:`minplus_call`); it never changes results.  ``interpret`` is accepted
for signature parity with the Pallas wrappers and ignored: there is no
interpreter for a CUDA kernel.
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
    "minplus_resident_lanes": [
        ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
    ],
    "minplus_pack_records": [
        ctypes.c_int, ctypes.c_int, _P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P,
    ],
    "minplus_blocked": [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P, _P,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _P,
    ],
}
_MAX_LANES = 65535  # gridDim.y of the blocked kernel
_INF_BITS = 0x7F800000  # +inf as f32 bits
_IMAX = torch.iinfo(torch.int32).max


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


def record_stride(dist: torch.Tensor) -> int:
    """Records a vertex holds in :func:`pack_records`' table: 1 for (N,) and
    (1, N) distances, else B rounded up to an even count (the kernel loads
    two lanes as one 16-byte vector)."""
    B = 1 if dist.dim() == 1 else dist.shape[0]
    return 1 if B == 1 else B + B % 2


def pack_records(dist: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
    """The resident kernels' gather table: one 8-byte record a vertex and a
    lane, ``(dist as f32 bits, lab)``, lane-minor.

    ``dist`` (N,) or (B, N) f32/bf16 (bf16 is upcast to f32, exactly, as
    :func:`minplus_torch` does before its add), ``lab`` int32 of the same
    shape, both contiguous.  Returns (N, stride, 2) int32 with ``stride`` =
    :func:`record_stride`; a padding lane (odd B) holds (+inf, IMAX).  A
    CUDA tensor launches ``pack_records_kernel`` (counted in
    ``pack_records.launches``); a CPU tensor takes the plain version below,
    two strided copies and a fill for odd B.
    """
    d = dist if dist.dim() == 2 else dist[None]
    l = lab if lab.dim() == 2 else lab[None]
    B, N = d.shape
    stride = record_stride(dist)
    rec = torch.empty((N, stride, 2), dtype=torch.int32, device=dist.device)
    if dist.device.type == "cuda":
        if dist.dtype not in _DTYPE_CODES or lab.dtype != torch.int32 or lab.shape != dist.shape:
            raise ValueError(f"pack_records takes f32/bf16 dist and int32 lab of one shape, got "
                             f"{dist.dtype}{tuple(dist.shape)} and {lab.dtype}{tuple(lab.shape)}")
        if not (dist.is_contiguous() and lab.is_contiguous()):
            raise ValueError("dist and lab must be contiguous")
        lib, fn = _entry("minplus_pack_records")
        dev = dist.device
        rc = fn(dev.index if dev.index is not None else torch.cuda.current_device(),
                _DTYPE_CODES[dist.dtype], dist.data_ptr(), lab.data_ptr(), rec.data_ptr(),
                N, B, stride, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            msg = lib.minplus_error_string(rc).decode()
            raise RuntimeError(f"minplus_pack_records launch failed: CUDA error {rc} ({msg})")
        pack_records.launches += N > 0
        return rec
    rec.view(torch.float32)[:, :B, 0].copy_(d.t())
    rec[:, :B, 1].copy_(l.t())
    if stride > B:
        rec[:, B:, 0] = _INF_BITS
        rec[:, B:, 1] = _IMAX
    return rec


pack_records.launches = 0


def _launch(name, nbr, wgt, inputs, dtype_codes, *extra, lanes=None):
    """Launches ``name`` on ``inputs`` (tensors after nbr and wgt) with (R,)
    outputs, or (lanes, R) ones."""
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
        *dtype_codes, nbr.data_ptr(), wgt.data_ptr(), *(t.data_ptr() for t in inputs),
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
      wgt: (R, K) f32/bf16 weights (+inf padding).  On the card, nbr and
        wgt must start on 16 bytes, as a fresh allocation does.
      dist: (N,) or (B, N) f32/bf16 distances (no NaN, no -inf).
      lab: int32 labels, the shape of ``dist``.
      block_rows: work items of one thread block's tile: ELL rows for an
        (N,) input, (row, lane pair) items with a lane axis; rounded to a
        multiple of 8 rows; any R and any K are accepted.
      interpret: ignored (no interpreter for a CUDA kernel).

    Returns:
      (m, ml, ms): (R,) or (B, R) f32 / i32 / i32 per-row lexicographic
      minima.
    """
    _check_inputs(nbr, wgt, dist, lab, block_rows)
    if nbr.device.type == "cpu":
        return minplus_torch(nbr, wgt, dist, lab)
    for name, t in (("nbr", nbr), ("wgt", wgt)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes (the kernel's bulk copies read "
                             "it); pass a fresh tensor, not a view into one")
    launched = nbr.shape[0] > 0
    rec = pack_records(dist, lab)
    lanes = None if dist.dim() == 1 else dist.shape[0]
    out = _launch(
        "minplus_resident_lanes", nbr, wgt, (rec,), (_DTYPE_CODES[wgt.dtype],), lanes or 1,
        record_stride(dist), block_rows, lanes=lanes,
    )
    minplus_call.launches += launched
    if lanes is not None:
        minplus_call.lane_launches += launched
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
    codes = (_DTYPE_CODES[dist.dtype], _DTYPE_CODES[wgt.dtype])
    out = _launch(
        "minplus_blocked", nbr, wgt, (dist, lab), codes, dist.shape[-1], src_block, B,
        block_rows, lanes=B if dist.dim() == 2 else None,
    )
    minplus_blocked_call.launches += launched
    if dist.dim() == 2:
        minplus_blocked_call.lane_launches += launched
    return out


minplus_blocked_call.launches = 0
minplus_blocked_call.lane_launches = 0
