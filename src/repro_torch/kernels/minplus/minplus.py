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

Both kernels gather one record a live slot: :func:`pack_records` builds
that table from ``dist`` and ``lab`` on every call (a kernel of its own on
the card), and the kernels' times include it.

The source-blocked kernel gathers from one source slice a launch, a whole
number of ``src_block`` blocks whose records fit an L2 budget, folding the
slices into the output in order.  It reads the adjacency through a
per-graph :class:`BlockedLayout` (:func:`blocked_layout`): the live slots
sorted by (slice, row).  Callers that relax one graph many times build it
once and pass it; a call without one builds it.

``block_rows`` is the size of one thread block's tile of work: ELL rows (or
the layout's runs) for an (N,) input, (row or run, lane pair) items with a
lane axis (see :func:`minplus_call`); it never changes results.
``interpret`` is accepted for signature parity with the Pallas wrappers and
ignored: there is no interpreter for a CUDA kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.minplus.ref import minplus_torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

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
        ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        _P,
    ],
}
_MAX_LANES = 65535  # lanes a call takes
# Record bytes a one-lane source slice may hold (8 B a vertex), and the lanes
# a blocked launch folds together: the fastest of the values tried at full
# width on an H100 (chip_smoke.py times them; see PERF.md).
L2_BUDGET = 24 << 20
LANE_GROUP = 8
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
        if rc != 0:  # jitlint: ignore[TS02] rc: the C entry point's int error code
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
    if rc != 0:  # jitlint: ignore[TS02] rc: the C entry point's int error code
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


@dataclasses.dataclass(frozen=True)
class BlockedLayout:
    """An ELL's live slots grouped by source slice, for the blocked kernel.

    A slice is vertices ``[s * slice_width, (s + 1) * slice_width)``.  Runs
    are sorted by (slice, row): run j holds the live slots (finite weight)
    of one row whose neighbor falls in one slice, at
    ``slot_nbr[run_off[j]:run_off[j + 1]]`` (and ``slot_wgt``).
    ``run_row[j]`` is the row, or ``~row`` when the row has a run in an
    earlier slice (the kernel then merges into its triple instead of
    writing a fresh one).  Every row with no live slot has an empty run in
    the first slice, so every row is written.  ``slices`` lists the
    (first run, runs) of each slice that has runs, in order: one kernel
    launch each.  All four arrays are padded past their end (the kernel's
    bulk copies are aligned out to 8 slots and 4 runs).  The layout holds
    no lane count: any number of lanes may fold over it.
    """

    n: int
    rows: int
    width: int
    src_block: int
    slice_width: int
    slot_nbr: torch.Tensor
    slot_wgt: torch.Tensor
    run_row: torch.Tensor
    run_off: torch.Tensor
    slices: tuple
    _caps: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def num_runs(self) -> int:
        return sum(n for _, n in self.slices)

    def tile_cap(self, runs: int) -> int:
        """The most slots any tile of ``runs`` consecutive runs of a slice
        spans, its ends aligned out to 8 slots: what a kernel stage must
        hold (memoized; one host sync the first time)."""
        cap = self._caps.get(runs)
        if cap is None:
            off = self.run_off
            starts = torch.cat([torch.arange(r0, r0 + n, runs, device=off.device)
                                for r0, n in self.slices])
            ends = torch.cat([torch.arange(r0, r0 + n, runs, device=off.device).add_(runs)
                              .clamp_(max=r0 + n) for r0, n in self.slices])
            span = ((off[ends] + 7) & ~7) - (off[starts] & ~7)
            cap = self._caps[runs] = int(span.max()) if span.numel() else 0
        return cap


def slice_budget(lanes: bool) -> int:
    """Record bytes (8 a vertex) a source slice may hold: :data:`L2_BUDGET`
    for a layout that serves one lane; a layout that serves a lane axis
    takes the whole table in one slice (at B = 8, each slice more costs a
    read and a write of the (B, R) output triples that outweigh what its
    L2 hits save: see PERF.md)."""
    return 1 << 62 if lanes else L2_BUDGET


def slice_width(n: int, src_block: int, budget: int) -> int:
    """Vertices of one source slice: the largest multiple of ``src_block``
    whose records (8 bytes a vertex) fit ``budget`` bytes, at least one
    block; at most n rounded up to a block."""
    blocks = max(1, budget // (8 * src_block))
    return src_block * min(blocks, max(1, -(-n // src_block)))


def blocked_stride(lanes: int) -> int:
    """Record stride of the lane groups a blocked call with ``lanes`` lanes
    folds, one group of up to :data:`LANE_GROUP` lanes at a time; also the
    lanes of a group (an odd group's stride covers it)."""
    g = min(lanes, LANE_GROUP)
    return 1 if g == 1 else g + g % 2


def blocked_layout(
    nbr: torch.Tensor,
    wgt: torch.Tensor,
    n: int,
    src_block: int,
    lanes: bool = False,
    *,
    budget: "int | None" = None,
) -> BlockedLayout:
    """Builds the :class:`BlockedLayout` of an (R, K) ELL on its device.

    Slices are :func:`slice_width` wide for ``budget`` bytes of records
    (default :func:`slice_budget` of ``lanes``, whether the layout will
    serve a lane axis).  Counted in ``blocked_layout.builds``.  One host
    sync (the slice boundaries).  Raises if a live slot's neighbor is
    outside [0, n).
    """
    if not (isinstance(src_block, int) and src_block >= 1):
        raise ValueError(f"src_block must be a positive int, got {src_block!r}")
    if nbr.dim() != 2 or nbr.dtype != torch.int32 or wgt.shape != nbr.shape:
        raise ValueError("nbr and wgt must be (R, K), nbr int32")
    R, K = nbr.shape
    dev = nbr.device
    width = slice_width(n, src_block, slice_budget(lanes) if budget is None else budget)
    flat = torch.isfinite(wgt).view(-1).nonzero().squeeze(1)  # live slots, row-major
    rows = flat // max(K, 1)
    v = nbr.view(-1)[flat]
    key = (v // width).to(torch.int64) * R + rows  # (slice, row)
    key, order = torch.sort(key, stable=True)
    del rows
    E = key.shape[0]
    padded = -(-E // 8) * 8 + 8
    slot_nbr = torch.zeros(padded, dtype=torch.int32, device=dev)
    slot_wgt = torch.full((padded,), float("inf"), dtype=wgt.dtype, device=dev)
    slot_nbr[:E] = v[order]
    slot_wgt[:E] = wgt.view(-1)[flat[order]]
    del flat, order
    keys, counts = torch.unique_consecutive(key, return_counts=True)
    del key
    # rows with no live slot: an empty run each in the first slice
    has = torch.zeros(R, dtype=torch.bool, device=dev)
    has[keys % max(R, 1)] = True
    empty = (~has).nonzero().squeeze(1)
    keys = torch.cat([keys, empty])
    counts = torch.cat([counts, torch.zeros_like(empty)])
    keys, order = torch.sort(keys)
    counts = counts[order]
    run_slice = keys // max(R, 1)
    run_row = keys % max(R, 1)
    first = torch.full((R,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, run_row, run_slice, "amin")
    runs = keys.shape[0]
    code = torch.zeros(runs + 8, dtype=torch.int32, device=dev)
    code[:runs] = torch.where(run_slice == first[run_row], run_row, ~run_row)
    run_off = torch.zeros(runs + 1 + 8, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=run_off[1:runs + 1])
    run_off[runs + 1:] = E
    # slice boundaries and the neighbor range, in one host read
    ids = torch.unique_consecutive(run_slice)
    bounds = torch.searchsorted(run_slice, torch.cat([ids, ids[-1:] + 1]))
    lo_hi = torch.stack([v.min(), v.max()]) if E else torch.zeros(2, dtype=torch.int32,
                                                                   device=dev)
    host = torch.cat([bounds, lo_hi.to(bounds.dtype)]).tolist()
    cuts, (lo, hi) = host[:-2], host[-2:]
    if E and not (0 <= lo and hi < n):
        raise ValueError(f"a live slot's neighbor is outside [0, {n}): {[lo, hi]}")
    blocked_layout.builds += 1
    return BlockedLayout(
        n=n, rows=R, width=K, src_block=src_block, slice_width=width,
        slot_nbr=slot_nbr, slot_wgt=slot_wgt, run_row=code, run_off=run_off,
        slices=tuple((a, b - a) for a, b in zip(cuts[:-1], cuts[1:])),
    )


blocked_layout.builds = 0


def minplus_blocked_call(
    nbr: torch.Tensor,
    wgt: torch.Tensor,
    dist: torch.Tensor,
    lab: torch.Tensor,
    *,
    block_rows: int = 256,
    src_block: int = 1024,
    interpret=None,
    layout: "BlockedLayout | None" = None,
):
    """Source-blocked min-plus relaxation (replaces ``minplus_blocked_call``).

    Bitwise equal to :func:`minplus_call`, with or without a lane axis; any
    N and any ``src_block``.  On the card each launch gathers from one
    source slice of ``layout`` (built here, from nbr and wgt, if not given:
    :func:`blocked_layout` for one lane or a lane axis), the slices in
    order; lanes go in groups of :func:`blocked_stride` lanes, one launch a
    (group, slice), each counted.  ``block_rows`` is the tile's
    (run, lane pair) items; ``interpret`` is ignored.  A CPU tensor takes
    the plain version, :func:`minplus_torch`, and ignores ``layout``.
    """
    _check_inputs(nbr, wgt, dist, lab, block_rows)
    if not (isinstance(src_block, int) and src_block >= 1):
        raise ValueError(f"src_block must be a positive int, got {src_block!r}")
    if nbr.device.type == "cpu":
        return minplus_torch(nbr, wgt, dist, lab)
    R, K = nbr.shape
    B = 1 if dist.dim() == 1 else dist.shape[0]
    N = dist.shape[-1]
    if layout is None:
        layout = blocked_layout(nbr, wgt, N, src_block, dist.dim() == 2 and B > 1)
    got = (layout.n, layout.rows, layout.width, layout.src_block, layout.slot_wgt.dtype,
           layout.slot_nbr.device)
    if got != (N, R, K, src_block, wgt.dtype, nbr.device):
        raise ValueError(f"layout (n, R, K, src_block, dtype, device) = {got} does not fit "
                         f"these inputs {(N, R, K, src_block, wgt.dtype, nbr.device)}")
    shape = (R,) if dist.dim() == 1 else (B, R)
    out = tuple(torch.empty(shape, dtype=t, device=nbr.device)
                for t in (torch.float32, torch.int32, torch.int32))
    if R == 0:
        return out
    lib, fn = _entry("minplus_blocked")
    dev = nbr.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    group = blocked_stride(B)
    launched = 0
    for g0 in range(0, B, group):
        lanes = min(group, B - g0)
        d = dist if dist.dim() == 1 else dist[g0:g0 + lanes]
        rec = pack_records(d, lab if lab.dim() == 1 else lab[g0:g0 + lanes])
        stride = record_stride(d)
        # a tile: about block_rows (run, lane pair) items, a multiple of 8 runs
        tile = max(8, block_rows // max(1, stride // 2) // 8 * 8)
        cap = layout.tile_cap(tile)
        ptrs = [t.data_ptr() + g0 * R * 4 for t in out]
        for run0, nruns in layout.slices:
            rc = fn(dev.index if dev.index is not None else torch.cuda.current_device(),
                    _DTYPE_CODES[wgt.dtype], layout.slot_nbr.data_ptr(),
                    layout.slot_wgt.data_ptr(), layout.run_row.data_ptr(),
                    layout.run_off.data_ptr(), run0, nruns, tile, cap, rec.data_ptr(), *ptrs,
                    R, lanes, stride, stream)
            if rc != 0:  # jitlint: ignore[TS02] rc: the C entry point's int error code
                msg = lib.minplus_error_string(rc).decode()
                raise RuntimeError(f"minplus_blocked launch failed: CUDA error {rc} ({msg})")
            launched += 1
    minplus_blocked_call.launches += launched
    if dist.dim() == 2:
        minplus_blocked_call.lane_launches += launched
    return out


minplus_blocked_call.launches = 0
minplus_blocked_call.lane_launches = 0
