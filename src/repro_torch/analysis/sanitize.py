"""Runtime trace-safety sanitizer: the dynamic half of jitlint.

The counterpart of ``repro.analysis.sanitize``.  Static analysis (rules
TS01–TS07) proves hazards in the source; these guards count what only a
run shows, on the CPU and on the card alike:

* :func:`host_read_guard`: reads of a tensor's value on the host (the
  counterpart of ``jax.transfer_guard("disallow")``).  A
  ``TorchFunctionMode`` sees ``Tensor.item`` / ``tolist`` / ``numpy`` /
  ``__array__`` / ``__bool__`` / ``__int__`` / ``__float__`` /
  ``__index__`` and copies to the host (``.cpu()``, ``.to("cpu")``); a
  ``TorchDispatchMode`` sees the reads made below Python
  (``_local_scalar_dense``), device-to-host copies and the ops whose
  output shape depends on the data (``nonzero``, ``unique``,
  ``masked_select``, boolean-mask indexing, ``repeat_interleave`` without
  ``output_size``, ``bincount``).  The function mode is needed because
  ``.tolist()`` and ``.numpy()`` of a CPU tensor dispatch no aten op; a
  read seen by both counts once, and ``.numpy()`` of the tensor a counted
  ``.cpu()`` just returned counts nothing more, so one solve counts the
  same reads on the CPU and on the card.
* :func:`h2d_guard`: copies from the CPU onto the card.
* :func:`rebuild_guard`: memo misses (``graph_cached`` builds, kernel
  libraries loaded) through :func:`repro_torch.knobs.build_count` (the
  counterpart of the reference's retrace guard).

Each guard counts and, with ``allow`` set, raises
:class:`TraceSafetyError` past it.  No guard changes a result: the modes
only watch the calls they pass on.  :func:`sanitizer` arms all three and,
on a CUDA device, ``torch.cuda.set_sync_debug_mode("warn")``, whose
warnings it counts beside its own reads::

    handle = solver.prepare(graph)
    handle.solve(seeds)                    # cold: builds, syncs freely
    with sanitize.sanitizer() as rep:      # warm: zero rebuilds
        out = handle.solve(seeds)
    rep.host_reads, rep.h2d, rep.rebuilds
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Dict, Iterator, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.knobs import build_count


class TraceSafetyError(AssertionError):
    """A guarded region read, copied or rebuilt more than it was allowed."""


_T = torch.Tensor
# Tensor methods that read the value on the host, by name
_READ_METHODS = {
    _T.item: "item", _T.tolist: "tolist", _T.numpy: "numpy", _T.__array__: "__array__",
    _T.__bool__: "__bool__", _T.__int__: "__int__", _T.__float__: "__float__",
    _T.__index__: "__index__",
}
_FETCH_METHODS = {_T.cpu: "cpu", _T.to: "to"}
# aten ops whose output shape the data decides: the host reads a count
_DATA_SHAPE_OPS = frozenset(
    {"nonzero", "_unique", "_unique2", "unique_dim", "unique_consecutive",
     "masked_select", "bincount", "repeat_interleave"}
)


def _is_cpu(device) -> bool:
    return device is not None and torch.device(device).type == "cpu"


def _to_target(args, kwargs):
    """The device a ``Tensor.to`` call moves to, if it names one."""
    if "device" in kwargs:
        return kwargs["device"]
    for a in args[1:]:
        if isinstance(a, (str, torch.device)):
            return a
        if isinstance(a, torch.Tensor):
            return a.device
    return None


def _bool_index(indices) -> bool:
    return any(isinstance(t, torch.Tensor) and t.dtype in (torch.bool, torch.uint8)
               for t in indices or ())


@dataclasses.dataclass
class SanitizerReport:
    """What a guarded region did: host reads (by kind), copies onto the
    card, memo rebuilds, and ``sync_debug_mode`` warnings (None off the
    card)."""

    host_reads: int = 0
    # the reads the dispatch mode alone sees (nested ones included): equal
    # to ``host_reads`` on the card, fewer on the CPU
    dispatch_reads: int = 0
    h2d: int = 0
    rebuilds: int = 0
    sync_warnings: Optional[int] = None
    reads_by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)


class _Watch:
    """A function mode and a dispatch mode that count into one report."""

    def __init__(self, report: SanitizerReport, *, reads: bool, h2d: bool,
                 allow_reads: Optional[int], allow_h2d: Optional[int]):
        self.report = report
        self.reads, self.h2d = reads, h2d
        self.allow_reads, self.allow_h2d = allow_reads, allow_h2d
        self.depth = 0  # inside a read the function mode counted
        self.fetched = WeakTensorKeyDictionary()  # .cpu() results: tensor -> version

    def read(self, kind: str) -> None:
        rep = self.report
        rep.host_reads += 1
        rep.reads_by_kind[kind] = rep.reads_by_kind.get(kind, 0) + 1
        if self.allow_reads is not None and rep.host_reads > self.allow_reads:
            raise TraceSafetyError(
                f"host read #{rep.host_reads} ({kind}) in a guarded region "
                f"(allowed {self.allow_reads}): a tensor's value was read on the host")

    def copy_in(self) -> None:
        rep = self.report
        rep.h2d += 1
        if self.allow_h2d is not None and rep.h2d > self.allow_h2d:
            raise TraceSafetyError(
                f"host-to-device copy #{rep.h2d} in a guarded region (allowed "
                f"{self.allow_h2d})")


class _ReadFunctions(TorchFunctionMode):
    def __init__(self, watch: _Watch):
        super().__init__()
        self.w = watch

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        w = self.w
        kind = _READ_METHODS.get(func)
        fetch = _FETCH_METHODS.get(func)
        if fetch == "to" and not _is_cpu(_to_target(args, kwargs)):
            fetch = None
        if kind is not None and kind in ("numpy", "__array__"):
            src = args[0]
            if w.fetched.get(src) == src._version:
                kind = None  # the .cpu() that made it was the read
        if w.depth or (kind is None and fetch is None) or not w.reads:
            return func(*args, **kwargs)
        w.read(kind or fetch)
        w.depth += 1
        try:
            out = func(*args, **kwargs)
        finally:
            w.depth -= 1
        if fetch is not None and isinstance(out, torch.Tensor):
            w.fetched[out] = out._version
        return out


class _ReadOps(TorchDispatchMode):
    def __init__(self, watch: _Watch):
        super().__init__()
        self.w = watch

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        w = self.w
        name = func._schema.name.split("::")[-1]
        kind = None
        if name == "_local_scalar_dense":
            kind = name
        elif name in _DATA_SHAPE_OPS:
            if name != "repeat_interleave" or kwargs.get("output_size") is None:
                kind = name
        elif name in ("index", "index_put", "index_put_") and _bool_index(
                args[1] if len(args) > 1 else kwargs.get("indices")):
            kind = f"{name}[mask]"
        elif name in ("_to_copy", "copy_"):
            src = args[1] if name == "copy_" else args[0]
            dst_dev = (args[0].device if name == "copy_"
                       else kwargs.get("device") or src.device)
            src_cpu, dst_cpu = src.device.type == "cpu", torch.device(dst_dev).type == "cpu"
            if dst_cpu and not src_cpu:
                kind = f"{name} to host"
            if w.h2d and src_cpu and not dst_cpu:
                w.copy_in()
        if kind is not None and w.reads:
            w.report.dispatch_reads += 1
            if not w.depth:
                w.read(kind)
        return func(*args, **kwargs)


@contextlib.contextmanager
def _watching(report: SanitizerReport, *, reads: bool, h2d: bool,
              allow_reads: Optional[int] = None, allow_h2d: Optional[int] = None):
    w = _Watch(report, reads=reads, h2d=h2d, allow_reads=allow_reads, allow_h2d=allow_h2d)
    with _ReadFunctions(w), _ReadOps(w):
        yield report


@contextlib.contextmanager
def host_read_guard(allow: Optional[int] = None) -> Iterator[SanitizerReport]:
    """Counts host reads of tensor values inside the block (its report's
    ``host_reads`` and ``reads_by_kind``); raises
    :class:`TraceSafetyError` at the read past ``allow`` (None: count
    only)."""
    with _watching(SanitizerReport(), reads=True, h2d=False, allow_reads=allow) as rep:
        yield rep


@contextlib.contextmanager
def h2d_guard(allow: Optional[int] = None) -> Iterator[SanitizerReport]:
    """Counts copies from the CPU onto the card inside the block (its
    report's ``h2d``); raises past ``allow`` (None: count only)."""
    with _watching(SanitizerReport(), reads=False, h2d=True, allow_h2d=allow) as rep:
        yield rep


@contextlib.contextmanager
def rebuild_guard(key: Optional[str] = None, allow: int = 0) -> Iterator[SanitizerReport]:
    """Fails if more than ``allow`` memo misses of kind ``key`` ("view",
    "library"; None: every kind) happen inside the block
    (:func:`repro_torch.knobs.build_count`)."""
    rep = SanitizerReport()
    base = build_count(key)
    try:
        yield rep
    finally:
        rep.rebuilds = build_count(key) - base
    if rep.rebuilds > allow:
        what = f"memo {key!r}" if key else "the memos"
        raise TraceSafetyError(
            f"{what} built {rep.rebuilds} new artifact(s) inside a warm region "
            f"(allowed {allow}): a memo key drifted from the knobs its build reads "
            "or an input changed identity (rule TS06 at run time)")


@contextlib.contextmanager
def sanitizer(*, device=None) -> Iterator[SanitizerReport]:
    """Arms the three guards around a warm region; yields one report.

    Host reads and copies onto the card are counted; a memo rebuild
    raises (a warm region builds nothing).  Limits on reads or copies are
    the single guards' (:func:`host_read_guard`, :func:`h2d_guard`).

    Args:
      device: on a CUDA device, also count ``set_sync_debug_mode("warn")``
        warnings into ``sync_warnings``.
    """
    with contextlib.ExitStack() as stack:
        rep = stack.enter_context(rebuild_guard())
        if device is not None and torch.device(device).type == "cuda":
            caught = stack.enter_context(warnings.catch_warnings(record=True))
            warnings.simplefilter("always")
            stack.callback(lambda: setattr(rep, "sync_warnings", sum(
                "synchroniz" in str(m.message) for m in caught)))
            stack.callback(torch.cuda.set_sync_debug_mode, torch.cuda.get_sync_debug_mode())
            torch.cuda.set_sync_debug_mode("warn")
        stack.enter_context(_watching(rep, reads=True, h2d=True))
        yield rep
