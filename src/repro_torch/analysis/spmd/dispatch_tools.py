"""The program the spmd analyses see: a recording of one run's aten ops.

The counterpart of ``repro.analysis.spmd.jaxpr_tools``.  The port has no
jaxpr; its program is what :class:`Recorder` writes down while a tiny solve
runs: a ``TorchDispatchMode`` records every aten op in order (its name,
the storages of its tensor inputs and outputs, which inputs it writes in
place, its scalar arguments, dtypes and shapes, and its provenance, the
innermost frame outside torch), and a ``TorchFunctionMode`` records the
host reads that dispatch no aten op on the CPU (``.tolist()``,
``.numpy()``, ``.cpu()``).  Collectives (the ``_c10d_functional`` ops and
the in-place ``c10d`` ops) are classified and their groups resolved with
:mod:`repro_torch.launch.roofline`'s tables.

The analyses are symbolic: they read literals, the factories' and ops'
scalar arguments, dtypes and shapes, never a tensor's data.  Values live
in storages: a view shares its base's storage, so an in-place write
through any view is a write of the storage.  The recording keeps every
storage it saw alive until it is dropped, so storage keys are unique
within one recording.  With ``digests=True`` each op also records a hash
of its outputs' bytes, the runtime ground truth the tests hold the
uniformity verdicts against (never read by the analyses).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import sys
import sysconfig
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.analysis.findings import Finding, norm_path
from repro_torch.analysis.suppress import suppresses
from repro_torch.launch.roofline import collective_group, collective_kind

_T = torch.Tensor
# host reads the function mode records (the CPU dispatches no op for them)
_HOST_READS = {_T.tolist: "tolist", _T.numpy: "numpy", _T.__array__: "numpy", _T.cpu: "cpu",
               _T.item: "item", _T.__bool__: "bool", _T.__int__: "int",
               _T.__float__: "float", _T.__index__: "index"}
# factories whose contents are undefined (no value to compare)
UNDEFINED = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                       "new_empty_strided"})
_SKIP_DIRS = tuple(
    os.path.normpath(d) + os.sep
    for d in (os.path.dirname(torch.__file__), sysconfig.get_paths()["stdlib"])
)
_THIS_FILE = os.path.abspath(__file__)


@dataclasses.dataclass
class TensorInfo:
    """What the analyses know of one tensor: its storage, dtype and shape,
    and whether it spans its whole storage (a write through it is total)."""

    storage: int
    dtype: str
    shape: Tuple[int, ...]
    whole: bool


@dataclasses.dataclass
class OpRecord:
    """One recorded op (or host read) of one rank.

    ``args`` / ``kwargs`` hold each argument as ``("t", tensor key)``,
    ``("ts", (tensor keys...))`` or ``("v", python value)`` (dtypes,
    devices and other objects as their text)."""

    index: int
    op: str  # "aten.add.Tensor", "c10d.allreduce_.default", "host.tolist"
    name: str  # the op's short name ("add", "allreduce_", "tolist")
    args: Tuple
    kwargs: Dict[str, tuple]
    inputs: Tuple[int, ...]  # tensor keys read
    outputs: Tuple[int, ...]  # tensor keys returned
    writes: Tuple[int, ...]  # tensor keys written in place
    path: str
    line: int
    line_text: str
    collective: Optional[Tuple[str, Tuple[int, ...]]] = None  # (kind, group ranks)
    host_read: bool = False
    is_view: bool = False
    digest: Optional[str] = None

    def scalars(self) -> Tuple:
        """The non-tensor arguments (what ranks compare)."""
        vals = [a[1] for a in self.args if a[0] == "v"]
        vals += [(k, a[1]) for k, a in sorted(self.kwargs.items()) if a[0] == "v"]
        return tuple(repr(v) for v in vals)

    def arg(self, i: int, name: str, default=None):
        """Positional argument ``i`` or keyword ``name``, as recorded."""
        if i < len(self.args):
            return self.args[i]
        return self.kwargs.get(name, ("v", default))


@dataclasses.dataclass
class Recording:
    """One rank's run: its ops and tensors, its mesh position and the
    tensors it was handed (declared varying axes, or owned)."""

    ops: List[OpRecord]
    tensors: Dict[int, TensorInfo]
    rank: int = 0
    coords: Dict[str, int] = dataclasses.field(default_factory=dict)
    mesh_dims: Dict[str, int] = dataclasses.field(default_factory=dict)
    # group ranks (sorted tuple) -> mesh axes (in mesh order)
    mesh_groups: Dict[Tuple[int, ...], Tuple[str, ...]] = dataclasses.field(default_factory=dict)
    inputs: Dict[int, Tuple[str, ...]] = dataclasses.field(default_factory=dict)  # storage keys
    owned: Tuple[int, ...] = ()  # storage keys

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(self.mesh_dims)


def _rel(path: str) -> str:
    p = norm_path(path)
    for anchor in ("src/repro_torch/", "tests/"):
        idx = p.find("/" + anchor)
        if idx >= 0:
            return p[idx + 1:]
    cwd = norm_path(os.getcwd()) + "/"
    return p[len(cwd):] if p.startswith(cwd) else p


_LINES: Dict[str, List[str]] = {}


def _line_text(path: str, line: int) -> str:
    if path not in _LINES:
        try:
            with open(path, encoding="utf-8") as fh:
                _LINES[path] = fh.read().splitlines()
        except OSError:
            _LINES[path] = []
    lines = _LINES[path]
    return lines[line - 1].strip() if 1 <= line <= len(lines) else ""


def user_frame() -> Tuple[str, int, str]:
    """(repo-relative path, line, stripped text) of the innermost frame
    outside torch, the standard library and this module."""
    f = sys._getframe(1)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if not fn.startswith(_SKIP_DIRS) and fn != _THIS_FILE:
            return _rel(fn), f.f_lineno, _line_text(fn, f.f_lineno)
        f = f.f_back
    return "<op>", 0, ""


def _value(x):
    """A picklable Python value for one non-tensor argument (None for the
    objects that name no value: process groups, reduce ops)."""
    if isinstance(x, torch.ScriptObject):
        return None
    if isinstance(x, (bool, int, float, str)) or x is None:
        return x
    if isinstance(x, (list, tuple)):
        return tuple(_value(v) for v in x)
    return str(x)


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _written_args(func, args, kwargs) -> List[torch.Tensor]:
    """The tensors an op writes in place (schema ``(a!)`` arguments)."""
    out = []
    schema = func._schema
    for i, arg in enumerate(schema.arguments):
        if arg.alias_info is None or not arg.alias_info.is_write:
            continue
        val = args[i] if i < len(args) else kwargs.get(arg.name)
        out += [t for t in tree_leaves(val) if isinstance(t, torch.Tensor)]
    return out


def _digest(ts: Sequence[torch.Tensor]) -> str:
    h = hashlib.sha1()
    for t in ts:
        t = t.detach()
        if t.is_complex() or t.dtype == torch.bfloat16:
            t = t.float()
        h.update(str(t.dtype).encode())
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


class _State:
    def __init__(self, digests: bool):
        self.digests = digests
        self.ops: List[OpRecord] = []
        self.tensors: Dict[int, TensorInfo] = {}
        self.keys = WeakTensorKeyDictionary()
        self.keep: list = []  # every tensor and storage seen, kept alive
        self.busy = 0
        # a collective's digest waits for its result: the caller waits on
        # its work after the op returns, before the next op runs
        self.pending = None
        self.undefined = set()  # storages of empty() not written since

    def flush(self) -> None:
        if self.pending is not None:
            rec, ts = self.pending
            self.pending = None
            self.busy += 1
            try:
                rec.digest = _digest(ts)
            finally:
                self.busy -= 1

    def key(self, t: torch.Tensor) -> int:
        """The tensor's key (its storage recorded with it)."""
        k = self.keys.get(t)
        if k is None:
            k = self.keys[t] = len(self.keep)
            st = t.untyped_storage()
            self.keep += [t, st]
            self.tensors[k] = TensorInfo(
                storage=st._cdata, dtype=str(t.dtype), shape=tuple(t.shape),
                whole=t.numel() * t.element_size() >= st.nbytes())
        return k

    def encode(self, a):
        if isinstance(a, torch.Tensor):
            return ("t", self.key(a))
        if isinstance(a, (list, tuple)) and a and all(
                isinstance(t, torch.Tensor) or t is None for t in a):
            return ("ts", tuple(None if t is None else self.key(t) for t in a))
        return ("v", _value(a))

    def add(self, **kw) -> OpRecord:
        self.flush()
        path, line, text = user_frame()
        rec = OpRecord(index=len(self.ops), path=path, line=line, line_text=text, **kw)
        self.ops.append(rec)
        return rec


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


class _Functions(TorchFunctionMode):
    def __init__(self, state: _State):
        super().__init__()
        self.s = state

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = _HOST_READS.get(func)
        s = self.s
        if kind is None or s.busy or not args or not isinstance(args[0], torch.Tensor):
            return func(*args, **kwargs)
        k = s.key(args[0])
        s.add(op=f"host.{kind}", name=kind, args=(("t", k),), kwargs={}, inputs=(k,),
              outputs=(), writes=(), host_read=True)
        s.busy += 1
        try:
            return func(*args, **kwargs)
        finally:
            s.busy -= 1


class _Ops(TorchDispatchMode):
    def __init__(self, state: _State):
        super().__init__()
        self.s = state

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        s = self.s
        if s.busy:
            return out
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        written = _written_args(func, args, kwargs)
        coll = None
        if ns in ("_c10d_functional", "c10d"):
            kind = collective_kind(ns, name)
            if kind is None:
                return out
            import torch.distributed as dist

            pg = collective_group(ns, args)
            coll = (kind, tuple(sorted(dist.get_process_group_ranks(pg))))
            if ns == "c10d":
                written = _tensors(args[0])
        s.busy += 1
        try:
            rec = s.add(
                op=f"{ns}.{name}.{func._overloadname}",
                name=name,
                args=tuple(s.encode(a) for a in args),
                kwargs={k: s.encode(v) for k, v in kwargs.items()},
                inputs=tuple(s.key(t) for t in _tensors((args, kwargs))),
                outputs=tuple(s.key(t) for t in _tensors(out)),
                writes=tuple(s.key(t) for t in written),
                collective=coll,
                host_read=name == "_local_scalar_dense",
                is_view=_is_view(func),
            )
            for t in written:
                s.undefined.discard(s.tensors[s.key(t)].storage)
            if name in UNDEFINED:
                s.undefined.update(s.tensors[k].storage for k in rec.outputs)
            shown = written or _tensors(out)
            if s.digests and coll is not None:
                s.pending = (rec, shown)
            elif s.digests and not any(s.tensors[s.key(t)].storage in s.undefined
                                       for t in shown):
                rec.digest = _digest(shown)
        finally:
            s.busy -= 1
        return out


class Recorder:
    """Records the ops of the block it guards::

        with Recorder() as rec:
            handle.solve(seeds)
        rec.recording(inputs={...})
    """

    def __init__(self, digests: bool = False):
        self.state = _State(digests)
        self._modes = (_Functions(self.state), _Ops(self.state))

    def __enter__(self) -> "Recorder":
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        for m in reversed(self._modes):
            m.__exit__(*exc)
        self.state.flush()

    def storage(self, t: torch.Tensor) -> int:
        """The storage key of a tensor made before the recording."""
        return self.state.tensors[self.state.key(t)].storage

    def recording(self, *, mesh=None, inputs=None, owned=()) -> Recording:
        """The recording, with ``mesh`` (a :class:`repro_torch.core.mesh.Mesh`
        or None), ``inputs`` {tensor: mesh axes it is split along} and the
        ``owned`` tensors the region may write."""
        for t in list(inputs or {}) + list(owned):
            self.state.key(t)
        rec = Recording(ops=list(self.state.ops), tensors=dict(self.state.tensors))
        if mesh is not None:
            rec.rank = mesh.rank
            rec.coords = dict(mesh.coords)
            rec.mesh_dims = dict(mesh.shape)
            rec.mesh_groups = mesh_groups(mesh)
        for t, axes in (inputs or {}).items():
            rec.inputs[self.storage(t)] = tuple(axes)
        rec.owned = tuple(self.storage(t) for t in owned)
        return rec


def mesh_groups(mesh) -> Dict[Tuple[int, ...], Tuple[str, ...]]:
    """{sorted ranks of this rank's group over axes: axes} for every
    non-empty tuple of the mesh's axes."""
    import torch.distributed as dist

    out = {}
    for axes, g in mesh._groups.items():
        out[tuple(sorted(dist.get_process_group_ranks(g)))] = tuple(axes)
    return out


# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Violation:
    """One semantic-rule violation at one recorded op (no context yet)."""

    rule: str
    message: str
    op: OpRecord

    def to_finding(self, context: str) -> Optional[Finding]:
        """Renders against one backend/mode context; honors per-line
        ``# jitlint: ignore[...]`` comments on the op's source line (None =
        suppressed)."""
        op = self.op
        if op.line_text and suppresses(op.line_text, self.rule):
            return None
        return Finding(rule=self.rule, path=op.path, line=op.line, col=0,
                       message=f"[{op.name}] {self.message}", context=context,
                       line_text=op.line_text)
