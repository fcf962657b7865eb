"""Region inference: which functions must not read a tensor on the host.

The counterpart of ``repro.analysis.regions``.  The port has no
``jax.jit``: its counterpart of a traced region is a **sync-free region**,
code that must not read a tensor's value on the host, because the fake
worlds of the dry-run run it on fake tensors and because on the card every
such read is a stream sync.  A rule like "no ``assert`` on a tensor" is
only useful if it fires three calls away from the region's root and stays
quiet about host code and about *static* values inside a region (shape
checks in the kernel wrappers are load-bearing and legal).

Three passes over the parsed project:

1. **Indexing**: every module's functions (nested defs and methods
   included), import aliases, ``from``-imports and classes.
2. **Roots**: functions that run in a region directly:
   * decorated with :func:`repro_torch.knobs.sync_free` (its ``static=``
     names are the root's static parameters) or ``torch.compile``;
   * passed as a function argument to an entry point that runs them on
     fake or captured tensors: ``torch.utils.checkpoint.checkpoint``,
     ``distributed/sharding.py::local_call``, ``torch.vmap`` and
     ``torch.func.*``, ``torch.compile``, ``make_fx``,
     ``torch.cuda.make_graphed_callables``, and any project function that
     forwards one of its parameters to such an entry (``_remat(fn, ...)``
     calling ``checkpoint(fn, ...)``);
   * ``forward`` / ``backward`` / ``setup_context`` of a
     ``torch.autograd.Function`` subclass;
   * a function whose body opens ``with torch.cuda.graph(...)`` (the
     capture runs its body);
   * the kernels' launch wrappers ``minplus_call``,
     ``minplus_blocked_call`` and ``segmin_bucketed_call`` (the
     counterpart of ``pl.pallas_call``), whose keyword-only parameters are
     static.
3. **Closure + staticness fixpoint**, exactly as the reference's:
   regions propagate through the project-internal call graph and into
   nested defs; a parameter of a non-root function in a region is static
   iff every call site in a region passes a static expression (optimistic,
   monotone, so cycles converge).

Expression staticness (:func:`repro_torch.analysis.rules.is_static`) is
the shared oracle: Python values, ``.shape`` / ``.dtype`` / ``.device``,
``.numel()`` / ``.dim()``, config fields, closure and host variables are
static; tensor parameters, ``torch.*`` results and unknown calls are not.
A parameter is static when a root declares it, when its name is a config
name (``cfg``, ``config``, ``ctx``, ``mesh``, ...) or when it is annotated
with a Python scalar or a ``*Config`` type.

This module imports neither torch nor anything that imports it.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.findings import norm_path

# ---------------------------------------------------------------------------
# region entry points
# ---------------------------------------------------------------------------

# resolved dotted callee -> positions of the function-valued arguments it
# runs in a region
_TORCH_FUNC_ARGS = (
    "vmap", "grad", "grad_and_value", "vjp", "jvp", "jacrev", "jacfwd",
    "hessian", "functionalize", "linearize",
)
TRACE_ARG_CALLS: Dict[str, Tuple[int, ...]] = {
    "torch.utils.checkpoint.checkpoint": (0,),
    "torch.vmap": (0,),
    "torch.compile": (0,),
    "torch.cuda.make_graphed_callables": (0,),
    **{f"torch.func.{name}": (0,) for name in _TORCH_FUNC_ARGS},
}
# callee last segments that run their first argument in a region whatever
# module they resolve to (the port's own entry points, and ``make_fx``
# under its several import paths)
TRACE_ARG_LAST: Dict[str, Tuple[int, ...]] = {
    "local_call": (0,),
    "make_fx": (0,),
    "sync_free": (0,),
}

# decorators (resolved dotted, or the last segment for the port's marker)
# that make the decorated function a root
TRACING_DECORATORS = frozenset({"torch.compile", "torch.func.vmap", "torch.vmap"})
SYNC_FREE = "sync_free"

# the kernels' launch wrappers: roots whose keyword-only params are static
KERNEL_WRAPPERS = frozenset({"minplus_call", "minplus_blocked_call", "segmin_bucketed_call"})

# autograd.Function methods that run on the graph's tensors
AUTOGRAD_METHODS = frozenset({"forward", "backward", "setup_context", "jvp", "vjp"})

# parameter names that carry host objects (configs, meshes, autograd ctx)
STATIC_PARAM_NAMES = frozenset(
    {"cfg", "config", "ctx", "mesh", "opt_cfg", "ocfg", "dcfg", "scfg", "shape"}
)
# annotations that make a parameter a host value
_STATIC_ANNOTATIONS = frozenset({"int", "float", "bool", "str", "tuple", "ShapeSpec"})

# attribute names that are Python values or metadata even on tensors and
# tensor containers: ``x.shape`` / ``x.dtype`` / ``x.device``, and the host
# ints a graph or partition carries (``g.n``, ``part.nb``, ...)
STATIC_ATTRS = frozenset(
    {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
     "n", "nb", "nf", "num_edges", "width", "rows", "n_local", "n_pad",
     "npad", "rb", "eb", "n_blocks", "n_replica", "src_block",
     "slice_width", "slices", "device_mesh", "placements", "mesh_dim_names",
     "requires_grad", "is_leaf"}
)
# tensor methods whose result is a Python value (metadata, not data)
STATIC_METHODS = frozenset(
    {"numel", "dim", "size", "element_size", "stride", "is_contiguous",
     "data_ptr", "get_device", "nelement", "storage_offset",
     "is_floating_point", "is_complex", "ndimension"}
)

# builtins whose result is static when every argument is static
_STATIC_BUILTINS = frozenset(
    {"min", "max", "abs", "sum", "range", "int", "float", "bool", "str",
     "round", "divmod", "sorted", "tuple", "list", "dict", "set", "frozenset",
     "enumerate", "zip", "all", "any", "getattr", "repr", "format", "print",
     "next", "iter", "reversed", "hash", "slice"}
)
# builtins whose result is a Python value whatever their arguments: a
# type or identity check, or a length (a tensor's is its shape[0])
_ALWAYS_STATIC_BUILTINS = frozenset(
    {"isinstance", "issubclass", "callable", "hasattr", "type", "len", "id"}
)


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` attribute chain as a string; None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _last_segment(dotted: Optional[str]) -> Optional[str]:
    return dotted.rsplit(".", 1)[-1] if dotted else None


def _unwrap_partial(
    call: ast.Call,
) -> Tuple[ast.AST, List[ast.keyword], List[ast.AST]]:
    """``functools.partial(f, a, b)`` → (``f``, keywords, ``[a, b]``);
    other calls pass through as (func, keywords, args)."""
    if _last_segment(_dotted(call.func)) == "partial" and call.args:
        inner = call.args[0]
        kws = list(call.keywords)
        if isinstance(inner, ast.Call):
            kws += list(inner.keywords)
            inner = inner.func
        return inner, kws, list(call.args[1:])
    return call.func, list(call.keywords), list(call.args)


def _literal_str_tuple(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """A literal ``("a", "b")`` / ``["a"]`` / ``"a"`` as a tuple of str."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            if not (isinstance(elt, ast.Constant) and isinstance(elt.value, str)):
                return None
            out.append(elt.value)
        return tuple(out)
    return None


_CONTAINER_ANNOTATIONS = frozenset(
    {"Sequence", "Tuple", "List", "Dict", "Optional", "Iterable", "Set", "FrozenSet",
     "tuple", "list", "dict", "set", "frozenset"}
)


def _annotation_static(ann: Optional[ast.AST]) -> bool:
    """True iff an annotation names a host type: a Python scalar, a
    ``*Config``, or a container of those (``Sequence[str]``)."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    if isinstance(ann, ast.Constant):
        return ann.value is Ellipsis or ann.value is None
    if isinstance(ann, ast.Subscript):
        base = _last_segment(_dotted(ann.value)) or ""
        elts = ann.slice.elts if isinstance(ann.slice, ast.Tuple) else [ann.slice]
        return base in _CONTAINER_ANNOTATIONS and all(_annotation_static(e) for e in elts)
    name = _last_segment(_dotted(ann)) or ""
    return name in _STATIC_ANNOTATIONS or name.endswith("Config")


def _host_name(name: str) -> bool:
    """Parameter names that carry host objects: configs, meshes, the
    autograd ctx, and sharding specs."""
    return name in STATIC_PARAM_NAMES or name.endswith(("spec", "specs"))


# ---------------------------------------------------------------------------
# project model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)  # identity hash: used as env-cache key
class FunctionInfo:
    """One function (or method, or nested def) in the project."""

    qualname: str  # dotted within the module, e.g. "EllPatcher.apply"
    module: "ModuleInfo"
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    parent: Optional["FunctionInfo"]
    class_bases: Tuple[str, ...] = ()  # resolved bases of the enclosing class
    # region state (filled by Project.resolve)
    traced: bool = False
    trace_reason: str = ""
    is_root: bool = False
    # declared static params of a root
    root_static: Set[str] = dataclasses.field(default_factory=set)
    # per-parameter staticness in a region (optimistic fixpoint result)
    param_static: Dict[str, bool] = dataclasses.field(default_factory=dict)

    @property
    def params(self) -> List[str]:
        a = self.node.args
        names = [p.arg for p in a.posonlyargs] + [p.arg for p in a.args]
        if a.vararg:
            names.append(a.vararg.arg)
        names += [p.arg for p in a.kwonlyargs]
        if a.kwarg:
            names.append(a.kwarg.arg)
        return names

    @property
    def positional(self) -> List[str]:
        a = self.node.args
        return [p.arg for p in a.posonlyargs] + [p.arg for p in a.args]

    @property
    def kwonly(self) -> List[str]:
        return [p.arg for p in self.node.args.kwonlyargs]

    def host_params(self) -> Set[str]:
        """Parameters that carry host values by name or annotation."""
        a = self.node.args
        out = set()
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if _host_name(p.arg) or _annotation_static(p.annotation):
                out.add(p.arg)
        return out

    def containers(self) -> Set[str]:
        """The ``*args`` / ``**kwargs`` names: testing one tests its length."""
        a = self.node.args
        return {p.arg for p in (a.vararg, a.kwarg) if p is not None}

    def display(self) -> str:
        return f"{self.module.name}.{self.qualname}"


@dataclasses.dataclass
class ModuleInfo:
    path: str
    name: str  # dotted module name, e.g. "repro_torch.core.voronoi"
    tree: ast.Module
    lines: List[str]
    # local alias -> dotted module ("np" -> "numpy", "F" -> "torch.nn.functional")
    import_aliases: Dict[str, str] = dataclasses.field(default_factory=dict)
    # local name -> (source module, original name)
    from_imports: Dict[str, Tuple[str, str]] = dataclasses.field(default_factory=dict)
    functions: Dict[str, FunctionInfo] = dataclasses.field(default_factory=dict)
    top_level: Dict[str, FunctionInfo] = dataclasses.field(default_factory=dict)
    classes: Set[str] = dataclasses.field(default_factory=set)  # top-level class names

    def imports_torch(self) -> bool:
        roots = set(self.import_aliases.values()) | {src for src, _ in self.from_imports.values()}
        return any(r == "torch" or r.startswith("torch.") for r in roots)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def resolve_dotted(self, node: ast.AST) -> Optional[str]:
        """Dotted name of an expression with the leading alias expanded:
        ``checkpoint`` (from ``from torch.utils.checkpoint import
        checkpoint``) → "torch.utils.checkpoint.checkpoint"."""
        d = _dotted(node)
        if d is None:
            return None
        head, _, rest = d.partition(".")
        if head in self.from_imports:
            src, orig = self.from_imports[head]
            base = f"{src}.{orig}"
        elif head in self.import_aliases:
            base = self.import_aliases[head]
        else:
            base = head
        return f"{base}.{rest}" if rest else base


class _ModuleIndexer(ast.NodeVisitor):
    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.stack: List[FunctionInfo] = []
        self.classes: List[Tuple[str, Tuple[str, ...]]] = []

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            local = alias.asname or alias.name.partition(".")[0]
            self.mod.import_aliases[local] = (
                alias.name if alias.asname else alias.name.partition(".")[0])

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.level:  # relative import: resolve against this module
            pkg = self.mod.name.split(".")
            pkg = pkg[: len(pkg) - node.level]
            src = ".".join(pkg + ([node.module] if node.module else []))
        else:
            src = node.module or ""
        for alias in node.names:
            local = alias.asname or alias.name
            self.mod.from_imports[local] = (src, alias.name)

    def _add_function(self, node) -> None:
        parent = self.stack[-1] if self.stack else None
        cls = self.classes[-1] if self.classes and parent is None else None
        if parent is not None:
            prefix = f"{parent.qualname}."
        elif cls is not None:
            prefix = f"{cls[0]}."
        else:
            prefix = ""
        info = FunctionInfo(
            qualname=f"{prefix}{node.name}",
            module=self.mod,
            node=node,
            parent=parent,
            class_bases=cls[1] if cls is not None else (),
        )
        self.mod.functions[info.qualname] = info
        if parent is None and cls is None:
            self.mod.top_level[node.name] = info
        self.stack.append(info)
        saved, self.classes = self.classes, []
        for child in node.body:
            self.visit(child)
        self.classes = saved
        self.stack.pop()

    def visit_FunctionDef(self, node) -> None:
        self._add_function(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        bases = tuple(self.mod.resolve_dotted(b) or "" for b in node.bases)
        name = node.name
        if not self.stack and not self.classes:
            self.mod.classes.add(node.name)
        if self.stack:  # a class inside a function: methods keep its name
            name = f"{self.stack[-1].qualname}.{node.name}"
        saved_stack, self.stack = self.stack, []
        self.classes.append((name, bases))
        for child in node.body:
            self.visit(child)
        self.classes.pop()
        self.stack = saved_stack


def _is_autograd_function(bases: Tuple[str, ...]) -> bool:
    return any(b in ("torch.autograd.Function", "torch.autograd.function.Function")
               for b in bases)


def _opens_cuda_graph(node: ast.AST, mod: ModuleInfo) -> bool:
    """True iff the function body opens ``with torch.cuda.graph(...)``."""
    for sub in ast.walk(node):
        if isinstance(sub, (ast.With, ast.AsyncWith)):
            for item in sub.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call):
                    expr = expr.func
                if mod.resolve_dotted(expr) == "torch.cuda.graph":
                    return True
    return False


class Project:
    """All indexed modules + the resolved region map."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}
        self.by_path: Dict[str, ModuleInfo] = {}

    # -- loading -----------------------------------------------------------

    @staticmethod
    def module_name_for(path: str) -> str:
        parts = [p for p in norm_path(path).split("/") if p]
        if parts[-1].endswith(".py"):
            parts[-1] = parts[-1][:-3]
        if "src" in parts:
            parts = parts[parts.index("src") + 1:]
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts) or "<root>"

    def add_file(self, path: str) -> Optional[ModuleInfo]:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=path)
        except (OSError, SyntaxError):
            return None
        mod = ModuleInfo(
            path=norm_path(path),
            name=self.module_name_for(path),
            tree=tree,
            lines=source.splitlines(),
        )
        _ModuleIndexer(mod).visit(tree)
        self.modules[mod.name] = mod
        self.by_path[mod.path] = mod
        return mod

    @classmethod
    def load(cls, paths) -> "Project":
        proj = cls()
        for p in paths:
            if os.path.isdir(p):
                for root, dirs, files in os.walk(p):
                    dirs[:] = sorted(
                        d for d in dirs
                        if d not in {"__pycache__", ".git", ".venv", "node_modules", "build"}
                    )
                    for f in sorted(files):
                        if f.endswith(".py"):
                            proj.add_file(os.path.join(root, f))
            elif p.endswith(".py"):
                proj.add_file(p)
        proj.resolve()
        return proj

    # -- name resolution ---------------------------------------------------

    def lookup_function(
        self, expr: ast.AST, mod: ModuleInfo, scope: Optional[FunctionInfo]
    ) -> Optional[FunctionInfo]:
        """Resolve an expression naming a function to its FunctionInfo."""
        if isinstance(expr, ast.Call):  # partial(f, …) as a callable
            callee, _, _eff = _unwrap_partial(expr)
            if callee is not expr.func:
                return self.lookup_function(callee, mod, scope)
            return None
        if isinstance(expr, ast.Name):
            name = expr.id
            s = scope
            while s is not None:  # nested defs visible in enclosing scopes
                cand = mod.functions.get(f"{s.qualname}.{name}")
                if cand is not None:
                    return cand
                s = s.parent
            if name in mod.top_level:
                return mod.top_level[name]
            if name in mod.from_imports:
                src, orig = mod.from_imports[name]
                target = self.modules.get(src)
                if target is not None:
                    return target.top_level.get(orig)
            return None
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            alias = expr.value.id
            src = None
            if alias in mod.import_aliases:
                src = mod.import_aliases[alias]
            elif alias in mod.from_imports:  # "from repro_torch.core import voronoi"
                m, orig = mod.from_imports[alias]
                src = f"{m}.{orig}" if m else orig
            if src is not None and src in self.modules:
                return self.modules[src].top_level.get(expr.attr)
        return None

    def lookup_candidates(
        self, expr: ast.AST, mod: ModuleInfo, scope: Optional[FunctionInfo]
    ) -> List[FunctionInfo]:
        """Every function ``expr`` may name: the direct resolution plus,
        for a bare name, functions rebound onto it in an enclosing scope
        (``body = frontier_body`` before ``local_call(body, …)``)."""
        out: List[FunctionInfo] = []
        direct = self.lookup_function(expr, mod, scope)
        if direct is not None:
            out.append(direct)
        if isinstance(expr, ast.Name):
            s = scope
            while s is not None:
                for node in ast.walk(s.node):
                    if not isinstance(node, ast.Assign):
                        continue
                    for t in node.targets:
                        if isinstance(t, ast.Name) and t.id == expr.id:
                            cand = self.lookup_function(node.value, mod, s)
                            if cand is not None and cand not in out:
                                out.append(cand)
                s = s.parent
        return out

    # -- root detection ----------------------------------------------------

    def _make_root(self, fn: FunctionInfo, reason: str, static=()) -> None:
        fn.is_root = True
        fn.traced = True
        if not fn.trace_reason:
            fn.trace_reason = reason
        fn.root_static |= set(static) | fn.host_params()

    def _entry_positions(self, callee: ast.AST, mod: ModuleInfo) -> Optional[Tuple[int, ...]]:
        """Positions of the arguments an entry point runs in a region; None
        if ``callee`` is no entry point (forwarders included)."""
        dotted = mod.resolve_dotted(callee)
        if dotted in TRACE_ARG_CALLS:
            return TRACE_ARG_CALLS[dotted]
        last = _last_segment(dotted)
        if last in TRACE_ARG_LAST:
            return TRACE_ARG_LAST[last]
        return None

    def _find_forwarders(self) -> Dict[FunctionInfo, Tuple[int, ...]]:
        """Project functions that pass one of their own parameters to an
        entry point (``_remat(fn, *args)`` → ``checkpoint(fn, ...)``): a
        call to one runs that argument in a region too."""
        fwd: Dict[FunctionInfo, Tuple[int, ...]] = {}
        changed = True
        while changed:
            changed = False
            for mod in self.modules.values():
                for scope, call in self._iter_calls(mod):
                    if scope is None:
                        continue
                    callee, _kws, eff_args = _unwrap_partial(call)
                    positions = self._entry_positions(callee, mod)
                    if positions is None:
                        target = self.lookup_function(callee, mod, scope)
                        positions = fwd.get(target) if target is not None else None
                    if positions is None:
                        continue
                    pos_params = scope.positional
                    for i in positions:
                        if i < len(eff_args) and isinstance(eff_args[i], ast.Name):
                            name = eff_args[i].id
                            if name in pos_params:
                                j = pos_params.index(name)
                                cur = fwd.get(scope, ())
                                if j not in cur:
                                    fwd[scope] = tuple(sorted(cur + (j,)))
                                    changed = True
        return fwd

    def _detect_roots(self) -> None:
        forwarders = self._find_forwarders()
        for mod in self.modules.values():
            for fn in mod.functions.values():
                node = fn.node
                # decorators
                for dec in getattr(node, "decorator_list", []):
                    call = dec if isinstance(dec, ast.Call) else None
                    target = dec.func if call is not None else dec
                    dotted = mod.resolve_dotted(target)
                    if _last_segment(dotted) == SYNC_FREE:
                        static = ()
                        for kw in call.keywords if call is not None else ():
                            if kw.arg == "static":
                                static = _literal_str_tuple(kw.value) or ()
                        self._make_root(fn, "decorated with sync_free", static)
                    elif dotted in TRACING_DECORATORS:
                        self._make_root(fn, f"decorated with {_dotted(target)}")
                # autograd.Function methods
                if (fn.parent is None and _is_autograd_function(fn.class_bases)
                        and fn.node.name in AUTOGRAD_METHODS):
                    self._make_root(fn, "a torch.autograd.Function method")
                # the kernels' launch wrappers
                if fn.parent is None and not fn.class_bases and fn.node.name in KERNEL_WRAPPERS:
                    self._make_root(fn, "a kernel launch wrapper", fn.kwonly)
                if _opens_cuda_graph(node, mod):
                    self._make_root(fn, "opens a torch.cuda.graph capture")
            # call-argument roots: local_call(f, ...), checkpoint(f, ...), …
            for fn_scope, call in self._iter_calls(mod):
                callee, _kws, eff_args = _unwrap_partial(call)
                positions = self._entry_positions(callee, mod)
                what = _last_segment(_dotted(callee))
                if positions is None:
                    fwd = self.lookup_function(callee, mod, fn_scope)
                    positions = forwarders.get(fwd) if fwd is not None else None
                if positions is None:
                    continue
                for i in positions:
                    if i >= len(eff_args):
                        continue
                    for target in self.lookup_candidates(eff_args[i], mod, fn_scope):
                        if target.is_root:
                            continue
                        target.traced = True
                        if not target.trace_reason:
                            target.trace_reason = f"passed to {what}"

    def _iter_calls(self, mod: ModuleInfo):
        """(enclosing FunctionInfo or None, Call node) for a module."""
        cached = getattr(mod, "_calls", None)
        if cached is not None:
            return cached
        by_node = {id_key(f.node): f for f in mod.functions.values()}
        out: List[Tuple[Optional[FunctionInfo], ast.Call]] = []

        def walk(node: ast.AST, scope: Optional[FunctionInfo]) -> None:
            for child in ast.iter_child_nodes(node):
                child_scope = scope
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    child_scope = by_node.get(id_key(child), scope)
                if isinstance(child, ast.Call):
                    out.append((scope, child))
                walk(child, child_scope)

        walk(mod.tree, None)
        mod._calls = out
        return out

    # -- closure + staticness fixpoint ------------------------------------

    def resolve(self) -> None:
        self._detect_roots()
        changed = True
        while changed:
            changed = False
            for mod in self.modules.values():
                for fn in mod.functions.values():
                    if fn.traced:
                        continue
                    if fn.parent is not None and fn.parent.traced:
                        fn.traced = True
                        fn.trace_reason = f"defined inside {fn.parent.qualname}"
                        changed = True
            # call-graph closure: caller in a region -> project-internal callee
            for mod in self.modules.values():
                for scope, call in self._iter_calls(mod):
                    if scope is None or not scope.traced:
                        continue
                    target = self.lookup_function(call.func, mod, scope)
                    if target is not None and not target.traced:
                        target.traced = True
                        target.trace_reason = f"called from {scope.display()}"
                        changed = True
        self._resolve_param_staticness()

    def traced_functions(self) -> List[FunctionInfo]:
        return [
            fn
            for mod in self.modules.values()
            for fn in mod.functions.values()
            if fn.traced
        ]

    def _called(self, fn: FunctionInfo) -> bool:
        """True iff some call in the project names ``fn`` directly."""
        called = getattr(self, "_called_set", None)
        if called is None:
            called = self._called_set = set()
            for mod in self.modules.values():
                for scope, call in self._iter_calls(mod):
                    target = self.lookup_function(call.func, mod, scope)
                    if target is not None:
                        called.add(target)
        return fn in called

    def lookup_class(self, expr: ast.AST, mod: ModuleInfo) -> bool:
        """True iff ``expr`` names a class defined in the project."""
        if isinstance(expr, ast.Name):
            if expr.id in mod.classes:
                return True
            if expr.id in mod.from_imports:
                src, orig = mod.from_imports[expr.id]
                target = self.modules.get(src)
                return target is not None and orig in target.classes
        return False

    def _resolve_param_staticness(self) -> None:
        from repro_torch.analysis.rules import is_static  # shared oracle

        for fn in self.traced_functions():
            host = fn.host_params()
            if fn.is_root:
                fn.param_static = {p: p in fn.root_static for p in fn.params}
            elif fn.trace_reason.startswith("passed to") or (
                    fn.trace_reason.startswith("defined inside") and not self._called(fn)):
                # callables run by an entry point, and nested defs handed
                # on as values: their params are the region's tensors
                fn.param_static = {p: p in host for p in fn.params}
            else:
                # optimistic init: static until a call site in a region says no
                fn.param_static = {p: True for p in fn.params}
        for _ in range(8):  # fixpoint in a few passes
            changed = False
            self._env_cache = {}  # envs depend on param_static: rebuild
            for mod in self.modules.values():
                for scope, call in self._iter_calls(mod):
                    if scope is None or not scope.traced:
                        continue
                    target = self.lookup_function(call.func, mod, scope)
                    if target is None or not target.traced or target.is_root:
                        continue
                    if target.trace_reason.startswith("passed to") or not self._called(target):
                        continue
                    host = target.host_params()
                    pos = target.positional
                    for i, arg in enumerate(call.args):
                        if isinstance(arg, ast.Starred) or i >= len(pos):
                            continue
                        name = pos[i]
                        if (name not in host and target.param_static.get(name)
                                and not is_static(arg, self, scope)):
                            target.param_static[name] = False
                            changed = True
                    for kw in call.keywords:
                        if kw.arg is None or kw.arg in host:
                            continue
                        if target.param_static.get(kw.arg) and not is_static(
                            kw.value, self, scope
                        ):
                            target.param_static[kw.arg] = False
                            changed = True
            if not changed:
                break
        self._env_cache = {}  # rules re-derive envs from the final fixpoint


def id_key(node: ast.AST) -> Tuple[int, int, int, int]:
    """A stable key of a function node within its module: its position."""
    return (node.lineno, node.col_offset, getattr(node, "end_lineno", 0) or 0,
            getattr(node, "end_col_offset", 0) or 0)
