"""The trace-safety rules (TS01–TS07) and the expression staticness oracle.

The counterpart of ``repro.analysis.rules``: the same rule ids, each with
its hazard in PyTorch's meaning.  A region is a sync-free region
(:mod:`repro_torch.analysis.regions`); a non-static value there is a
tensor (or may be one).

  TS01  ``assert`` on a tensor in a region (a host sync, and a fake
        tensor cannot answer it)
  TS02  Python ``if`` / ``while`` / ``match`` / ``bool()`` / conditional
        expression on a tensor in a region
  TS03  a host read in a region: ``.item()`` / ``.tolist()`` / ``.cpu()``
        / ``.numpy()``, ``float()`` / ``int()`` of a tensor, ``np.*`` on a
        tensor, and the ops whose output shape depends on the data
        (``nonzero``, ``unique``, ``masked_select``, ``bincount``,
        boolean-mask indexing, ``repeat_interleave`` without
        ``output_size``, one-argument ``torch.where``)
  TS04  ``id()``-keyed identity (ids are reused after gc); host code too
  TS05  array construction from unordered ``set`` iteration
        (nondeterministic layout); host code too
  TS06  memo-key drift at ``graph_cached(g, (<literal key>), build)``: the
        build reads a ``cfg.<view knob>`` the key omits, the key names a
        ``cfg.<solve knob>``, or the key names a ``cfg.`` field that is
        neither (:mod:`repro_torch.knobs`); host code too
  TS07  an ``obs`` span or telemetry call in a region that no static gate
        guards

``SUP01`` is the meta-rule: a scoped suppression comment
(``# jitlint: ignore[TS03]``) naming a rule id no analyzer layer knows.

Staticness (:func:`is_static`) is two-sided as in the reference:
optimistic for host values (closure variables, module globals, shape
attributes, config fields) so the wrappers' shape checks stay quiet,
pessimistic for anything that could be a tensor (tensor parameters,
``torch.*`` results, unknown calls).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch import knobs
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.regions import (
    STATIC_ATTRS,
    STATIC_METHODS,
    _ALWAYS_STATIC_BUILTINS,
    _STATIC_BUILTINS,
    _dotted,
    _last_segment,
    FunctionInfo,
    ModuleInfo,
    Project,
)
from repro_torch.analysis.suppress import (
    SUPPRESS_MARKER,
    suppresses,
    unknown_rule_ids,
)

# numpy and math results are host values, but calling them on a tensor
# reads it on the host (TS03)
_HOST_CALL_PREFIXES = ("numpy.", "math.")
_TENSOR_CALL_PREFIXES = ("torch.",)
# torch calls whose result is a Python value or host object
_HOST_TORCH_CALLS = frozenset(
    {"torch.iinfo", "torch.finfo", "torch.device", "torch.Size", "torch.is_tensor",
     "torch.is_grad_enabled", "torch.get_default_dtype", "torch.promote_types",
     "torch.cuda.is_available", "torch.cuda.current_device", "torch.cuda.device_count",
     "torch.distributed.get_rank", "torch.distributed.get_world_size",
     "torch.distributed.is_initialized", "torch.is_floating_point"}
)
# methods that read a tensor's value on the host
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy", "__array__"})
_SYNC_CALLS = frozenset({"float", "int", "complex"})
# host reads whose result is a Python value or a numpy array
_HOST_VALUE_METHODS = frozenset({"item", "tolist", "numpy", "__array__"})
# ops whose output shape depends on the data (the host must read a count)
_DATA_SHAPE_OPS = frozenset(
    {"nonzero", "unique", "unique_consecutive", "masked_select", "bincount", "argwhere"}
)
# calls and methods whose result is a boolean tensor (mask indexing)
_BOOL_OPS = frozenset(
    {"isfinite", "isnan", "isinf", "isin", "isneginf", "isposinf", "logical_and",
     "logical_or", "logical_not", "logical_xor", "eq", "ne", "lt", "le", "gt", "ge",
     "bool"}
)
_CONFIG_NAMES = frozenset({"cfg", "config"})


def _is_config_name(name: str) -> bool:
    return name in _CONFIG_NAMES or name.endswith("cfg")


# ---------------------------------------------------------------------------
# staticness oracle
# ---------------------------------------------------------------------------


def _env_for(project: Project, fn: FunctionInfo) -> Dict[str, bool]:
    """Name -> staticness for one function's own scope in a region.

    Parameters come from the resolved ``param_static``; locals are folded
    in statement order with an AND-join on rebinding (two passes so
    forward references stabilize).  Nested function bodies are skipped:
    they have their own env."""
    cache = getattr(project, "_env_cache", None)
    if cache is None:
        cache = project._env_cache = {}
    hit = cache.get(fn)
    if hit is not None:
        return hit
    env: Dict[str, bool] = dict(fn.param_static)
    cache[fn] = env  # pre-seed so recursive lookups terminate

    def bind(target: ast.AST, static: bool) -> None:
        if isinstance(target, ast.Name):
            prev = env.get(target.id)
            env[target.id] = static if prev is None else (prev and static)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                bind(elt, static)
        elif isinstance(target, ast.Starred):
            bind(target.value, static)

    def fold(stmts) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                env.setdefault(stmt.name, True)  # a host object
                continue
            if isinstance(stmt, ast.Assign):
                if (
                    isinstance(stmt.value, ast.Tuple)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Tuple)
                    and len(stmt.targets[0].elts) == len(stmt.value.elts)
                ):
                    for tgt, val in zip(stmt.targets[0].elts, stmt.value.elts):
                        bind(tgt, is_static(val, project, fn))
                else:
                    static = is_static(stmt.value, project, fn)
                    for tgt in stmt.targets:
                        bind(tgt, static)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                bind(stmt.target, is_static(stmt.value, project, fn))
            elif isinstance(stmt, ast.AugAssign):
                bind(stmt.target, is_static(stmt.value, project, fn))
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                bind(stmt.target, is_static(stmt.iter, project, fn))
                fold(stmt.body)
                fold(stmt.orelse)
            elif isinstance(stmt, (ast.While, ast.If)):
                fold(stmt.body)
                fold(stmt.orelse)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    if item.optional_vars is not None:
                        bind(item.optional_vars, is_static(item.context_expr, project, fn))
                fold(stmt.body)
            elif isinstance(stmt, ast.Try):
                fold(stmt.body)
                for h in stmt.handlers:
                    fold(h.body)
                fold(stmt.orelse)
                fold(stmt.finalbody)
            elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.NamedExpr):
                bind(stmt.value.target, is_static(stmt.value.value, project, fn))

    fold(fn.node.body)
    fold(fn.node.body)  # second pass: forward refs, loop-carried rebinds
    return env


def _lookup(project: Project, fn: Optional[FunctionInfo], name: str) -> bool:
    """Staticness of a free name seen from ``fn`` (True = static)."""
    s = fn
    while s is not None:
        if not s.traced:
            # a closure variable from host scope is a Python value when
            # the region runs
            return True
        env = _env_for(project, s)
        if name in env:
            return env[name]
        s = s.parent
    return True  # module global / import / builtin


def is_static(
    expr: ast.AST,
    project: Project,
    fn: Optional[FunctionInfo],
    overlay: Optional[Dict[str, bool]] = None,
) -> bool:
    """True iff ``expr`` is a host value (never a tensor) inside ``fn``."""

    def ev(e: ast.AST) -> bool:
        if isinstance(e, ast.Constant):
            return True
        if isinstance(e, ast.Name):
            if overlay is not None and e.id in overlay:
                return overlay[e.id]
            return _lookup(project, fn, e.id)
        if isinstance(e, ast.Attribute):
            if ev(e.value):
                return True
            if e.attr in STATIC_ATTRS:
                return True
            # a config field read off any config object
            return isinstance(e.value, ast.Name) and _is_config_name(e.value.id)
        if isinstance(e, ast.Subscript):
            return ev(e.value) and ev(e.slice)
        if isinstance(e, ast.Slice):
            return all(part is None or ev(part) for part in (e.lower, e.upper, e.step))
        if isinstance(e, ast.BinOp):
            return ev(e.left) and ev(e.right)
        if isinstance(e, ast.BoolOp):
            return all(ev(v) for v in e.values)
        if isinstance(e, ast.UnaryOp):
            return ev(e.operand)
        if isinstance(e, ast.Compare):
            # `x is None` / `x is not None` is static: a tensor is never None
            if (
                len(e.ops) == 1
                and isinstance(e.ops[0], (ast.Is, ast.IsNot))
                and isinstance(e.comparators[0], ast.Constant)
                and e.comparators[0].value is None
            ):
                return True
            # `"key" in tree` / `axis in partial` is membership in a dict's
            # or a spec's structure (a host key is never looked up in a tensor)
            if (
                len(e.ops) == 1
                and isinstance(e.ops[0], (ast.In, ast.NotIn))
                and ev(e.left)
            ):
                return True
            return ev(e.left) and all(ev(c) for c in e.comparators)
        if isinstance(e, ast.IfExp):
            return ev(e.test) and ev(e.body) and ev(e.orelse)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return all(ev(v) for v in e.elts)
        if isinstance(e, ast.Dict):
            return all(k is None or ev(k) for k in e.keys) and all(ev(v) for v in e.values)
        if isinstance(e, ast.Starred):
            return ev(e.value)
        if isinstance(e, ast.Lambda):
            return True  # a host function object
        if isinstance(e, ast.JoinedStr):
            return all(ev(v) for v in e.values)
        if isinstance(e, ast.FormattedValue):
            return ev(e.value)
        if isinstance(e, ast.NamedExpr):
            return ev(e.value)
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
            inner = dict(overlay or {})
            for gen in e.generators:
                it_static = is_static(gen.iter, project, fn, inner)
                for t in ast.walk(gen.target):
                    if isinstance(t, ast.Name):
                        inner[t.id] = it_static
                if not all(is_static(c, project, fn, inner) for c in gen.ifs):
                    return False
            if isinstance(e, ast.DictComp):
                return is_static(e.key, project, fn, inner) and is_static(
                    e.value, project, fn, inner
                )
            return is_static(e.elt, project, fn, inner)
        if isinstance(e, ast.Call):
            return _call_static(e)
        return False

    def _call_static(call: ast.Call) -> bool:
        args_static = all(ev(a) for a in call.args) and all(
            ev(k.value) for k in call.keywords
        )
        func = call.func
        mod = fn.module if fn is not None else None
        if isinstance(func, ast.Name) and _lookup(project, fn, func.id):
            if func.id in _ALWAYS_STATIC_BUILTINS and func.id not in (mod.top_level if mod else ()):
                return True
            if func.id in _STATIC_BUILTINS and func.id not in (mod.top_level if mod else ()):
                return args_static
        if isinstance(func, ast.Attribute) and func.attr in STATIC_METHODS:
            return args_static  # metadata of a tensor is a Python value
        if isinstance(func, ast.Attribute) and func.attr in _HOST_VALUE_METHODS:
            return True  # the read already happened (TS03 flags it)
        if mod is None:
            return False
        dotted = mod.resolve_dotted(func)
        if dotted is not None:
            if dotted in _HOST_TORCH_CALLS:
                return True
            if dotted.startswith(_TENSOR_CALL_PREFIXES):
                # a torch class (a placement, a generator) is a host object
                return args_static and _last_segment(dotted)[:1].isupper()
            if dotted.startswith(_HOST_CALL_PREFIXES):
                return args_static
        target = project.lookup_function(func, mod, fn)
        if target is not None:
            return _returns_static(project, target, args_static)
        if project.lookup_class(func, mod):
            return args_static  # a project object built from host values
        if dotted is not None and isinstance(func, (ast.Name, ast.Attribute)):
            root = dotted.split(".", 1)[0]
            head = _dotted(func).split(".", 1)[0]
            imported = head in mod.import_aliases or head in mod.from_imports
            if imported and root not in ("torch", "repro_torch"):
                return args_static  # a library outside torch returns host values
        # a method on a static host object yields a host value
        if isinstance(func, ast.Attribute) and ev(func.value):
            return args_static
        return False

    return ev(expr)


def _returns_static(project: Project, target: FunctionInfo, args_static: bool) -> bool:
    """Whether a call of the project function ``target`` returns a host
    value: every ``return`` of it is static with its parameters all
    tensors, or (given static arguments) with its parameters all static."""
    cache = project.__dict__.setdefault("_returns_cache", {})
    modes = ("any",) + (("static",) if args_static else ())
    for mode in modes:
        key = (target, mode)
        if key not in cache:
            cache[key] = True  # optimistic while in progress (recursion)
            host = target.host_params()
            params = {p: (mode == "static" or p in host) for p in target.params}
            shadow = FunctionInfo(qualname=target.qualname, module=target.module,
                                  node=target.node, parent=target.parent, traced=True,
                                  param_static=params)
            returns = [n.value for n in _own_nodes(target.node)
                       if isinstance(n, ast.Return) and n.value is not None]
            cache[key] = all(is_static(r, project, shadow) for r in returns)
        if cache[key]:
            return True
    return False


def _own_nodes(fn_node: ast.AST):
    """The nodes of a function body, nested functions and lambdas skipped."""
    stack = list(fn_node.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                                      ast.ClassDef)):
                stack.append(child)


# ---------------------------------------------------------------------------
# rule checks
# ---------------------------------------------------------------------------


class _Collector:
    def __init__(self, project: Project) -> None:
        self.project = project
        self.findings: List[Finding] = []
        self._seen = set()

    def add(self, rule: str, mod: ModuleInfo, node, message: str, context: str) -> None:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        key = (rule, mod.path, line, col)
        if key in self._seen:
            return
        text = mod.line_text(line)
        if suppresses(text, rule):
            return
        self._seen.add(key)
        self.findings.append(
            Finding(rule=rule, path=mod.path, line=line, col=col, message=message,
                    context=context, line_text=text)
        )


def _is_obs_call(call: ast.Call, mod: ModuleInfo) -> bool:
    dotted = mod.resolve_dotted(call.func)
    return dotted is not None and dotted.startswith("repro_torch.obs")


def _bool_names(fn: FunctionInfo, mod: ModuleInfo) -> Set[str]:
    """Local names bound only to boolean-tensor expressions (masks)."""
    assigned: Dict[str, bool] = {}

    def walk(stmts) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        prev = assigned.get(t.id, True)
                        assigned[t.id] = prev and _boolish(stmt.value, mod, set())
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, list):
                    walk(sub)
            for h in getattr(stmt, "handlers", ()):
                walk(h.body)

    for _ in range(2):  # masks built from masks
        walk(fn.node.body)
    return {n for n, b in assigned.items() if b}


def _boolish(e: ast.AST, mod: ModuleInfo, names: Set[str]) -> bool:
    """True iff ``e`` is (syntactically) a boolean tensor: a comparison, a
    mask op, a combination of masks, or a local mask name."""
    if isinstance(e, ast.Compare):
        return not any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in e.ops)
    if isinstance(e, ast.Name):
        return e.id in names
    if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Invert):
        return _boolish(e.operand, mod, names)
    if isinstance(e, ast.BinOp) and isinstance(e.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return _boolish(e.left, mod, names) or _boolish(e.right, mod, names)
    if isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute):
        if e.func.attr in _BOOL_OPS:
            dotted = mod.resolve_dotted(e.func) or ""
            return dotted.startswith("torch.") or not dotted.startswith(("numpy.", "math."))
    return False


def _check_traced_function(fn: FunctionInfo, out: _Collector) -> None:
    project, mod = out.project, fn.module
    ctx = fn.display()
    masks = _bool_names(fn, mod)

    def static(e: ast.AST) -> bool:
        return is_static(e, project, fn)

    def branch_static(e: ast.AST) -> bool:
        """A branch test: static, or the truth of ``*args`` (its length)."""
        while isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Not):
            e = e.operand
        return (isinstance(e, ast.Name) and e.id in fn.containers()) or static(e)

    def visit(node: ast.AST, guarded: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
            return  # separate functions / opaque bodies
        if isinstance(node, ast.Assert):
            if not static(node.test):
                out.add("TS01", mod, node,
                        "assert on a tensor reads it on the host (a stream sync on "
                        "the card; a fake tensor cannot answer it): check on the "
                        "host path or keep the check on the device", ctx)
            return  # don't re-flag the test expression as TS02/TS03
        if isinstance(node, (ast.If, ast.While)):
            test_static = branch_static(node.test)
            if not test_static:
                kind = "while" if isinstance(node, ast.While) else "if"
                out.add("TS02", mod, node,
                        f"Python `{kind}` on a tensor reads it on the host to "
                        "branch: use torch.where or make the operand a host value",
                        ctx)
            visit(node.test, guarded)
            for stmt in node.body + node.orelse:
                visit(stmt, guarded or test_static)
            return
        if isinstance(node, ast.IfExp) and not branch_static(node.test):
            out.add("TS02", mod, node,
                    "conditional expression on a tensor reads it on the host: "
                    "use torch.where", ctx)
        if isinstance(node, ast.Match):
            if not static(node.subject):
                out.add("TS02", mod, node,
                        "`match` on a tensor compares it on the host case by case: "
                        "match on a host value", ctx)
            for case in node.cases:
                if case.guard is not None and not static(case.guard):
                    out.add("TS02", mod, case.guard,
                            "`case ... if` guard on a tensor reads it on the host: "
                            "use torch.where or a host value", ctx)
            visit(node.subject, guarded)
            for case in node.cases:
                for stmt in case.body:
                    visit(stmt, guarded)
            return
        if isinstance(node, ast.Subscript) and not static(node.value):
            if _boolish(node.slice, mod, masks):
                out.add("TS03", mod, node,
                        "boolean-mask indexing sizes its result by the data (a host "
                        "read of the count): use torch.where or a fixed-size index",
                        ctx)
        if isinstance(node, ast.Call):
            _check_call(node, guarded)
        for child in ast.iter_child_nodes(node):
            visit(child, guarded)

    def _check_call(call: ast.Call, guarded: bool) -> None:
        func = call.func
        name = func.id if isinstance(func, ast.Name) else None
        if name == "bool" and call.args and not static(call.args[0]):
            out.add("TS02", mod, call,
                    "bool() on a tensor reads it on the host: use torch.where or a "
                    "host value", ctx)
            return
        if name in _SYNC_CALLS and call.args and not static(call.args[0]):
            out.add("TS03", mod, call,
                    f"{name}() on a tensor reads it on the host (a stream sync on the "
                    "card): keep it on the device or hoist it to the host path", ctx)
            return
        if isinstance(func, ast.Attribute):
            dotted = mod.resolve_dotted(func)
            last = func.attr
            on_tensor = not static(func.value)
            if last in _SYNC_METHODS and on_tensor:
                out.add("TS03", mod, call,
                        f".{last}() in a sync-free region reads a tensor on the "
                        "host: move it out of the region", ctx)
                return
            is_torch = dotted is not None and dotted.startswith("torch.")
            if last in _DATA_SHAPE_OPS and (is_torch or on_tensor):
                out.add("TS03", mod, call,
                        f"{last}() sizes its output by the data (the host reads a "
                        "count): use a fixed-size form", ctx)
                return
            reps = call.args[1 if is_torch else 0: 2 if is_torch else 1] or [
                k.value for k in call.keywords if k.arg == "repeats"]
            if (last == "repeat_interleave" and (is_torch or on_tensor)
                    and not all(static(r) for r in reps)
                    and not any(k.arg == "output_size" for k in call.keywords)):
                out.add("TS03", mod, call,
                        "repeat_interleave without output_size reads the total on the "
                        "host: pass output_size", ctx)
                return
            if (dotted == "torch.where" and len(call.args) == 1 and not call.keywords):
                out.add("TS03", mod, call,
                        "one-argument torch.where is nonzero(): its size is the "
                        "data's; use the three-argument form", ctx)
                return
            if (
                dotted is not None
                and dotted.startswith(_HOST_CALL_PREFIXES)
                and any(not static(a) for a in list(call.args) + [k.value for k in call.keywords])
            ):
                out.add("TS03", mod, call,
                        f"{_dotted(func)} on a tensor reads it on the host: use the "
                        "torch equivalent", ctx)
                return
        if _is_obs_call(call, mod) and not guarded:
            out.add("TS07", mod, call,
                    "obs/telemetry call in a sync-free region without a static gate: "
                    "wrap it in `if <host flag>:` so disabled telemetry costs nothing",
                    ctx)

    for stmt in fn.node.body:
        visit(stmt, False)


_SET_METHODS = frozenset({"union", "intersection", "difference", "symmetric_difference"})
_ARRAY_BUILDERS = frozenset(
    {"array", "asarray", "fromiter", "stack", "concatenate", "hstack", "vstack", "list",
     "tuple", "tensor", "as_tensor", "cat"}
)


def _is_set_valued(e: ast.AST) -> bool:
    if isinstance(e, (ast.Set, ast.SetComp)):
        return True
    if isinstance(e, ast.Call):
        last = _last_segment(_dotted(e.func))
        if last in ("set", "frozenset"):
            return True
        if isinstance(e.func, ast.Attribute) and e.func.attr in _SET_METHODS:
            return True
    if isinstance(e, ast.BinOp) and isinstance(e.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return _is_set_valued(e.left) or _is_set_valued(e.right)
    return False


def _cfg_fields(node: ast.AST) -> List[str]:
    """``cfg.<field>`` names read anywhere in ``node`` (nested functions
    included: a build closure reads what they read)."""
    return [
        sub.attr
        for sub in ast.walk(node)
        if isinstance(sub, ast.Attribute)
        and isinstance(sub.value, ast.Name)
        and _is_config_name(sub.value.id)
    ]


def _check_memo_key(mod: ModuleInfo, scope, call: ast.Call, project: Project,
                    out: _Collector, ctx: str) -> None:
    """TS06 at one ``graph_cached(g, (<literal key>), build)`` call."""
    args = list(call.args)
    kw = {k.arg: k.value for k in call.keywords if k.arg}
    key = args[1] if len(args) > 1 else kw.get("key")
    build = args[2] if len(args) > 2 else kw.get("build")
    if not isinstance(key, ast.Tuple) or build is None:
        return
    keyed = set()
    for elt in key.elts:
        if (isinstance(elt, ast.Attribute) and isinstance(elt.value, ast.Name)
                and _is_config_name(elt.value.id)):
            field = knobs.canonical_knob(elt.attr)
            keyed.add(field)
            kind = knobs.classify(field)
            if kind == "solve":
                out.add("TS06", mod, call,
                        f"memo key names cfg.{elt.attr}, a per-solve knob "
                        "(repro_torch.knobs.SOLVE_KNOBS): the memo splits for "
                        "nothing; drop it from the key", ctx)
            elif kind is None:
                out.add("TS06", mod, call,
                        f"memo key names cfg.{elt.attr}, which is no SolverConfig "
                        "field: a stale key", ctx)
        elif isinstance(elt, ast.Name) and knobs.classify(elt.id) is not None:
            keyed.add(knobs.canonical_knob(elt.id))
    if isinstance(build, ast.Lambda):
        reads = _cfg_fields(build.body)
    else:
        target = project.lookup_function(build, mod, scope)
        reads = _cfg_fields(target.node) if target is not None else []
    for field in dict.fromkeys(knobs.canonical_knob(f) for f in reads):
        if knobs.classify(field) == "view" and field not in keyed:
            out.add("TS06", mod, call,
                    f"the build reads cfg.{field}, a view knob "
                    "(repro_torch.knobs.VIEW_KNOBS), but the memo key omits it: a "
                    f"solve with another {field} is served this view", ctx)


def _check_module_wide(mod: ModuleInfo, project: Project, out: _Collector) -> None:
    """TS04 / TS05 / TS06 apply to host code too: id-aliased caches,
    nondeterministic layouts and drifting memo keys corrupt solves from
    outside any region."""
    for scope, call in project._iter_calls(mod):
        ctx = scope.display() if scope else f"{mod.name}.<module>"
        func = call.func
        # TS04: id() anywhere except a direct identity comparison
        if isinstance(func, ast.Name) and func.id == "id" and call.args:
            parent = getattr(call, "_repro_parent", None)
            if not isinstance(parent, ast.Compare):
                out.add("TS04", mod, call,
                        "id()-keyed identity: ids are recycled after gc, so "
                        "an id-keyed cache aliases dead objects to new ones — "
                        "key on a stable token (shape/dtype/version) instead", ctx)
        last = _last_segment(_dotted(func))
        # TS05: array construction over unordered set iteration
        if last in _ARRAY_BUILDERS:
            for a in call.args:
                if _is_set_valued(a):
                    out.add("TS05", mod, call,
                            f"{last}() over an unordered set — iteration "
                            "order varies per process, so the array layout "
                            "is nondeterministic; sort first", ctx)
                    break
        # TS06: memo-key drift
        if last == "graph_cached":
            _check_memo_key(mod, scope, call, project, out, ctx)


class _Loc:
    """A bare (lineno, col_offset) stand-in for comment-level findings."""

    def __init__(self, lineno: int, col_offset: int) -> None:
        self.lineno = lineno
        self.col_offset = col_offset


def _comment_lines(mod: ModuleInfo):
    """(lineno, comment_text) for every real ``#`` comment token: a
    docstring *mentioning* the marker is not a suppression."""
    import io
    import tokenize

    try:
        toks = tokenize.generate_tokens(io.StringIO("\n".join(mod.lines) + "\n").readline)
        return [(t.start[0], t.string) for t in toks if t.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return []


def _check_suppression_comments(mod: ModuleInfo, out: _Collector) -> None:
    """SUP01: a scoped ``# jitlint: ignore[...]`` naming an unknown rule
    id suppresses nothing while looking reviewed; flag the typo itself."""
    for lineno, comment in _comment_lines(mod):
        if SUPPRESS_MARKER not in comment:
            continue
        raw = mod.lines[lineno - 1] if lineno <= len(mod.lines) else comment
        bad = unknown_rule_ids(comment)
        if bad:
            out.add("SUP01", mod, _Loc(lineno, max(raw.find("#"), 0)),
                    f"suppression names unknown rule id(s) {', '.join(bad)} — "
                    "no analyzer emits them, so nothing is suppressed; fix "
                    "the id or drop it",
                    f"{mod.name}.<module>")


def _annotate_parents(mod: ModuleInfo) -> None:
    for node in ast.walk(mod.tree):
        for child in ast.iter_child_nodes(node):
            child._repro_parent = node


def check_project(project: Project) -> List[Finding]:
    out = _Collector(project)
    for mod in project.modules.values():
        _annotate_parents(mod)
        _check_suppression_comments(mod, out)
        _check_module_wide(mod, project, out)
        for fn in mod.functions.values():
            if fn.traced:
                _check_traced_function(fn, out)
    return out.findings
