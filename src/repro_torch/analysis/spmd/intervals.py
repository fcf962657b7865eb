"""Value ranges over a recording (NU01–NU02).

The counterpart of ``repro.analysis.spmd.intervals``.  Each tensor carries
an interval ``[lo, hi]`` (floats; ±inf = unknown).  The domain is
whitelist-sound: only the factories and ops with a transfer function below
produce finite bounds, from their scalar arguments (``arange``'s ends,
``full``'s fill, a literal operand); everything else is ⊤.  Both rules
therefore fire only on **proven** violations.

  NU01  a narrowing integer cast whose operand's proven interval escapes
        the target type.  In PyTorch a narrowing cast also hides in an
        in-place write into a narrower destination (``copy_``,
        ``index_put_``, ``scatter_``, ``index_copy_``, ``fill_``, ...),
        not only in ``_to_copy``: ``lab_i16``'s labels (``S >= 32768``)
        would overflow there.
  NU02  an int -> float32 cast (or write into a float32 destination) of a
        value proven past 2^24, where float32 stops holding every integer.

An in-place write joins its source into every tensor that shares the
destination's storage, or replaces them when the destination spans the
whole storage.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.spmd.dispatch_tools import OpRecord, Recording, Violation

Interval = Tuple[float, float]
TOP: Interval = (-math.inf, math.inf)
_F32_EXACT = float(2 ** 24)
_INT_RANGE = {
    "torch.int8": (-128.0, 127.0),
    "torch.uint8": (0.0, 255.0),
    "torch.int16": (-32768.0, 32767.0),
    "torch.int32": (-2147483648.0, 2147483647.0),
    "torch.int64": (-9223372036854775808.0, 9223372036854775807.0),
    "torch.bool": (0.0, 1.0),
}
_INTS = frozenset(_INT_RANGE) - {"torch.bool"}
# ops whose output is their (first) input's values rearranged
_PASS = frozenset(
    {"view", "_unsafe_view", "reshape", "alias", "clone", "contiguous", "detach", "t",
     "permute", "transpose", "squeeze", "unsqueeze", "expand", "slice", "select",
     "narrow", "flatten", "unbind", "split", "split_with_sizes", "chunk", "index",
     "index_select", "gather", "take", "flip", "roll", "repeat", "as_strided",
     "lift_fresh", "amax", "amin", "max", "min", "cummax", "cummin", "sort", "topk",
     "unfold", "diagonal", "view_as", "expand_as", "movedim", "lift_fresh_copy"}
)
# ops returning (values, indices): the indices are no value of the input
_WITH_INDICES = frozenset({"max", "min", "sort", "topk", "cummax", "cummin", "kthvalue"})
_BOOL_OUT = frozenset(
    {"eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or", "logical_not",
     "logical_xor", "isfinite", "isnan", "isinf", "isin", "any", "all", "bitwise_not"}
)
# in-place writes of a source into a destination (source position)
_WRITES = {"copy_": 1, "index_put_": 2, "index_put": 2, "_index_put_impl_": 2,
           "scatter_": 3, "scatter": 3, "scatter_reduce_": 3, "scatter_reduce": 3,
           "index_copy_": 3, "index_copy": 3, "fill_": 1, "masked_fill_": 2,
           "masked_fill": 2, "index_fill_": 3, "index_fill": 3, "masked_scatter_": 2}


def _join(a: Interval, b: Interval) -> Interval:
    return min(a[0], b[0]), max(a[1], b[1])


def _num(x) -> Optional[float]:
    if isinstance(x, bool):
        return float(x)
    if isinstance(x, (int, float)):
        return float(x)
    return None


class _Intervals:
    def __init__(self, rec: Recording, out: List[Violation]):
        self.rec = rec
        self.out = out
        self.iv: Dict[int, Interval] = {}
        self.by_storage: Dict[int, List[int]] = {}
        for t, info in rec.tensors.items():
            self.by_storage.setdefault(info.storage, []).append(t)

    def get(self, a) -> Interval:
        """The interval of a recorded argument (a tensor or a literal)."""
        if a is None:
            return TOP
        if a[0] == "t":
            return self.iv.get(a[1], TOP)
        if a[0] == "v":
            v = _num(a[1])
            return TOP if v is None else (v, v)
        return TOP

    def dtype(self, t: int) -> str:
        return self.rec.tensors[t].dtype

    def run(self) -> None:
        for op in self.rec.ops:
            if not op.host_read:
                self.op(op)

    def _set_outputs(self, op: OpRecord, iv: Interval) -> None:
        for o in op.outputs:
            if o not in op.writes:
                self.iv[o] = iv

    def _write(self, t: int, iv: Interval, total: bool) -> None:
        """``t`` written with values in ``iv``: ``total`` when the write
        replaces every element of the storage, else a join."""
        info = self.rec.tensors[t]
        for u in self.by_storage[info.storage]:
            self.iv[u] = iv if total and info.whole else _join(self.iv.get(u, TOP), iv)

    def _check_cast(self, op: OpRecord, iv: Interval, src_dtype: Optional[str],
                    dst_dtype: str) -> None:
        lo, hi = iv
        if not (math.isfinite(lo) and math.isfinite(hi)):
            return
        rng = _INT_RANGE.get(dst_dtype)
        if rng is not None and dst_dtype != "torch.bool" and (lo < rng[0] or hi > rng[1]):
            self.out.append(Violation(
                "NU01",
                f"narrowing cast to {dst_dtype.split('.')[-1]}: operand proven in "
                f"[{lo:.0f}, {hi:.0f}] but the target holds only [{rng[0]:.0f}, "
                f"{rng[1]:.0f}]: values wrap silently (int16-label bug class)", op))
        if (src_dtype in _INTS and dst_dtype == "torch.float32"
                and max(abs(lo), abs(hi)) > _F32_EXACT):
            self.out.append(Violation(
                "NU02",
                f"int -> float32 cast with proven magnitude up to {max(abs(lo), abs(hi)):.0f}"
                " > 2^24: float32 cannot hold every integer past 16777216, so index/key "
                "arithmetic silently loses exactness", op))

    def op(self, op: OpRecord) -> None:
        name = op.name.rstrip("_") if op.name not in _WRITES else op.name
        a0 = op.arg(0, "self")
        if op.name == "_to_copy":
            src = a0[1] if a0[0] == "t" else None
            iv = self.get(a0)
            for o in op.outputs:
                self._check_cast(op, iv, self.dtype(src) if src is not None else None,
                                 self.rec.tensors[o].dtype)
            self._set_outputs(op, iv)
            return
        if op.name in _WRITES:
            src = op.arg(_WRITES[op.name], "src")
            if src[0] == "ts":  # index_put_'s (indices, values): values
                src = op.arg(_WRITES[op.name], "values")
            if op.name in ("index_put_", "index_put", "_index_put_impl_"):
                src = op.arg(2, "values")
            iv = self.get(src)
            src_dtype = self.dtype(src[1]) if src[0] == "t" else None
            if op.name.startswith("scatter_reduce"):
                iv = _join(iv, self.get(a0))
            for w in (op.writes or op.outputs[:1]):
                self._check_cast(op, iv, src_dtype, self.dtype(w))
                if w in op.writes:
                    self._write(w, iv, op.name in ("copy_", "fill_"))
            self._set_outputs(op, _join(iv, self.get(a0)) if not op.writes else iv)
            return
        iv = self._transfer(name, op)
        for w in op.writes:
            self._write(w, iv, True)
        self._set_outputs(op, iv)
        if name in _WITH_INDICES:
            for o in op.outputs[1:]:
                self.iv[o] = TOP

    def _transfer(self, name: str, op: OpRecord) -> Interval:
        g = self.get
        a0, a1 = op.arg(0, "self"), op.arg(1, "other")
        if name == "arange":
            raw = [a[1] for a in op.args if a[0] == "v" and _num(a[1]) is not None]
            nums = [_num(v) for v in raw]  # (end) or (start, end, step)
            gap = 1.0 if all(isinstance(v, int) for v in raw) else 0.0  # the end is excluded
            if len(nums) == 1:
                return (0.0, max(0.0, nums[0] - gap))
            if len(nums) >= 2:
                step = nums[2] if len(nums) > 2 else 1.0
                lo, hi = nums[0], nums[1]
                return (lo, max(lo, hi - gap)) if step > 0 else (hi + gap, lo)
            return TOP
        if name in ("full", "full_like", "new_full", "fill", "scalar_tensor"):
            fill = op.arg(1, "fill_value") if name != "scalar_tensor" else op.arg(0, "s")
            if name == "new_full":
                fill = op.arg(2, "fill_value")
            return g(fill)
        if name in ("zeros", "zeros_like", "new_zeros", "zero"):
            return (0.0, 0.0)
        if name in ("ones", "ones_like", "new_ones"):
            return (1.0, 1.0)
        if name in _BOOL_OUT:
            return (0.0, 1.0)
        if name in _PASS:
            return g(a0)
        if name == "add":
            (a, b), (c, d) = g(a0), g(a1)
            alpha = _num(op.kwargs.get("alpha", ("v", 1))[1]) or 1.0
            c, d = sorted((c * alpha, d * alpha))
            return (a + c, b + d)
        if name in ("sub", "rsub"):
            (a, b), (c, d) = g(a0), g(a1)
            if name == "rsub":
                (a, b), (c, d) = (c, d), (a, b)
            return (a - d, b - c)
        if name == "neg":
            a, b = g(a0)
            return (-b, -a)
        if name == "abs":
            a, b = g(a0)
            if a >= 0:
                return (a, b)
            if b <= 0:
                return (-b, -a)
            return (0.0, max(-a, b))
        if name == "mul":
            (a, b), (c, d) = g(a0), g(a1)
            prods = [a * c, a * d, b * c, b * d]
            prods = [0.0 if math.isnan(p) else p for p in prods]
            return (min(prods), max(prods))
        if name in ("maximum", "clamp_min"):
            (a, b), (c, d) = g(a0), g(a1)
            return (max(a, c), max(b, d))
        if name in ("minimum", "clamp_max"):
            (a, b), (c, d) = g(a0), g(a1)
            return (min(a, c), min(b, d))
        if name == "clamp":
            lo_b, hi_b = g(op.arg(1, "min")), g(op.arg(2, "max"))
            a, b = g(a0)
            lo = max(a, lo_b[0]) if math.isfinite(lo_b[0]) else a
            hi = min(b, hi_b[1]) if math.isfinite(hi_b[1]) else b
            return (min(lo, hi), max(lo, hi))
        if name == "where":
            return _join(g(op.arg(1, "self")), g(op.arg(2, "other")))
        if name in ("sum", "cumsum"):
            a, b = g(a0)
            count = 1
            if a0[0] == "t":
                shape = self.rec.tensors[a0[1]].shape
                n_in = math.prod(shape) if shape else 1
                n_out = max(1, math.prod(self.rec.tensors[op.outputs[0]].shape or (1,)))
                count = max(1, n_in // n_out) if name == "sum" else max(shape or (1,))
            return (min(a * count, a, 0.0), max(b * count, b, 0.0))
        if name in ("remainder", "fmod"):
            c, d = g(a1)
            m = max(abs(c), abs(d))
            return TOP if math.isinf(m) else (-m, m)
        return TOP


def analyze(recs: Sequence[Recording]) -> List[Violation]:
    """Every NU violation in the recordings (each rank's run separately:
    their scalar arguments differ)."""
    out: List[Violation] = []
    for rec in recs:
        _Intervals(rec, out).run()
    return out
