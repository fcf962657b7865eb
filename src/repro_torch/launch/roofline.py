"""Roofline terms of a dry-run cell, per card and per step, on an H100.

The counterpart of ``repro.launch.roofline``.  Three terms per (arch x
shape x mesh), each per card:

  compute    = matmul FLOPs / peak FLOP/s of the cell's matmul dtype
  memory     = HBM bytes / HBM bandwidth
  collective = sum over process groups of wire bytes / the slowest link
               the group crosses

The counts are host arithmetic: ``launch/dryrun.py`` runs one step of a
cell on fake tensors of a fake world and counts under dispatch modes, on
the local tensors of one rank (a DTensor op counts its local shards):

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``, which counts
  matmul, convolution and attention FLOPs only.  XLA's ``flops``, which the
  reference reads, also counts elementwise work, so for the same program
  this count is the lower one.
* ``bytes_hbm`` (:class:`StepCounter`): the port runs eagerly, so every op
  reads its inputs from HBM and writes its outputs there; the term is the
  sum of each op's input and output bytes, the eager program's HBM traffic
  with no cache reuse.  Views and collectives move no HBM bytes here.
* collective bytes (:class:`StepCounter`): the result bytes of every
  collective the step issues, the functional ``_c10d_functional`` ops of
  DTensor and the in-place ``c10d`` ops of ``dist.all_reduce`` /
  ``all_gather_into_tensor`` (``core/mesh.py``), times the reference's ring
  wire factors (``_WIRE_FACTOR``), kept by kind and by process group.
  ``wait_tensor`` is never counted; a group of one rank moves nothing.

Hardware constants: NVIDIA's data-sheet rates for one H100 SXM5 80GB at
its 700 W limit, not measurements: 989 TFLOP/s dense bf16 on the tensor
cores, 66.9 TFLOP/s f32 (the port does not enable TF32), 3.35 TB/s HBM3;
NVLink 4 at 450 GB/s a direction between the 8 cards of a node, and one
400 Gb/s NDR InfiniBand port (50 GB/s) a card across nodes.  Ranks are
cards in order, 8 to a node: a group whose ranks all share ``rank // 8``
runs over NVLink, any other over InfiniBand.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

PEAK_FLOPS = {"bf16": 989e12, "f32": 66.9e12}
HBM_BW = 3.35e12
NVLINK_BW = 450e9
IB_BW = 50e9
NODE_CARDS = 8
LINK_BW = {"nvlink": NVLINK_BW, "ib": IB_BW}
# torch.cuda.get_device_properties(0).total_memory of an H100 80GB HBM3
CARD_BYTES = 85.0e9

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# wire bytes per device ≈ factor × result bytes (ring model, n→∞ limit)
_WIRE_FACTOR = {
    "all-gather": 1.0,  # receives (n-1)/n of the gathered result
    "all-reduce": 2.0,  # reduce-scatter + all-gather
    "reduce-scatter": 1.0,  # sends (n-1)/n of the input (≈ n× result)
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# op -> kind.  Functional ops return their result; the in-place c10d ops
# write it into their first argument.
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_INPLACE = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
}
_NOT_COUNTED = ("wait_tensor", "_wrap_tensor_autograd", "barrier", "monitored_barrier_",
                "check_for_nan")


def collective_kind(ns: str, name: str) -> Optional[str]:
    """The kind ("all-reduce", ...) of the collective op ``ns::name``;
    None for an op of those namespaces that moves nothing
    (``wait_tensor``, ``barrier``).  Raises for an unknown one, so that no
    collective goes uncounted."""
    if name in _NOT_COUNTED:
        return None
    table = _FUNCTIONAL if ns == "_c10d_functional" else _INPLACE
    if name not in table:
        raise NotImplementedError(f"collective {ns}.{name} is not counted")
    return table[name]


def collective_group(ns: str, args):
    """The process group a collective op's ``args`` name: the functional
    ops carry its name, the in-place ``c10d`` ops the group boxed as a
    ScriptObject."""
    if ns == "_c10d_functional":
        from torch.distributed.distributed_c10d import _resolve_process_group

        return _resolve_process_group([a for a in args if isinstance(a, str)][-1])
    return dist.ProcessGroup.unbox(next(a for a in args if isinstance(a, torch.ScriptObject)))


def link_of(ranks: Sequence[int]) -> str:
    """"nvlink" if every rank of the group sits in one node, else "ib"."""
    return "nvlink" if len({r // NODE_CARDS for r in ranks}) <= 1 else "ib"


def wire_by_link(groups: Dict[str, dict]) -> Dict[str, float]:
    """Wire bytes per link of {group: {"link", "bytes", ...}}."""
    out = {k: 0.0 for k in LINK_BW}
    for g in groups.values():
        out[g["link"]] += g["bytes"]
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    return getattr(t, "_local_tensor", t)  # a DTensor's shard on this rank


def _nbytes(t: torch.Tensor) -> int:
    """Bytes an op moves for ``t``: its elements, or its storage when that
    is smaller (a broadcast view reads each stored element once)."""
    t = _local(t)
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):  # no storage (e.g. a nested view)
        return n


def _tensors(x) -> Iterable[torch.Tensor]:
    return (t for t in tree_leaves(x) if isinstance(t, torch.Tensor))


def _is_view(func) -> bool:
    """An op whose outputs alias its inputs without writing them."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


class StepCounter(TorchDispatchMode):
    """Counts what one rank's step moves: HBM bytes (every op's inputs and
    outputs) and collective bytes by kind and by process group.

    ``coll`` is {kind: wire bytes}; ``groups`` is {"first-last/size":
    {"ranks": size, "link": "nvlink" | "ib", "bytes": wire bytes, kind:
    wire bytes}}.  An op
    this class does not know in the collective namespaces raises, so that
    no collective goes uncounted.
    """

    def __init__(self):
        super().__init__()
        self.bytes_hbm = 0
        self.coll: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
        self.groups: Dict[str, dict] = {}
        self._ranks: Dict[object, list] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns in ("_c10d_functional", "c10d"):
            if collective_kind(ns, name) is not None:
                self._collective(ns, name, args, out)
        elif ns != "prim" and not _is_view(func):
            self.bytes_hbm += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes_hbm += sum(_nbytes(t) for t in _tensors(out))
        return out

    def _collective(self, ns, name, args, out):
        kind = collective_kind(ns, name)
        result = out if ns == "_c10d_functional" else args[0]
        ranks = self._group_ranks(ns, args)
        nbytes = sum(_local(t).numel() * _local(t).element_size() for t in _tensors(result))
        wire = nbytes * _WIRE_FACTOR[kind] if len(ranks) > 1 else 0.0
        self.coll[kind] += wire
        key = f"{ranks[0]}-{ranks[-1]}/{len(ranks)}"
        g = self.groups.setdefault(key, {"ranks": len(ranks), "link": link_of(ranks),
                                         "bytes": 0.0, **{k: 0.0 for k in _COLLECTIVES}})
        g["bytes"] += wire
        g[kind] += wire

    def _group_ranks(self, ns, args) -> list:
        pg = collective_group(ns, args)
        if pg.group_name not in self._ranks:
            self._ranks[pg.group_name] = dist.get_process_group_ranks(pg)
        return self._ranks[pg.group_name]


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_hbm: float
    bytes_wire: float
    coll_breakdown: Dict[str, float]
    wire_by_link: Dict[str, float]
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    compute_dtype: str
    model_flops_per_chip: Optional[float] = None
    useful_ratio: Optional[float] = None

    def row(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_hbm": self.bytes_hbm,
            "bytes_wire": self.bytes_wire,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "compute_dtype": self.compute_dtype,
            "model_flops_per_chip": self.model_flops_per_chip,
            "useful_ratio": self.useful_ratio,
            **{f"coll_{k}": v for k, v in self.coll_breakdown.items()},
            **{f"wire_{k}": v for k, v in self.wire_by_link.items()},
        }


def analyze_terms(flops: float, bts: float, coll: Dict[str, float],
                  model_flops_total: Optional[float] = None, n_chips: int = 256, *,
                  by_link: Optional[Dict[str, float]] = None,
                  dtype: str = "bf16") -> Roofline:
    """Roofline from explicit per-card terms.  ``coll`` is the wire bytes
    by kind; ``by_link`` the same bytes by link ({"nvlink": b, "ib": b}),
    each over its own bandwidth (all over InfiniBand when None);
    ``dtype`` ("bf16" or "f32") picks the compute peak."""
    wire = sum(coll.values())
    by_link = dict(by_link) if by_link is not None else {"nvlink": 0.0, "ib": wire}
    t_c = flops / PEAK_FLOPS[dtype]
    t_m = bts / HBM_BW
    t_x = sum(b / LINK_BW[k] for k, b in by_link.items())
    dominant = max(
        (("compute", t_c), ("memory", t_m), ("collective", t_x)),
        key=lambda kv: kv[1],
    )[0]
    mf = model_flops_total / n_chips if model_flops_total else None
    return Roofline(
        flops=flops,
        bytes_hbm=bts,
        bytes_wire=wire,
        coll_breakdown=dict(coll),
        wire_by_link=by_link,
        t_compute=t_c,
        t_memory=t_m,
        t_collective=t_x,
        dominant=dominant,
        compute_dtype=dtype,
        model_flops_per_chip=mf,
        useful_ratio=(mf / flops) if (mf and flops) else None,
    )


def memory_report(peak_bytes: float, state_bytes: float) -> dict:
    """The fit of one card from a ``MemTracker`` peak (bytes, this rank's
    program on fake tensors) and the per-card state (parameters, optimizer
    state, inputs and caches, from the specs' shard shapes); GB = 10**9
    bytes, against the card's ``CARD_BYTES``."""
    return {
        "state_gb": state_bytes / 1e9,
        "work_gb": (peak_bytes - state_bytes) / 1e9,
        "peak_gb": peak_bytes / 1e9,
        "card_gb": CARD_BYTES / 1e9,
        "fits_80gb": bool(peak_bytes < CARD_BYTES),
    }
