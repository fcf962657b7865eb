"""The device mesh of the mesh backends, over ``torch.distributed``.

The reference runs its distributed engines under ``shard_map`` on a JAX
device mesh.  Here the program runs SPMD with one process a mesh position:
the rank is the position in row-major order over the mesh axes
``(replica axes..., "model")``, each rank holds only its own shard, and
each collective of the reference maps to one ``torch.distributed`` call on
the group that spans exactly the axes the reference names:

  ``jax.lax.all_gather(x, axes, tiled=True)``   :func:`all_gather`
  ``jax.lax.pmin`` / ``pmax`` / ``psum``        ``all_reduce`` MIN / MAX / SUM
  the three lexicographic pmin passes           :func:`lex_pmin`

Collectives of CUDA tensors go through NCCL, of CPU tensors through gloo.
:func:`device_mesh` is the counterpart of the reference's ``_device_mesh``:
with no process group yet and a mesh of one position it creates a world of
one itself (the reference runs ``mesh_shape=(1, 1)`` on one device with no
setup); larger meshes need the caller to initialise the group (for example
with ``torchrun``) with a world size equal to the mesh's.  A world of one
still runs every collective.
"""

from __future__ import annotations

import itertools
import os
from datetime import timedelta
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

IMAX = torch.iinfo(torch.int32).max
MIN, MAX, SUM = dist.ReduceOp.MIN, dist.ReduceOp.MAX, dist.ReduceOp.SUM
# all_gather_single is the newer name of the same collective
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class Mesh:
    """A mesh of ranks: axis names and sizes, this rank's coordinates, and
    one process group for every non-empty tuple of axes.

    ``new_group`` is collective, so every rank builds every group, in the
    same order, when the mesh is made; ``torch.distributed``'s own
    ``DeviceMesh`` gives one group a dimension only.
    """

    def __init__(self, dims: Sequence[int], axis_names: Sequence[str]):
        self.dims = tuple(int(d) for d in dims)
        self.axis_names = tuple(axis_names)
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"mesh dims {self.dims} and axes {self.axis_names} differ in length")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.dims))
        self.size = int(np.prod(self.dims))
        self.rank = dist.get_rank()
        if dist.get_world_size() != self.size:
            raise ValueError(f"a mesh of {self.dims} needs a world of {self.size} ranks, "
                             f"the process group has {dist.get_world_size()}")
        coords = np.unravel_index(self.rank, self.dims)
        self.coords: Dict[str, int] = {a: int(c) for a, c in zip(self.axis_names, coords)}
        ranks = np.arange(self.size).reshape(self.dims)
        self._groups = {}
        for k in range(1, len(self.dims) + 1):
            for axes in itertools.combinations(range(len(self.dims)), k):
                rest = [i for i in range(len(self.dims)) if i not in axes]
                rows = np.transpose(ranks, rest + list(axes)).reshape(-1, int(
                    np.prod([self.dims[i] for i in axes])))
                names = tuple(self.axis_names[i] for i in axes)
                for row in rows:
                    g = dist.new_group(row.tolist())
                    if self.rank in row:
                        self._groups[names] = g

    def group(self, axes: Sequence[str]):
        """The process group of this rank over ``axes`` (in mesh order)."""
        key = tuple(a for a in self.axis_names if a in axes)
        if len(key) != len(tuple(axes)):
            raise ValueError(f"unknown mesh axes {tuple(axes)} (mesh axes {self.axis_names})")
        return self._groups[key]

    def axis_index(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over ``axes`` (``lax.axis_index``)."""
        idx = 0
        for a in self.axis_names:
            if a in axes:
                idx = idx * self.shape[a] + self.coords[a]
        return idx

    def axis_size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in axes]))


# the meshes of the world they were built on: a world destroyed and made
# anew (by this module or by the caller) is another object, and its meshes
# are built afresh
_MESHES: Dict[Tuple, Mesh] = {}
_MESHES_WORLD = [None]


def _world_backend() -> str:
    return "cuda:nccl,cpu:gloo" if dist.is_nccl_available() else "gloo"


def device_mesh(dims: Sequence[int], axis_names: Sequence[str] = ("data", "model")) -> Mesh:
    """``mesh_shape`` -> :class:`Mesh`, memoized per process group.

    With no process group yet, a mesh of one position gets a world of one
    (NCCL for CUDA tensors where PyTorch has it, gloo for CPU tensors, on a
    ``HashStore``); a larger mesh raises, as the reference does when the
    devices are missing.  An initialised group must hold exactly the
    mesh's number of ranks.
    """
    dims = tuple(int(d) for d in dims)
    need = int(np.prod(dims))
    if not dist.is_initialized():
        if need > 1:
            raise ValueError(
                f"mesh_shape {dims} needs {need} devices, only 1 available "
                f"(initialise torch.distributed with a world of {need} ranks, "
                f"for example with torchrun)")
        dist.init_process_group(backend=_world_backend(), store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timedelta(seconds=600))
    have = dist.get_world_size()
    if need > have:
        raise ValueError(f"mesh_shape {dims} needs {need} devices, only {have} available")
    if need != have:
        raise ValueError(f"mesh_shape {dims} needs {need} devices, the process group "
                         f"has {have} ranks")
    if _MESHES_WORLD[0] is not dist.group.WORLD:
        _MESHES.clear()  # groups of a destroyed world
        _MESHES_WORLD[0] = dist.group.WORLD
    key = (dims, tuple(axis_names))
    mesh = _MESHES.get(key)
    if mesh is None:
        mesh = _MESHES[key] = Mesh(dims, axis_names)
    return mesh


def rank_device(device) -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK`` for a CUDA device with
    no index (made current), else ``device`` itself."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    return device


def backend_name(device, group=None) -> str:
    """The collective backend ("nccl", "gloo") that tensors on ``device``
    go through in ``group`` (default: the world)."""
    pg = group if group is not None else dist.group.WORLD
    return pg._get_backend(torch.device(device)).name()


# ----------------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------------


def all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """``x`` reduced over ``group`` (a new tensor; ``x`` is left alone)."""
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of every rank of ``group`` stacked in group order:
    (world, *x.shape).  int16 travels as its bytes (neither gloo nor NCCL
    has the type) and bool as uint8."""
    world = dist.get_world_size(group)
    x = x.contiguous()
    if x.dtype == torch.int16:
        out = all_gather(x.view(torch.uint8), group)
        return out.view(torch.int16).view(world, *x.shape)
    if x.dtype == torch.bool:
        return all_gather(x.to(torch.uint8), group).bool()
    out = torch.empty((world * x.numel(),), dtype=x.dtype, device=x.device)
    _gather_into(out, x.reshape(-1), group=group)
    return out.view(world, *x.shape)


def all_gather_tiled(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, tiled=True)`` along dim 0 (last dim
    for 2-D ``x``, as the reference's fused (2, nb) gather along axis 1)."""
    out = all_gather(x, group)
    if x.dim() == 1:
        return out.reshape(-1)
    return out.permute(1, 0, *range(2, out.dim())).reshape(x.shape[0], -1)


def lex_pmin(d: torch.Tensor, l: torch.Tensor, p: torch.Tensor, group, chunks: int = 1):
    """The lexicographic minimum of ``(d, l, p)`` over ``group``: three
    ``all_reduce(MIN)`` passes, each key taken where the earlier ones tie
    with the minimum (the reference's ``merge_replicas`` and pair-table
    merges).  ``chunks`` > 1 reduces each pass in that many pieces (the
    paper's chunked Allreduce, §V-F)."""

    def pmin(x):
        out = x.clone()
        if chunks <= 1:
            dist.all_reduce(out, op=MIN, group=group)
            return out
        csz = -(-out.numel() // chunks)
        flat = out.view(-1)
        for i in range(chunks):
            piece = flat[i * csz:(i + 1) * csz]
            if piece.numel():
                dist.all_reduce(piece, op=MIN, group=group)
        return out

    dg = pmin(d)
    eq = d == dg
    lg = pmin(torch.where(eq, l, IMAX))
    pg = pmin(torch.where(eq & (l == lg), p, IMAX))
    return dg, lg, pg
