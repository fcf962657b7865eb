"""Divisibility-aware sharding construction, over DTensor.

The PyTorch counterpart of ``repro.distributed.sharding``.  The reference's
names map onto ``torch.distributed.tensor`` one to one:

  ``jax.sharding.Mesh``                ``DeviceMesh`` with the same axis names
                                       (or :class:`AbstractMesh`: names and
                                       sizes, no devices, for spec tables)
  ``PartitionSpec``                    :class:`P`, the port's own spec tuple
  ``NamedSharding(mesh, spec)``        :class:`NamedSharding`: its DTensor
                                       ``placements``, ``shard_shape`` and
                                       ``distribute``
  ``with_sharding_constraint(x, s)``   :func:`constrain`: ``DTensor.redistribute``
  ``device_put(a, sharding)``          :meth:`NamedSharding.distribute`: each
                                       rank slices its own shard out of the
                                       host array

GSPMD requires explicit input shardings to divide the dimension evenly.
``sanitize_spec`` drops any mesh axis whose size doesn't divide the
corresponding dimension (falling back to replication for that dim) so odd
dimensions — granite's 49155 vocab, Cora's 2708 nodes — never hard-fail.

A spec entry that names several axes (``("data", "model")``) splits its
dim over them major to minor; DTensor splits a dim that carries several
``Shard`` placements in mesh-dim order, so such an entry must list its axes
in the mesh's order (every spec of the reference does), and any other order
raises.  A mesh axis of size one holds the whole dim either way, and its
placement is ``Replicate()``.

Where XLA partitions every op of a step, the port runs each piece of a step
on the local shards with :func:`local_call`, between the constraints that
say how its inputs and outputs are laid out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence, Tuple

import torch


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None`` (not
    split), an axis name, or a tuple of axis names.  Entries are normalised
    as the reference's ``PartitionSpec`` normalises them: a list becomes a
    tuple, an empty tuple ``None`` and a one-name tuple that name."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (list, tuple)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e

        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class AbstractMesh:
    """A mesh's axis names and sizes with no devices behind them (the
    reference's ``jax.sharding.AbstractMesh``): enough for spec tables and
    shard shapes of meshes larger than the world at hand."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of an :class:`AbstractMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _axes_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return mesh_shape(mesh)[entry]
    size = 1
    for a in entry:
        size *= mesh_shape(mesh)[a]
    return size


def sanitize_spec(mesh, shape: Sequence[int], spec: Sequence) -> P:
    """Returns a spec with non-dividing axes dropped per-dim."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(None)
            continue
        if shape[i] % _axes_size(mesh, entry) == 0:
            out.append(entry)
        else:
            # try single axes out of a tuple before giving up
            if isinstance(entry, (tuple, list)):
                kept = None
                for a in entry:
                    if shape[i] % mesh_shape(mesh)[a] == 0:
                        kept = a
                        break
                out.append(kept)
            else:
                out.append(None)
    return P(*out)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes a spec entry names (none, one, or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec: Sequence, partial: Sequence[str] = (), partial_op: str = "sum") -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(i)`` where tensor dim ``i``'s entry names that axis,
    ``Partial(partial_op)`` for an axis in ``partial`` (a reduction still to
    be taken over it), else ``Replicate()``; an axis of size one is always
    ``Replicate()``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    names = axis_names(mesh)
    sizes = mesh_shape(mesh)
    where: Dict[str, int] = {}
    for i, entry in enumerate(spec):
        axes = entry_axes(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} lists its axes out of the mesh's "
                             f"order {names}: DTensor would lay the dim out differently")
        for a in axes:
            if a in where:
                raise ValueError(f"axis {a!r} splits two dims of {spec!r}")
            where[a] = i
    out = []
    for a in names:
        if sizes[a] == 1:
            out.append(Replicate())
        elif a in where:
            out.append(Shard(where[a]))
        elif a in partial:
            out.append(Partial(partial_op))
        else:
            out.append(Replicate())
    return tuple(out)


class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    def __init__(self, mesh, spec: Sequence = ()):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """One device's block of a ``shape`` array; raises where an entry
        does not divide its dim, as the reference does."""
        out = []
        for i, s in enumerate(shape):
            n = _axes_size(self.mesh, self.spec[i] if i < len(self.spec) else None)
            if s % n:
                raise ValueError(f"{self!r}: dim {i} of {tuple(shape)} is not split "
                                 f"evenly {n} ways")
            out.append(s // n)
        return tuple(out)

    def distribute(self, t: torch.Tensor, *, device=None):
        """The DTensor of the full array ``t`` (on any device, typically the
        host): this rank slices its own shard out of ``t`` and moves only
        that to ``device`` (default: the mesh's device type)."""
        from torch.distributed.tensor import DTensor, Shard

        mesh = self.mesh
        pl = self.placements
        local = t
        coord = mesh.get_coordinate()
        for j, p in enumerate(pl):  # mesh-dim order: DTensor's nesting
            if isinstance(p, Shard):
                local = local.tensor_split(mesh.size(j), dim=p.dim)[coord[j]]
        local = local.to(device or mesh_device(mesh)).contiguous()
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=contiguous_stride(t.shape))


def mesh_device(mesh) -> torch.device:
    """This rank's device of a ``DeviceMesh``: the current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def named_sharding(mesh, shape: Sequence[int], *spec) -> NamedSharding:
    """NamedSharding(mesh, sanitize_spec(...)) convenience."""
    return NamedSharding(mesh, sanitize_spec(mesh, shape, spec))


# ----------------------------------------------------------------------------
# Constraints and local compute on DTensors
# ----------------------------------------------------------------------------


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x, spec):
    """``with_sharding_constraint``: a DTensor is redistributed to ``spec``
    (a :class:`P` or a :class:`NamedSharding`) on its own mesh; a plain
    tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    return _to_spec(x, spec.spec if isinstance(spec, NamedSharding) else spec)


def _to_spec(x, spec, *, strict: bool = False):
    """``x`` redistributed to ``spec``, sanitized against its shape (where
    the reference's constraint would split a dim unevenly, the axis is
    dropped, as ``sanitize_spec`` drops it); ``strict`` raises there
    instead."""
    mesh = x.device_mesh
    clean = sanitize_spec(mesh, x.shape, spec)
    if strict and clean != P(*spec):
        raise ValueError(f"{P(*spec)!r} does not split {tuple(x.shape)} evenly on {mesh}")
    return to_placements(x, placements(mesh, clean))


def local_call(fn, args: Sequence[Any], in_specs: Sequence, out_specs, *,
               partial: Sequence[str] = (), partial_op: str = "sum"):
    """``fn`` on this rank's local shards: the SPMD body between
    constraints (the reference lets XLA partition each op; the port names
    each piece's layout and runs it as plain PyTorch).

    Every DTensor in ``args`` (or in a dict of them) whose ``in_specs``
    entry is a spec is first redistributed to it (a gather where the piece
    needs more than the shard; the spec must split the tensor evenly) and
    handed to ``fn`` as its local tensor; other args pass as they are.  A
    dict's entry is one spec for every leaf or a dict of specs by key.
    ``fn``'s output (a tensor or a tuple of them) is wrapped back with
    ``out_specs`` (a spec or a tuple of specs), ``Partial(partial_op)`` on
    the axes in ``partial`` (each rank holds a term of a sum, or of a max,
    over them).  With no
    DTensor among ``args`` it is ``fn(*args)``: one body serves the sharded
    step and the one-device step.

    Gradients: an input replicated over a mesh axis on which an output is
    split (sharded or partial) gets a partial gradient there (each rank
    differentiates its own part), reduced by the redistribute's backward.
    That holds only if every output is split on that axis (an output
    replicated there would bring each rank the whole gradient), so a piece
    whose outputs differ there raises.
    """
    from repro_torch.tree import tree_leaves

    def leaves(a):
        return [t for x in a for t in leaves(x)] if isinstance(a, tuple) else tree_leaves(a)

    mesh = next((t.device_mesh for a in args for t in leaves(a) if is_dtensor(t)), None)
    if mesh is None:  # plain tensors: the one-device body itself
        return fn(*(_alias(a) for a in args))

    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    single = isinstance(out_specs, P) or not out_specs or not isinstance(out_specs[0], (tuple, list))
    outs_spec = [out_specs] if single else list(out_specs)
    out_pl = [placements(mesh, s, partial, partial_op) for s in outs_spec]
    split = {j for pl in out_pl for j, p in enumerate(pl) if isinstance(p, (Shard, Partial))}
    if any(isinstance(pl[j], Replicate) for pl in out_pl for j in split):
        raise ValueError(f"outputs {out_pl} split and replicated on one mesh axis: their "
                         "inputs' gradients would be neither whole nor partial")

    def localize(a, spec):
        if isinstance(a, dict):  # a tree of parameters: one spec, or one for each key
            if isinstance(spec, dict):
                return {k: localize(v, spec[k]) for k, v in a.items()}
            return {k: localize(v, spec) for k, v in a.items()}
        if isinstance(a, tuple):  # a tuple of tensors: one spec, or a tuple of them
            if spec is None or isinstance(spec, P):
                return tuple(localize(v, spec) for v in a)
            return tuple(localize(v, s) for v, s in zip(a, spec))
        if spec is None or not is_dtensor(a):
            return a
        a = _to_spec(a, spec, strict=True)
        if not a.requires_grad:
            return a.to_local()
        grad = [Partial() if isinstance(p, Replicate) and j in split else p
                for j, p in enumerate(a.placements)]
        return a.to_local(grad_placements=grad)

    local = [localize(a, spec) for a, spec in zip(args, in_specs)]
    out = fn(*local)
    outs = [out] if single else list(out)
    wrapped = [DTensor.from_local(o, mesh, pl, run_check=False)
               for o, pl in zip(outs, out_pl)]
    return wrapped[0] if single else tuple(wrapped)


def _alias(a):
    """A differentiable input as a view of itself: the piece's gradient of
    it is summed inside the piece first and reaches it as one term, as it
    does through ``to_local`` on DTensors (so a piece on a (1, 1) mesh sums
    its gradients in the one-device order, bit for bit)."""
    if isinstance(a, dict):
        return {k: _alias(v) for k, v in a.items()}
    if isinstance(a, tuple):
        return tuple(_alias(v) for v in a)
    return a.view_as(a) if isinstance(a, torch.Tensor) and a.requires_grad else a


def model_spec(t, dims: Sequence[int] = ()) -> P:
    """The tensor-parallel layout of a weight: ``t``'s split over "model"
    alone where it splits one of ``dims`` (P() otherwise, and for a plain
    tensor).  As a ``local_call`` in-spec it gathers the weight over every
    other axis (the ZeRO axes) and keeps the "model" shard."""
    from torch.distributed.tensor import Shard

    if not is_dtensor(t) or "model" not in t.device_mesh.mesh_dim_names:
        return P()
    p = t.placements[t.device_mesh.mesh_dim_names.index("model")]
    if not isinstance(p, Shard) or p.dim not in dims:
        return P()
    return P(*("model" if i == p.dim else None for i in range(t.ndim)))


def is_split(spec: Sequence, axis: str = "model") -> bool:
    """Whether a spec splits some dim over ``axis``."""
    return any(axis in entry_axes(e) for e in spec)


def model_index(x) -> int:
    """This rank's position along "model" of ``x``'s mesh (0 for a plain
    tensor or a mesh without that axis)."""
    if not is_dtensor(x) or "model" not in x.device_mesh.mesh_dim_names:
        return 0
    return axes_index(x.device_mesh, ("model",))


def model_size(x) -> int:
    """The size of "model" on ``x``'s mesh (1 for a plain tensor)."""
    if not is_dtensor(x):
        return 1
    return mesh_shape(x.device_mesh).get("model", 1)


def spec_of(t) -> P:
    """A DTensor's placements as a spec (its shards only)."""
    names = t.device_mesh.mesh_dim_names
    spec = [[] for _ in range(t.ndim)]
    for j, p in enumerate(t.placements):
        if getattr(p, "dim", None) is not None and p.is_shard():
            spec[p.dim].append(names[j])
    return P(*spec)


def axes_index(mesh, axes: Sequence[str]) -> int:
    """This rank's position along ``axes`` of a ``DeviceMesh`` (row-major in
    the mesh's order: the block of a dim sharded over ``axes`` it holds)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx = 0
    for a in axes:
        idx = idx * mesh_shape(mesh)[a] + coord[a]
    return idx


class ShapeDtypeStruct:
    """A tensor's shape, dtype and sharding, with no storage (the
    reference's ``jax.ShapeDtypeStruct``): what the spec tables return."""

    def __init__(self, shape: Sequence[int], dtype, sharding: NamedSharding):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.sharding = sharding

    def __repr__(self) -> str:
        return f"ShapeDtypeStruct({self.shape}, {self.dtype}, {self.sharding.spec!r})"


def zeros_from_struct(s: ShapeDtypeStruct, *, device=None):
    """A DTensor of zeros laid out by ``s``: each rank allocates its own
    block only (on ``device``, by default the mesh's)."""
    from torch.distributed.tensor import DTensor

    sh = s.sharding
    local = torch.zeros(sh.shard_shape(s.shape), dtype=s.dtype,
                        device=device or mesh_device(sh.mesh))
    return DTensor.from_local(local, sh.mesh, sh.placements, run_check=False,
                              shape=s.shape, stride=contiguous_stride(s.shape))


def zeros_from_specs(specs, *, device=None):
    """DTensors of zeros laid out by a tree of ShapeDtypeStructs: dicts,
    tuples (a KV cache stack) and dataclasses (an 8-bit optimizer state's
    payload and scales) inside it are rebuilt around their zeros; each rank
    allocates its own blocks only."""
    def one(s):
        if isinstance(s, ShapeDtypeStruct):
            return zeros_from_struct(s, device=device)
        if isinstance(s, dict):
            return {k: one(v) for k, v in s.items()}
        if isinstance(s, tuple):
            return tuple(one(v) for v in s)
        if dataclasses.is_dataclass(s):
            return dataclasses.replace(s, **{f.name: one(getattr(s, f.name))
                                             for f in dataclasses.fields(s)})
        return s

    return one(specs)


def distribute_tree(tree, shardings, *, device=None):
    """The host tensors of ``tree`` as DTensors, each placed by the
    ``NamedSharding`` (or ``ShapeDtypeStruct``) at its place in
    ``shardings``; the reference's ``jax.device_put(tree, shardings)``."""
    from repro_torch.tree import tree_map

    def one(t, s):
        sh = s.sharding if isinstance(s, ShapeDtypeStruct) else s
        return sh.distribute(t, device=device)

    return tree_map(one, tree, shardings)


def shift_placements(pl, by: int) -> tuple:
    from torch.distributed.tensor import Shard

    return tuple(Shard(p.dim + by) if isinstance(p, Shard) else p for p in pl)


def unstack_leaf(t) -> list:
    """A stacked (L, ...) tensor's layer pieces, unbound once along dim 0.

    A plain tensor gives its slices; a DTensor whose layer dim is whole
    gives DTensor slices with the stack's other placements (views of the
    local block: nothing is gathered).  A DTensor split over its layer dim
    (the ZeRO axes of ``_fsdp`` land there when they divide L) holds each
    layer on one rank of those axes: it gives a :class:`LayerShard` for
    every layer, which :func:`gather_layer` turns into the layer's DTensor
    where the layer runs, one layer at a time."""
    if not is_dtensor(t):
        return list(t.unbind(0))
    from torch.distributed.tensor import DTensor, Shard

    mesh = t.device_mesh
    pl = tuple(t.placements)
    split = [j for j, p in enumerate(pl) if isinstance(p, Shard) and p.dim == 0]
    block = t.to_local()
    if not split:
        slice_pl = shift_placements(pl, -1)
        return [DTensor.from_local(s, mesh, slice_pl, run_check=False) for s in block.unbind(0)]
    stack = _SplitStack(t, split)
    dummy = block.new_zeros(())
    # holds(): the host's test of which layers this rank keeps
    return [LayerShard(block[i - stack.first] if stack.holds(i) else dummy,  # jitlint: ignore[TS02]
                       stack, stack.holds(i))
            for i in range(t.shape[0])]


class _SplitStack:
    """What every layer of a stack split over its layer dim shares: its
    mesh, placements and shape, and the layers this rank holds."""

    def __init__(self, t, split):
        from torch.distributed.tensor import Partial, Replicate

        self.mesh = t.device_mesh
        self.placements = tuple(t.placements)
        self.shape = tuple(t.shape)
        n = math.prod(self.mesh.size(j) for j in split)
        if self.shape[0] % n:
            raise ValueError(f"a stack of {self.shape[0]} layers split {n} ways")
        names = self.mesh.mesh_dim_names
        self.blk = self.shape[0] // n
        self.first = axes_index(self.mesh, [names[j] for j in split]) * self.blk
        whole = tuple(Replicate() if j in split else p for j, p in enumerate(self.placements))
        self.slice_pl = shift_placements(whole, -1)
        self.held_pl = shift_placements(
            tuple(Partial() if j in split else p for j, p in enumerate(self.placements)), -1)
        self.local_shape = tuple(t.to_local().shape[1:])

    def holds(self, i: int) -> bool:
        return self.first <= i < self.first + self.blk


class LayerShard:
    """One layer of a stack split over its layer dim, as this rank holds
    it: ``local`` is the layer's slice of the local block on the rank that
    holds the layer (``held``), a 0-d stand-in elsewhere.  The train step
    takes its gradients with respect to ``local`` on every rank (the
    stand-ins get zeros), so each rank's gradients are its own layers."""

    __slots__ = ("local", "stack", "held")

    def __init__(self, local, stack: _SplitStack, held: bool):
        self.local, self.stack, self.held = local, stack, held

    def with_local(self, local) -> "LayerShard":
        return LayerShard(local, self.stack, self.held)


def leaf_tensor(x):
    """The tensor of a layer piece: a :class:`LayerShard`'s ``local``."""
    return x.local if isinstance(x, LayerShard) else x


class _GatherLayer(torch.autograd.Function):
    """A layer of a split stack as a DTensor replicated over the split
    axes: in the forward pass the holder's slice summed with zeros from the
    others (one all-reduce of one layer); in the backward pass the layer's
    gradient reduced to the slice's placements, of which the holder keeps
    its slice's and the others return zeros for their stand-ins."""

    @staticmethod
    def forward(ctx, local, piece):
        from torch.distributed.tensor import DTensor

        st = piece.stack
        ctx.piece = piece
        buf = (local.detach().clone() if piece.held  # jitlint: ignore[TS02] a host flag
               else local.new_zeros(st.local_shape))
        shape = st.shape[1:]
        part = DTensor.from_local(buf, st.mesh, st.held_pl, run_check=False, shape=shape,
                                  stride=contiguous_stride(shape))
        return part.redistribute(st.mesh, st.slice_pl)

    @staticmethod
    def backward(ctx, g):
        piece = ctx.piece
        g = to_placements(g, piece.stack.slice_pl).to_local()
        return (g if piece.held else g.new_zeros(())), None


def gather_layer(x):
    """A layer piece ready to compute with: a :class:`LayerShard` gathered
    (see :class:`_GatherLayer`), anything else as it is.  Called inside the
    block that reads the layer, so the recomputed block gathers it again
    and only one layer of a split stack is whole at a time."""
    return _GatherLayer.apply(x.local, x) if isinstance(x, LayerShard) else x


def stack_slices(slices: Sequence) -> Any:
    """The inverse of :func:`unstack_leaf` for gradients: DTensor slices of
    equal placements stacked under a dim-0 ``Replicate()``; the
    :class:`LayerShard` gradients of a split stack as the DTensor of the
    stack's own placements (each rank stacks the layers it holds)."""
    from torch.distributed.tensor import DTensor, Partial

    if isinstance(slices[0], LayerShard):
        st = slices[0].stack
        local = torch.stack([s.local for s in slices if s.held])
        return DTensor.from_local(local, st.mesh, st.placements, run_check=False,
                                  shape=st.shape, stride=contiguous_stride(st.shape))
    pl = tuple(slices[0].placements)
    if any(isinstance(p, Partial) for p in pl) or any(tuple(s.placements) != pl for s in slices):
        raise ValueError(f"slices to stack must share one placement without partial sums, "
                         f"got {[tuple(s.placements) for s in slices]}")
    return DTensor.from_local(torch.stack([s.to_local() for s in slices]),
                              slices[0].device_mesh, shift_placements(pl, 1), run_check=False)


def full(x):
    """A DTensor's whole value (partial sums reduced, shards gathered); a
    plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def gather_to_host(t):
    """The whole of a DTensor on the host of global rank 0, None on the
    other ranks: each block is sent to rank 0 on its own and copied to the
    host there, so no device holds more than its own block and one more
    (every rank of the mesh calls it; a block held by several ranks is
    sent by the first of them)."""
    import itertools

    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    mesh = t.device_mesh
    pl = tuple(Replicate() if p.is_partial() else p for p in t.placements)
    if pl != tuple(t.placements):
        t = t.redistribute(mesh, pl)
    ranks = mesh.mesh
    if 0 not in ranks.flatten().tolist():
        raise ValueError("rank 0 gathers a DTensor's blocks, and is not on its mesh")
    me = dist.get_rank()
    local = t.to_local().contiguous()
    out = torch.empty(t.shape, dtype=t.dtype) if me == 0 else None
    for coord in itertools.product(*(range(n) for n in ranks.shape)):
        if any(c and not isinstance(p, Shard) for c, p in zip(coord, pl)):
            continue  # a copy of a block that another rank sends
        idx = [slice(None)] * t.ndim
        size = list(t.shape)
        start = [0] * t.ndim
        for j, p in enumerate(pl):
            if isinstance(p, Shard):
                n = ranks.shape[j]
                if size[p.dim] % n:
                    raise ValueError(f"dim {p.dim} of {tuple(t.shape)} not split evenly")
                size[p.dim] //= n
                start[p.dim] += coord[j] * size[p.dim]
                idx[p.dim] = slice(start[p.dim], start[p.dim] + size[p.dim])
        src = int(ranks[coord])
        if src == me == 0:
            out[tuple(idx)] = local.cpu()
        elif me == src:
            dist.send(local, dst=0)
        elif me == 0:
            buf = torch.empty(size, dtype=local.dtype, device=local.device)
            dist.recv(buf, src=src)
            out[tuple(idx)] = buf.cpu()
    return out


def to_placements(x, pl):
    """A DTensor (which may hold partial sums) redistributed to the
    placements ``pl``; a plain tensor as it is."""
    if not is_dtensor(x) or tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(x.device_mesh, tuple(pl))


def like(g, p):
    """A gradient laid out like its parameter (see :func:`to_placements`)."""
    return to_placements(g, p.placements) if is_dtensor(p) else g
