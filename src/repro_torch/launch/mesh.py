"""Production mesh construction, as ``DeviceMesh``es.

The counterpart of ``repro.launch.mesh``.  A pod of 256 cards is
(data=16, model=16); the multi-pod config stacks a leading "pod" axis
(pure DP across pods).  FUNCTIONS, not module constants, so importing
never touches the process group.

A mesh spans the ranks of an initialised ``torch.distributed`` world, one
rank a card, in row-major order over the axes.  A mesh of one position
with no process group yet makes a world of one itself (NCCL for the card
where PyTorch has it, gloo for the CPU, on a ``HashStore``), as the Steiner
engine's ``repro_torch.core.mesh.device_mesh`` does.
"""

from __future__ import annotations

import math
from datetime import timedelta
from typing import Sequence

import torch
import torch.distributed as dist


def _world(need: int) -> int:
    if not dist.is_initialized():
        if need > 1:
            raise RuntimeError(
                f"a mesh of {need} ranks needs torch.distributed initialised with at "
                f"least {need} ranks (for example with torchrun)")
        from repro_torch.core.mesh import _world_backend

        dist.init_process_group(backend=_world_backend(), store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timedelta(seconds=600))
    return dist.get_world_size()


def _mesh(shape: Sequence[int], axes: Sequence[str], device: str):
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    need = math.prod(shape)
    have = _world(need)
    if have < need:
        raise RuntimeError(f"need {need} ranks for mesh {shape}, have {have}")
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_initialized():
        torch.cuda.set_device(dist.get_rank() % max(torch.cuda.device_count(), 1))
    # more ranks than needed (e.g. 512 ranks, single-pod 256): the first ones
    mesh = DeviceMesh(device_type, torch.arange(need).reshape(shape), mesh_dim_names=axes)
    if mesh.ndim > 1:
        # the group over every axis (the 8-bit AdamW's exchange), made here
        # on every rank in the same order, and cached on the mesh
        mesh._flatten()
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), *, device: str = "cuda"):
    """Small mesh for tests (gloo ranks with ``device="cpu"``)."""
    return _mesh(shape, axes, device)
