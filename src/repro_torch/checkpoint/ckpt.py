"""Fault-tolerance substrate: npz checkpoints of trees of tensors.

The PyTorch counterpart of ``repro.checkpoint.ckpt``, in the SAME on-disk
layout, so that either package restores the other's checkpoints:
  * one .npz per save; a key is the leaf's tree path joined by "/" (dict
    keys; a ``Q8State`` field is ``.../m/.q`` and ``.../m/.scale``, as JAX
    names a dataclass attribute);
  * bf16 is stored as a uint8 view with a trailing itemsize axis (a 0-d
    tensor as (2,)), the reference's layout for numpy kind 'V';
  * saves are ATOMIC (``.tmp.npz`` + ``os.replace``) and ASYNC: the state
    is copied to the host BEFORE the writer thread starts, so the next
    step may update the tensors in place;
  * a manifest written last guards torn restores; old checkpoints roll off
    by ``keep``; ``latest_step`` scans for the newest complete one.
Restore loads host arrays into the structure of a template and places them
on the caller's device, or, with ``shardings=`` (elastic restore onto the
current mesh), each rank slices its own shard of each host array and moves
only that to its device as a DTensor.  The file stays mesh-agnostic: a
DTensor leaf is saved as its full array, gathered block by block to rank
0's host (every rank takes part; no device holds the whole leaf); rank 0
writes, synchronously, and every rank waits for the file before it goes on,
so no rank can restore a checkpoint that is still being written.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import gather_to_host, is_dtensor

# dtypes numpy cannot hold, stored as their bits: torch and numpy views
_BITS = {torch.bfloat16: (torch.int16, np.int16)}


def _children(node):
    """(path entry, child) pairs of an inner node, in JAX's order; None for a
    leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name)) for f in dataclasses.fields(node)
                if isinstance(getattr(node, f.name), (torch.Tensor, np.ndarray))]
    return None


def _flatten_with_paths(tree: Any, prefix: str = "") -> dict:
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for k, child in kids:
        out.update(_flatten_with_paths(child, f"{prefix}/{k}" if prefix else k))
    return out


def _rebuild(template: Any, fn, prefix: str = "") -> Any:
    """``template``'s structure with each leaf replaced by ``fn(path, leaf)``."""
    kids = _children(template)
    if kids is None:
        return fn(prefix, template)
    new = {k: _rebuild(c, fn, f"{prefix}/{k}" if prefix else k) for k, c in kids}
    if isinstance(template, dict):
        return {k: new[str(k)] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(new[str(i)] for i in range(len(template)))
    return dataclasses.replace(template, **{k[1:]: v for k, v in new.items()})


def _to_native(t) -> np.ndarray:
    """A tensor as the numpy array the npz holds (a copy: the tensor may be
    updated in place while it is written): bf16 → raw uint8 bytes.  A
    DTensor is gathered to rank 0's host: None on the other ranks."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    if is_dtensor(t):
        t = gather_to_host(t.detach())
        if t is None:
            return None
    t = t.detach().to("cpu", copy=True)
    if t.dtype in _BITS:
        a = np.atleast_1d(t.view(_BITS[t.dtype][0]).numpy())
        return a.view(np.uint8).reshape(*t.shape, t.element_size())
    return t.numpy()


def _from_native(a: np.ndarray, want: torch.dtype) -> torch.Tensor:
    if want in _BITS:
        bits = np.dtype(_BITS[want][1])
        if a.dtype != np.uint8 or a.shape[-1:] != (bits.itemsize,):
            raise ValueError(f"a {want} leaf is stored as {a.dtype}{a.shape}")
        a = np.ascontiguousarray(a).view(bits).reshape(a.shape[:-1])
        return torch.from_numpy(a).view(want)
    return torch.from_numpy(np.array(a)).to(want)


def save_pytree(tree: Any, path: str | Path) -> None:
    """Atomic synchronous save of a tree to one .npz (DTensor leaves as
    their full arrays: every rank calls it, rank 0 writes, and every rank
    returns once the file is there)."""
    path = Path(path)
    flat = _flatten_with_paths(tree)
    arrays = {k: _to_native(v) for k, v in flat.items()}
    sharded = _sharded(flat)
    if not sharded or _writes():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp.npz")
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    if sharded:
        _barrier()


def _sharded(flat: dict) -> bool:
    return any(is_dtensor(t) for t in flat.values())


def _barrier() -> None:
    import torch.distributed as dist

    dist.barrier()


def load_pytree(template: Any, path: str | Path, *, device=None, shardings: Any = None) -> Any:
    """Restores into the structure (and leaf dtypes) of ``template``, on
    ``device`` (default: each template leaf's device).

    ``shardings``: optional tree of ``NamedSharding``s (or ``param_specs``'
    structs) in the template's structure: elastic restore onto their mesh,
    each leaf a DTensor of which this rank holds only its own shard."""
    with np.load(Path(path), allow_pickle=False) as z:
        if shardings is not None:
            flat_sh = _flatten_with_paths(shardings)

            def leaf(key, t):
                sh = flat_sh[key]
                sh = getattr(sh, "sharding", sh)
                return sh.distribute(_from_native(z[key], t.dtype), device=device)
        else:
            def leaf(key, t):
                out = _from_native(z[key], t.dtype)
                return out.to(t.device if device is None else device)

        return _rebuild(template, leaf)


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of a process group,
    or a process with none."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


class CheckpointManager:
    """Async, rolling checkpoint manager with crash-safe manifests.

    Usage:
      mgr = CheckpointManager(dir, keep=3)
      mgr.save(step, state)                  # returns once on the host
      step, state = mgr.restore(template)    # newest complete checkpoint
    """

    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:010d}"

    def save(self, step: int, state: Any, *, blocking: bool = False) -> None:
        """Snapshots ``state`` to the host and writes it on a thread; a state
        of DTensors is written by rank 0 before every rank returns."""
        # snapshot to host BEFORE handing to the writer thread: the next
        # step updates the tensors in place
        host = _rebuild(state, lambda _, t: _to_native(t))
        self.wait()
        sharded = _sharded(_flatten_with_paths(state))
        if sharded and not _writes():
            _barrier()  # until rank 0 has written the gathered arrays
            return

        def write():
            d = self._step_dir(step)
            d.mkdir(parents=True, exist_ok=True)
            save_pytree(host, d / "state.npz")
            manifest = {"step": step, "time": time.time(), "complete": True}
            tmp = d / "manifest.tmp"
            tmp.write_text(json.dumps(manifest))
            os.replace(tmp, d / "manifest.json")
            self._gc()

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking or sharded:
            self.wait()
        if sharded:
            _barrier()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            d = self._step_dir(s)
            for f in d.iterdir():
                f.unlink()
            d.rmdir()

    def steps(self):
        out = []
        for d in self.dir.glob("step_*"):
            m = d / "manifest.json"
            if m.exists():
                try:
                    if json.loads(m.read_text()).get("complete"):
                        out.append(int(d.name.split("_")[1]))
                except (json.JSONDecodeError, ValueError):
                    continue  # torn manifest → not restorable
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return max(steps) if steps else None

    def restore(self, template: Any, *, step: Optional[int] = None, device=None,
                shardings: Any = None):
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        state = load_pytree(template, self._step_dir(step) / "state.npz", device=device,
                            shardings=shardings)
        return step, state
