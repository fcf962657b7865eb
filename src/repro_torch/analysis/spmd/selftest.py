"""Seeded-violation programs: one deliberately broken torch program per rule.

The counterpart of ``repro.analysis.spmd.selftest``.  Each seed rebuilds a
bug class in miniature and must be caught by the analyzer; CI runs them
(``--seed-violation RULE``) to prove the gate fires before trusting its
green runs:

  SP01  a per-rank partial sum of a split input read on the host without a
        reduction (the unreduced loop-flag / telemetry-channel bug).
  SP02  a collective over a diagonal group of ranks (0, 3) / (1, 2), which
        is none of the mesh's ``group(axes)``.
  SP03  a collective under a branch on the rank's "model" coordinate: the
        ranks of a "model" group record different sequences, a real mesh
        deadlocks.
  NU01  ``arange(70000)`` cast to int16 (the ``lab_i16`` overflow).
  NU02  integers past 2^24 cast to float32 (exactness loss).
  DN01  an in-place write into a buffer the region was handed, then a read
        of a view of it taken before (the ``EllPatcher`` class).

The mesh seeds run their 4 ranks of a (2, 2) mesh one after another in
this process, each on a world of the ``fake`` process group (collectives
return at once, so a seeded deadlock cannot hang); the analyses read the
recordings only, never the values.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.spmd.dispatch_tools import Recorder, Recording
from repro_torch.analysis.spmd.harness import MESH_DIMS, analyze_recordings

SEEDABLE_RULES = ("SP01", "SP02", "SP03", "NU01", "NU02", "DN01")


def _fake_ranks(program: Callable, split: bool = False) -> List[Recording]:
    """``program(mesh, shard)`` recorded on each rank of a fake (2, 2)
    world in turn; ``shard`` is declared split along both axes when
    ``split``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.core.mesh import Mesh

    if dist.is_initialized():
        raise RuntimeError("the mesh seeds make their own worlds: none may exist yet")
    world = MESH_DIMS[0] * MESH_DIMS[1]
    recs = []
    for rank in range(world):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
        try:
            mesh = Mesh(MESH_DIMS, ("data", "model"))
            shard = torch.arange(4.0) + 4 * rank
            with Recorder() as rec:
                program(mesh, shard)
            recs.append(rec.recording(mesh=mesh,
                                      inputs={shard: mesh.axis_names} if split else None))
        finally:
            dist.destroy_process_group()
    return recs


def _seed_sp01() -> List[Recording]:
    def program(mesh, shard):
        partial = shard.sum()  # per-rank partial: never reduced
        return partial.item()

    return _fake_ranks(program, split=True)


def _seed_sp02() -> List[Recording]:
    import torch.distributed as dist

    def program(mesh, shard):
        diag = [dist.new_group([0, 3]), dist.new_group([1, 2])]
        g = diag[0] if mesh.rank in (0, 3) else diag[1]
        total = shard.sum()[None]
        dist.all_reduce(total, group=g)  # neither "data" nor "model"
        return total

    return _fake_ranks(program, split=True)


def _seed_sp03() -> List[Recording]:
    import torch.distributed as dist

    def program(mesh, shard):
        total = torch.zeros(1)
        if mesh.coords["model"] == 0:  # only one rank of each model group
            dist.all_reduce(total, group=mesh.group(("model",)))
        return total

    return _fake_ranks(program)


def _record(program: Callable, *args) -> List[Recording]:
    with Recorder() as rec:
        program(*args)
    return [rec.recording()]


def _seed_nu01() -> List[Recording]:
    def program():
        labels = torch.arange(70000, dtype=torch.int32)
        return labels.to(torch.int16)  # 69999 > 32767: silent wrap

    return _record(program)


def _seed_nu02() -> List[Recording]:
    def program():
        idx = torch.arange(8, dtype=torch.int32) + (1 << 25)
        return idx.to(torch.float32)  # 2^25 > 2^24: inexact integers

    return _record(program)


def _seed_dn01() -> List[Recording]:
    buf = torch.ones(8)  # the caller's buffer: not the region's

    def program(b):
        head = b[:4]
        b.mul_(2.0)  # writes the caller's buffer in place
        return head + 1.0  # a view taken before the write: stale

    return _record(program, buf)


_SEEDS = {
    "SP01": _seed_sp01,
    "SP02": _seed_sp02,
    "SP03": _seed_sp03,
    "NU01": _seed_nu01,
    "NU02": _seed_nu02,
    "DN01": _seed_dn01,
}


def seed_findings(rule: str) -> List[Finding]:
    """Analyzer output on the seeded program for ``rule``.

    The caller (CLI ``--seed-violation``, CI, tests) asserts that the
    expected rule id is present: an empty result means the analyzer lost
    the bug class and the gate is blind."""
    if rule not in _SEEDS:
        raise KeyError(f"no seeded program for {rule!r}; seedable: {SEEDABLE_RULES}")
    return analyze_recordings(_SEEDS[rule](), context=f"selftest/{rule}")
