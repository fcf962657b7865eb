"""Record-and-analyze harness: every backend x mode combo, one tiny solve.

The counterpart of ``repro.analysis.spmd.harness``.  The combos come from
the live solver registry (``BACKEND_MODES``), each configured with the
reference's ``_combo_config`` knobs, and each solve runs through the same
``SteinerSolver(cfg).prepare(g).solve(seeds)`` a user calls, on the
reference's 16-vertex ring with its seeds (0, 5, 11), recorded by
:class:`~repro_torch.analysis.spmd.dispatch_tools.Recorder`.

``single`` and ``batch`` run in this process on the CPU.  ``mesh1d`` and
``mesh2d`` run on 4 gloo CPU ranks, a (2, 2) world: a (1, 1) world cannot
show what varies by rank, since the port bakes ``mesh.coords`` into Python
ints.  The harness starts the 4 rank processes once for every mesh combo
asked for (``python -m repro_torch.analysis.spmd.harness``); they meet
through a ``FileStore`` in a temporary directory and write their
recordings there.  Each rank declares its edge shard as varying along
every mesh axis.  The recordings do not depend on the machine.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.findings import Finding, sort_findings
from repro_torch.analysis.spmd import donation, intervals, uniformity
from repro_torch.analysis.spmd.dispatch_tools import Recorder, Recording, Violation

_TINY_N = 16
_TINY_SEEDS = (0, 5, 11)
MESH_DIMS = (2, 2)
MESH_BACKENDS = ("mesh1d", "mesh2d")
_RANK_TIMEOUT_S = 300


def tiny_graph():
    """16-vertex weighted ring + chords: every mode's loop does real work."""
    from repro_torch.core.graph import from_edges

    n = _TINY_N
    src = list(range(n)) + [0, 4, 8]
    dst = [(i + 1) % n for i in range(n)] + [8, 12, 2]
    w = [1.0 + 0.25 * (i % 3) for i in range(len(src))]
    return from_edges(np.asarray(src), np.asarray(dst), np.asarray(w, np.float32), n,
                      pad_to=8, device="cpu")


def combos() -> Iterator[Tuple[str, str]]:
    """(backend, mode) pairs from the live registry, deterministic order."""
    from repro_torch.solver.config import BACKEND_MODES

    for backend in sorted(BACKEND_MODES):
        for mode in BACKEND_MODES[backend]:
            yield backend, mode


def combo_config(backend: str, mode: str):
    """The reference's ``_combo_config`` knobs, on a (2, 2) mesh."""
    from repro_torch.solver.config import SolverConfig

    kw: Dict[str, object] = dict(
        backend=backend, mode=mode, max_iters=8, telemetry_rounds=2, ell_width=4)
    if backend in MESH_BACKENDS:
        kw["mesh_shape"] = MESH_DIMS
    if backend == "mesh1d" and mode != "frontier":
        kw["local_steps"] = 2  # frontier must exchange top-K every round
    if mode == "pallas":
        kw["interpret"] = True
        kw["block_rows"] = 8
    if mode in ("frontier", "pallas"):
        kw["frontier_size"] = 8
    return SolverConfig(**kw)


def _seeds(backend: str):
    seeds = np.asarray(_TINY_SEEDS, np.int32)
    return np.stack([seeds, seeds[::-1]]) if backend == "batch" else seeds


def record_combo(backend: str, mode: str, digests: bool = False) -> Recording:
    """One solve of a combo recorded in this process (on the caller's
    mesh rank for the mesh backends)."""
    from repro_torch.solver import SteinerSolver

    handle = SteinerSolver(combo_config(backend, mode), device="cpu").prepare(tiny_graph())
    with Recorder(digests=digests) as rec:
        handle.solve(_seeds(backend))
    mesh = handle.artifact("mesh")
    inputs = {}
    if mesh is not None:
        inputs = {t: mesh.axis_names for t in handle.artifact("edges")}
    return rec.recording(mesh=mesh, inputs=inputs)


def analyze_recordings(recs: Sequence[Recording], context: str) -> List[Finding]:
    """All three analyses over one combo's recordings → Findings (one per
    rule and source line)."""
    violations: List[Violation] = []
    violations += uniformity.analyze(recs)
    violations += intervals.analyze(recs)
    violations += donation.analyze(recs)
    out, seen = [], set()
    for v in violations:
        f = v.to_finding(context)
        if f is None or (f.rule, f.path, f.line) in seen:
            continue
        seen.add((f.rule, f.path, f.line))
        out.append(f)
    return out


# ----------------------------------------------------------------------------
# the mesh ranks
# ----------------------------------------------------------------------------


def channel_program(mesh):
    """The ground truth's seeded channels: ``varying`` holds the rank's
    "model" coordinate (varying along "model"), ``uniform`` its sum over
    the "model" group (uniform)."""
    import torch

    from repro_torch.core.mesh import SUM, all_reduce

    varying = torch.full((4,), float(mesh.axis_index(("model",))))
    uniform = all_reduce(varying, SUM, mesh.group(("model",)))
    return varying.tolist(), uniform.tolist()


def _rank_main(argv: Sequence[str]) -> None:
    """One mesh rank: ``RANK WORLD STORE_DIR DIGESTS COMBO...`` (COMBO as
    backend/mode, or "channel")."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.mesh import device_mesh

    rank, world, store_dir, digests = int(argv[0]), int(argv[1]), argv[2], argv[3] == "1"
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = {}
        for spec in argv[4:]:
            if spec == "channel":
                mesh = device_mesh(MESH_DIMS, ("data", "model"))
                with Recorder(digests=digests) as rec:
                    channel_program(mesh)
                out[spec] = rec.recording(mesh=mesh)
            else:
                backend, mode = spec.split("/")
                out[spec] = record_combo(backend, mode, digests)
        with open(os.path.join(store_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def record_mesh(specs: Sequence[str], digests: bool = False) -> Dict[str, List[Recording]]:
    """Runs ``specs`` (backend/mode combos, or "channel") on 4 gloo ranks
    of a (2, 2) world started together; returns spec -> the 4 ranks'
    recordings."""
    world = int(np.prod(MESH_DIMS))
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in (src, os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.analysis.spmd.harness", str(r), str(world),
             tmp, "1" if digests else "0", *specs],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=_RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"mesh ranks failed {bad}:\n" + "\n".join(logs))
        per_rank = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                per_rank.append(pickle.load(fh))
    return {spec: [d[spec] for d in per_rank] for spec in specs}


def analyze_all(
    only: Optional[Tuple[str, str]] = None, quiet: bool = True, echo=print
) -> List[Finding]:
    """Findings across every registered combo (or one, with ``only``)."""
    todo = [c for c in combos() if only is None or c == only]
    out: List[Finding] = []
    mesh_specs = [f"{b}/{m}" for b, m in todo if b in MESH_BACKENDS]
    mesh_recs = record_mesh(mesh_specs) if mesh_specs else {}
    for backend, mode in todo:
        if not quiet:
            echo(f"recording {backend}/{mode} ...")
        spec = f"{backend}/{mode}"
        recs = mesh_recs[spec] if spec in mesh_recs else [record_combo(backend, mode)]
        out.extend(analyze_recordings(recs, context=spec))
    return sort_findings(out)


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
