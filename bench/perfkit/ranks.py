"""The launcher of a cell over several cards: one rank a card, run SPMD as
the port's mesh backends run (one process a mesh position,
``repro_torch.core.mesh``).

:func:`launch` starts ``chips`` rank processes at once, each
``bench/run.py`` with ``--rank-spec`` and ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` in its environment; rank 0 serves the world's store on a
free port of ``127.0.0.1`` that the launcher found.  Each rank runs
:func:`perfkit.harness.rank_main`.  Only rank 0 writes the result, to the
launcher through a pipe; no other rank writes to standard output.  The
launcher returns the result once every rank has exited 0.  Where a rank
exits with another code, or the ranks pass :func:`limit_s`, it kills every
rank with its process group and the run gives no result.

This module imports neither torch nor the program, so the ranks start
their imports at once and not after the launcher's own.
"""

from __future__ import annotations

import json
import math
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SETUP_ALLOWANCE_S = 180.0  # imports, the graph, the host partition, a first build
REFERENCE_ALLOWANCE_S = 90.0  # the window's end, the teardown, the reference
RESULT = "perfkit-result "  # rank 0's line to the launcher


def limit_s(seconds: float) -> float:
    """The launcher's time limit, from its start: the window and the
    set-up and reference allowances."""
    return seconds + SETUP_ALLOWANCE_S + REFERENCE_ALLOWANCE_S


def mesh_size(cfg: dict) -> int:
    """The ranks a configuration's ``mesh_shape`` multiplies out to."""
    return math.prod(cfg.get("solver", {}).get("mesh_shape", [1]))


class Launch:
    """What the launcher saw: its exit code, rank 0's result and check lines
    (None and [] where the run gives no result), why it failed, and the
    ranks' process ids."""

    def __init__(self, rc: int, result: Optional[dict], lines: List[str], why: str,
                 pids: List[int]):
        self.rc, self.result, self.lines, self.why, self.pids = rc, result, lines, why, pids


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _kill(procs) -> None:
    """Kills each rank's process group (the rank and whatever it started)
    and reaps the ranks."""
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for p in procs:
        p.wait()


def _read_rank0(pipe, found: list) -> None:
    """Rank 0's standard output: the result line is kept, every other line
    goes to standard error."""
    for line in pipe:
        if line.startswith(RESULT):
            found.append(line[len(RESULT):])
        else:
            sys.stderr.write(line)
    pipe.close()


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def launch(workload: str, seed: int, seconds: float, trace: bool, chips: int, *,
           device: str = "cuda", t_start: Optional[float] = None, limit: Optional[float] = None,
           overrides: Optional[dict] = None, hook: Optional[str] = None) -> Launch:
    """Runs ``workload`` over ``chips`` ranks.  ``limit`` (seconds from
    ``t_start``) defaults to :func:`limit_s`; ``overrides`` and ``hook`` (a
    file whose ``plant(rank)`` each rank calls before its run) serve the
    tests on the CPU."""
    t_start = time.perf_counter() if t_start is None else t_start
    deadline = t_start + (limit_s(seconds) if limit is None else limit)
    spec = json.dumps({"workload": workload, "seed": seed, "seconds": seconds,
                       "trace": bool(trace), "device": device, "t_start": t_start,
                       "port": _free_port(), "launcher": os.getpid(),
                       "overrides": overrides, "hook": hook})
    args = [sys.executable, str(BENCH / "run.py"), "--workload", workload, "--seed", str(seed),
            "--seconds", str(seconds), "--trace", str(int(trace)), "--rank-spec", spec]
    procs, found = [], []
    old_term = signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    rc, why, reader = 0, "", None
    try:
        for r in range(chips):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(chips), LOCAL_RANK=str(r))
            procs.append(subprocess.Popen(
                args, env=env, cwd=ROOT, start_new_session=True, text=True,
                stdout=subprocess.PIPE if r == 0 else sys.stderr.fileno()))
        log(f"launcher: {chips} ranks started at {time.perf_counter() - t_start:.2f} s")
        reader = threading.Thread(target=_read_rank0, args=(procs[0].stdout, found), daemon=True)
        reader.start()
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                why = f"rank {bad[0][0]} exited with code {bad[0][1]}"
                rc = bad[0][1] if bad[0][1] > 0 else 1
                break
            if all(c == 0 for c in codes):
                break
            if time.perf_counter() > deadline:
                why = f"the ranks passed the launcher's limit of {deadline - t_start:.0f} s"
                rc = 1
                break
            time.sleep(0.05)
    finally:
        _kill(procs)
        if reader is not None:
            reader.join(timeout=10)
        signal.signal(signal.SIGTERM, old_term)
    pids = [p.pid for p in procs]
    if not why and not found:
        rc, why = 1, "rank 0 wrote no result"
    if why:
        return Launch(rc, None, [], why, pids)
    out = json.loads(found[-1])
    return Launch(0, out["result"], out["lines"], "", pids)
