"""A cell over several ranks (``perfkit.ranks``), on the CPU: four gloo
ranks through the launcher and the SPMD run at a small size read correct
with every number 0; faults planted from here (a hook file each rank loads
before its run) fail the check; a rank that raises, hangs or loads JAX
ends the run with no result, within the launcher's limit and with no
process left behind.  A card is never looked for: the ranks run on the
CPU, as the port's own gloo tests run its mesh backends."""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from perfkit import manifest, ranks  # noqa: E402

CELL = "kg-mesh1d-4chip"
CHIPS = 4
SMALL = {"config": {"graph": {"scale": 9}},
         "traffic": {"sizes": {"dist": "fixed", "value": 64}, "check": {"sample": 4, "pool": 6}}}
LIMIT_S = 90  # each launch's own limit, from its start


@pytest.fixture(autouse=True)
def time_limit():
    """Each test's own limit: an alarm that raises in the test."""

    def expire(*_):
        raise TimeoutError("the test passed its time limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S + 60)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def launch(tmp_path, hook="", trace=False, limit=LIMIT_S, seed=3000000001):
    path = None
    if hook:
        path = tmp_path / "hook.py"
        path.write_text(hook)
    t0 = time.perf_counter()
    run = ranks.launch(CELL, seed, 0.6, trace, CHIPS, device="cpu", overrides=SMALL,
                       hook=None if path is None else str(path), limit=limit)
    run.seconds = time.perf_counter() - t0
    for pid in run.pids:  # every rank reaped, and nothing left in its group
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
        with pytest.raises(ProcessLookupError):
            os.killpg(pid, 0)
    return run


@pytest.mark.parametrize("trace", [False, True])
def test_four_gloo_ranks_are_correct(tmp_path, trace):
    run = launch(tmp_path, trace=trace)
    assert run.rc == 0, run.why
    res = run.result
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["count"] == CHIPS
    assert set(res["checks"]) == {"state_mismatch", "tree_mismatch", "total_gap"}
    assert all(c["value"] == 0 for c in res["checks"].values()), res["checks"]
    assert list(res)[-1] == "checks" and run.lines[-1].startswith("check total_gap 0")
    names = {m["name"] for m in manifest.cell_metrics(manifest.load_manifest(), CELL, trace)}
    if trace:  # what a CPU run can read: the program's counters, no device trace
        assert set(res["metrics"]) == {"rounds.mesh", "messages.mesh"} < names
        assert res["metrics"]["rounds.mesh"]["value"] > 1
    else:
        assert set(res["metrics"]) == names == {"setup_s", "solve_ms"}


UNCHANGED_STEP = """
def plant(rank):
    if rank == 1:  # this rank's relaxation returns its block unchanged
        from repro_torch.core import dist_steiner
        dist_steiner.lex_update = lambda cand, lab, src, seg, st, active=None: (st, None)
"""

NO_EXCHANGE = """
def plant(rank):
    # the MIN passes between ranks left out: over the replicas and on the pair table
    from repro_torch.core import dist_steiner
    dist_steiner.lex_pmin = lambda d, l, p, group, chunks=1: (d, l, p)
"""

ALTERED_ANSWER = """
import dataclasses

def plant(rank):
    if rank == 0:  # the answer altered where it is produced
        from repro_torch.core import dist_steiner
        orig = dist_steiner.result_from_device

        def altered(out, n):
            res = orig(out, n)
            return dataclasses.replace(res, total_distance=res.total_distance + 1)

        dist_steiner.result_from_device = altered
"""


@pytest.mark.parametrize("hook", [UNCHANGED_STEP, NO_EXCHANGE, ALTERED_ANSWER],
                         ids=["unchanged_step", "no_exchange", "altered_answer"])
def test_planted_fault_is_not_correct(tmp_path, hook):
    run = launch(tmp_path, hook)
    assert run.rc == 0, run.why
    assert not run.result["correct"], run.result["checks"]


RAISES = """
def plant(rank):
    if rank == 2:
        raise RuntimeError("rank 2 fails")
"""

HANGS = """
import time

def plant(rank):
    if rank == 3:
        time.sleep(3600)
"""

LOADS_JAX = """
import sys, types

def plant(rank):
    if rank == 2:
        sys.modules["jax"] = types.ModuleType("jax")
"""


def test_a_rank_that_raises_ends_the_run(tmp_path):
    run = launch(tmp_path, RAISES)
    assert run.rc != 0 and run.result is None and "rank 2" in run.why
    assert run.seconds < LIMIT_S / 2


def test_a_rank_that_hangs_ends_at_the_limit(tmp_path):
    run = launch(tmp_path, HANGS, limit=25)
    assert run.rc != 0 and run.result is None and "limit" in run.why
    assert 25 <= run.seconds < 40


def test_a_rank_that_loads_jax_gives_no_result(tmp_path):
    run = launch(tmp_path, LOADS_JAX)
    assert run.rc != 0 and run.result is None and "rank 2 exited with code 3" in run.why


def test_every_cell_meshes_its_chips():
    man = manifest.load_manifest()
    for w in man["workloads"]:
        assert ranks.mesh_size(manifest.config(man, w["config"])) == w["chips"], w["name"]


def test_no_result_without_four_cards():
    """This machine has no CUDA device: the four-card cell gives no result
    and a code other than 0."""
    import torch

    if torch.cuda.is_available() and torch.cuda.device_count() >= CHIPS:
        pytest.skip("this machine has four CUDA devices")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", CELL, "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 4 CUDA device(s)" in out.stderr
