"""The port's mesh backends on 4 and 8 gloo ranks against the reference on
8 forced host devices, bit for bit but for ``total_distance`` (an f32 sum,
held to abs 1e-4).

The ranks are processes of their own (tests/_torch_mesh_ranks_prog.py)
that meet through a FileStore under the test's temporary directory; the
reference runs in a subprocess with its own XLA_FLAGS
(tests/_torch_mesh_ref_prog.py), as tests/test_dist_steiner.py runs it.
Every process is joined with a time limit, so a hung rank fails its test.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_mesh_cases import CASES, FIELDS, SCALARS
from repro_torch.obs import flight

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.abspath(os.path.join(_DIR, "..", "src"))
LIMIT_S = 240


def _env(**extra):
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.pathsep.join([_SRC, _DIR, env.get("PYTHONPATH", "")])
    return env


def _join(procs, what):
    """Waits for every process (each within the limit); kills the rest and
    fails with their output when one fails or hangs."""
    try:
        for p in procs:
            p.wait(timeout=LIMIT_S)
    except subprocess.TimeoutExpired:
        pass
    bad = [p for p in procs if p.poll() is None or p.returncode != 0]
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    if bad:
        logs = "\n".join(p.stdout.read() for p in bad)
        pytest.fail(f"{what}: {len(bad)} process(es) failed or hung\n{logs}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Runs the reference's program and the port's 4- and 8-rank worlds
    side by side; returns the directory of their .npz files."""
    out = tmp_path_factory.mktemp("mesh_ranks")
    spawn = dict(stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ref = subprocess.Popen(
        [sys.executable, os.path.join(_DIR, "_torch_mesh_ref_prog.py"), str(out)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu"),
        **spawn)
    ranks = []
    for world in (4, 8):
        store = out / f"store{world}"
        ranks += [subprocess.Popen(
            [sys.executable, os.path.join(_DIR, "_torch_mesh_ranks_prog.py"), str(r),
             str(world), str(store), str(out)], env=_env(OMP_NUM_THREADS="1"), **spawn)
            for r in range(world)]
    _join(ranks, "the port's gloo ranks")
    _join([ref], "the reference's 8-device program")
    return out


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_match_reference(runs, name):
    world = CASES[name]["world"]
    want = _load(runs / f"{name}.ref.npz")
    got = [_load(runs / f"{name}.rank{r}.npz") for r in range(world)]
    for r, res in enumerate(got):
        assert sorted(res) == sorted(want), (r, sorted(res), sorted(want))
        assert abs(float(res["total_distance"]) - float(want["total_distance"])) <= 1e-4
        for f in FIELDS + SCALARS + ("history",):
            assert res[f].dtype == want[f].dtype, (r, f)
            np.testing.assert_array_equal(res[f], want[f], err_msg=f"rank {r} {f}")
        # every rank returns the same answer, bit for bit
        for f in FIELDS + ("total_distance",):
            np.testing.assert_array_equal(res[f], got[0][f])
    if CASES[name]["kw"].get("telemetry_per_rank"):
        per_rank = got[0]["per_rank"]
        assert per_rank.shape[1] == world
        np.testing.assert_array_equal(per_rank, want["per_rank"])
        rows = int(min(got[0]["iterations"], CASES[name]["kw"]["telemetry_rounds"]))
        flight.check_consistency(per_rank[:rows], got[0]["history"][:rows], label=name)
    else:
        assert "per_rank" not in want


def test_per_rank_buffers_feed_the_flight_report(runs):
    """The solver's trimmed per-rank rows: the reference's report renders
    the same from the port's buffer."""
    got = _load(runs / "mesh1d_2x4_frontier.rank3.npz")
    want = _load(runs / "mesh1d_2x4_frontier.ref.npz")
    np.testing.assert_array_equal(got["telemetry_per_rank"], want["telemetry_per_rank"])
    rep = flight.analyze(got["telemetry_per_rank"], label="mesh1d/frontier")
    assert rep.n_ranks == 8 and rep.rounds == got["telemetry_per_round"].shape[0]
    flight.check_consistency(got["telemetry_per_rank"], got["telemetry_per_round"])
    assert np.all(rep.imbalance >= 1.0 - 1e-12)
