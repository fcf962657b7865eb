"""``repro_torch.launch.roofline``: the collective and HBM byte counter on a
fake world, against the byte counts of the reference's HLO parser test
(tests/test_dryrun.py::test_roofline_collective_parser), and the roofline
arithmetic on hand numbers.

The counter runs in a process of its own (tests/_torch_dryrun_prog.py
coll): a fake process group must be the process's only world."""

import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import roofline as rl

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.abspath(os.path.join(_DIR, "..", "src"))
LIMIT_S = 300


def run_prog(*args, limit=LIMIT_S):
    """tests/_torch_dryrun_prog.py ARGS in a process of its own → its JSON
    line (the process's stderr tail on failure)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([_SRC, _DIR, env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, os.path.join(_DIR, "_torch_dryrun_prog.py"), *args],
                          env=env, capture_output=True, text=True, timeout=limit)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert proc.returncode == 0 and lines, proc.stderr[-4000:]
    return json.loads(lines[-1])


@pytest.fixture(scope="module")
def counted():
    return run_prog("coll")


def test_collective_bytes_match_the_reference_parser(counted):
    """The reference's snippet: bf16[16,1024] all-gather, f32[256] all-reduce
    (ring factor 2), f32[64] reduce-scatter, u8[128] to all; no wait."""
    f = counted["functional"]
    assert f["coll"] == {"all-gather": 16 * 1024 * 2, "all-reduce": 256 * 4 * 2,
                         "reduce-scatter": 64 * 4, "all-to-all": 128,
                         "collective-permute": 0}
    g = f["groups"]["0-3/4"]
    assert (g["ranks"], g["link"], g["bytes"]) == (4, "nvlink", 16 * 1024 * 2 + 2048 + 256 + 128)
    assert f["by_link"] == {"nvlink": g["bytes"], "ib": 0}


def test_inplace_collectives_are_counted_by_group(counted):
    """dist.all_reduce and the gather into a tensor (what core/mesh.py
    issues) over ranks {0, 8}, two nodes: InfiniBand."""
    f = counted["inplace"]
    assert f["coll"]["all-reduce"] == 256 * 4 * 2
    assert f["coll"]["all-gather"] == 512 * 4
    assert f["groups"] == {"0-8/2": {"ranks": 2, "link": "ib", "bytes": 4096,
                                     "all-gather": 2048, "all-reduce": 2048,
                                     "reduce-scatter": 0, "all-to-all": 0,
                                     "collective-permute": 0}}
    assert f["by_link"] == {"nvlink": 0, "ib": 4096}


def test_hbm_bytes_are_each_ops_inputs_and_outputs(counted):
    assert counted["hbm"] == {"add": 3 * 256 * 4, "view": 0, "matmul": (128 + 64 + 32) * 4}


def test_link_of_a_group():
    assert rl.link_of(range(8)) == "nvlink"
    assert rl.link_of([8, 15]) == "nvlink"
    assert rl.link_of(range(16)) == "ib"
    assert rl.link_of([0, 16, 32]) == "ib"


def test_analyze_terms_on_hand_numbers():
    coll = {"all-gather": 50e9, "all-reduce": 450e9, "reduce-scatter": 0.0,
            "all-to-all": 0.0, "collective-permute": 0.0}
    r = rl.analyze_terms(989e12, 3.35e12 * 2, coll, model_flops_total=256 * 494.5e12,
                         n_chips=256, by_link={"nvlink": 450e9, "ib": 50e9 * 3})
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 2.0, 4.0)
    assert r.dominant == "collective" and r.bytes_wire == 500e9
    assert r.model_flops_per_chip == 494.5e12 and r.useful_ratio == 0.5
    f32 = rl.analyze_terms(66.9e12 * 3, 0.0, dict.fromkeys(coll, 0.0), dtype="f32")
    assert f32.t_compute == 3.0 and f32.dominant == "compute" and f32.useful_ratio is None
    # no link split: every wire byte over InfiniBand, the slowest link
    assert rl.analyze_terms(0.0, 0.0, coll).t_collective == 500e9 / 50e9
    row = r.row()
    for k in ("flops", "bytes_hbm", "bytes_wire", "t_compute_s", "t_memory_s",
              "t_collective_s", "dominant", "model_flops_per_chip", "useful_ratio",
              "coll_all-gather", "coll_all-reduce", "coll_reduce-scatter", "coll_all-to-all",
              "coll_collective-permute", "wire_nvlink", "wire_ib", "compute_dtype"):
        assert k in row, k


def test_memory_report_against_the_card():
    m = rl.memory_report(84.9e9, 10e9)
    assert m["fits_80gb"] and m["peak_gb"] == 84.9 and m["card_gb"] == 85.0
    assert m["state_gb"] == 10.0 and abs(m["work_gb"] - 74.9) < 1e-9
    assert not rl.memory_report(85.0e9, 0)["fits_80gb"]
