"""Every family's sharded step on a fake world, at full width.

``torch.testing._internal.distributed.fake_pg`` gives a process group of
256 or 512 ranks whose collectives do nothing; under ``FakeTensorMode`` no
tensor holds data.  On rank 0 of each, with the production meshes
((16, 16) and (2, 16, 16)), tests/_torch_fake_world_prog.py runs one step
of each registry cell at full width and 2 layers (LM train with
grad_accum and deepseek-v3's 8-bit update, prefill with batch_chunks,
decode against sharded caches; the GNN train steps; MIND train, serve and
retrieval): a step that synced with the host or asked for a shape known
only from the data would raise there.  Each world is a process of its own.

Tensor parallelism: the LM train step's matmul FLOPs, counted by
``FlopCounterMode`` on the local tensors of each ``local_call`` piece, on a
fake (1, 16) world against a (1, 1) world.  Ideally 1/16: the KV
projections (deepseek-v3's latents) and the router run whole on each rank
of "model", so the bound held is 1/12.
"""

import json
import os
import subprocess
import sys

import pytest

import _torch_parity  # noqa: F401  (one torch thread per test worker)
from _torch_fake_world_prog import GNN_CELLS, LM_ARCHS, MIND_CELLS

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.abspath(os.path.join(_DIR, "..", "src"))
LIMIT_S = 600
FLOP_ARCHS = ("starcoder2-3b", "stablelm-12b", "deepseek-v3-671b")
RUNS = [("steps", "256"), ("steps", "512")] + [
    ("flops", w, a) for a in FLOP_ARCHS for w in ("1", "16")]


@pytest.fixture(scope="module")
def results():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([_SRC, _DIR, env.get("PYTHONPATH", "")])
    procs = {r: subprocess.Popen([sys.executable, os.path.join(_DIR, "_torch_fake_world_prog.py"),
                                  *r], env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for r in RUNS}
    out = {}
    for r, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=LIMIT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, stderr = p.communicate()
        lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
        out[r] = json.loads(lines[-1]) if p.returncode == 0 and lines else stderr[-4000:]
    return out


def _expected_cells():
    from repro_torch.configs import get_arch

    lm = [f"{a} x {s.name}" for a in LM_ARCHS for s in get_arch(a).shapes if s.applicable]
    return lm + [f"{a} x {c}" for a, c in GNN_CELLS] + [f"mind x {c}" for c in MIND_CELLS]


@pytest.mark.parametrize("world,mesh", [("256", [16, 16]), ("512", [2, 16, 16])])
def test_every_step_runs_on_a_fake_world(results, world, mesh):
    res = results[("steps", world)]
    assert isinstance(res, dict), res
    assert res["mesh"] == mesh
    cells = res["cells"]
    assert sorted(cells) == sorted(_expected_cells())
    for name, cell in cells.items():
        out = cell["out"]
        if " x train" in name or "gnn" in name or name.endswith(("ogb_products", "molecule",
                                                                 "full_graph_sm")):
            assert out == [[]], (name, out)  # a scalar loss
    assert cells["starcoder2-3b x prefill_32k"]["out"] == [[32, 49152]]
    assert cells["deepseek-v3-671b x decode_32k"]["out"] == [[128, 129280]]
    assert cells["mind x serve_bulk"]["out"] == [[262144, 256]]
    assert cells["mind x retrieval_cand"]["out"] == [[1000000]]


@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_lm_step_compute_is_tensor_parallel(results, arch):
    one, tp = results[("flops", "1", arch)], results[("flops", "16", arch)]
    assert isinstance(one, dict), one
    assert isinstance(tp, dict), tp
    assert tp["mesh"] == [1, 16] and one["mesh"] == [1, 1]
    assert 0 < tp["flops"] * 12 <= one["flops"], (arch, one["flops"] / tp["flops"])
