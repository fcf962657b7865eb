"""Sharded train steps of ``repro_torch`` on gloo ranks, against the
port's one-device step and the reference's sharded step.

For each family (the reduced starcoder2 and granite-moe in f32, tensor-
parallel over "model"; a starcoder2 with 3 query heads, which split over
no "model" axis, so each rank attends from its block of query positions;
granite-moe with ``grad_accum=2``, whose microbatches, the reference's
global rows, decide the tokens its MoE layers drop; deepseek-v3's reduced
MLA + MoE with the 8-bit AdamW, its payloads split over the mesh where
their block count divides and replicated where not; GraphSAGE full graph,
GatedGCN at a hidden width of 18 so that its node tensors take
``make_specs``' replicated fallback, SchNet on a graph and on a molecule
batch, GraphCast with 17 mesh nodes split over no dp axis, MIND; and a
starcoder2 whose FFN stacks are split over their layer dim, held against
the one-device step only, see ``REF_FAMILIES``) and each mesh ((2, 2) with
``dp_axes=("data",)``, (2, 2, 2) with ``("pod", "data")``): parameters
placed by ``param_specs``, AdamW moments by ``opt_state_specs``, the batch
by ``input_specs``, then two steps of ``make_train_step(..., dp_axes,
param_shardings=...)``.  The ranks are processes of their own
(tests/_torch_sharded_prog.py) that meet through a FileStore; the
reference runs ``jax.jit`` of its own step on 8 forced host devices in
subprocesses, one for each mesh and half of the families
(tests/_torch_sharded_ref_prog.py).  Every process is joined
with a time limit, so a hung rank fails its test.

Tolerances (``|got - want| <= atol + rtol·|want|``), those of
tests/test_torch_lm.py, test_torch_gnn.py and test_torch_recsys.py:
  * the first loss rtol 1e-6 (LM) or 1e-5 (GNN, MIND); the second rtol
    1e-3 (an Adam step moves a weight with a near-zero gradient by ±lr on
    its sign, so the second step starts from slightly different weights);
  * gradients, read as the first moment m = (1 - b1)·g after the first
    step: rtol 1e-5 with atol 2e-4·max|m| of the leaf (MIND: of the whole
    tree, as test_torch_recsys.py holds its near-zero ``label_att``); an
    8-bit moment (read back to f32) atol 1e-2·max|m| of the leaf: it is
    its block's absmax / 127 times an int8, and a gradient a hair from a
    rounding tie lands one step (1/127 of the max) away;
  * parameters: after the first step (a sign step, m̂/√v̂ = ±1) all but
    0.1 % of the tree's elements within rtol 1e-5 with atol 1e-5·max|want|
    of the leaf; after two steps every element within 2·lr a step (the
    sign flip above) plus rtol 1e-5, and all but 5 % of the tree's
    elements within the same tight bound (the second step divides by
    √v̂ of two gradients, so a small difference in a small gradient moves
    its weight by a fraction of lr: up to ~1.3 % of the elements of the
    reduced starcoder2 on (2, 2, 2)).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per test worker)
from _torch_sharded_cases import FAMILIES, MESHES, REF_FAMILIES, check_records, port_run

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.abspath(os.path.join(_DIR, "..", "src"))
LIMIT_S = 360
CASES = [(m, f) for m in MESHES for f in FAMILIES]
REF_CASES = [(m, f) for m in MESHES for f in REF_FAMILIES]


def _env(**extra):
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.pathsep.join([_SRC, _DIR, env.get("PYTHONPATH", "")])
    return env


def _join(procs, what):
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
        logs = "\n".join(p.stdout.read()[-4000:] for p in bad)
        pytest.fail(f"{what}: {len(bad)} process(es) failed or hung\n{logs}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's 4- and 8-rank worlds and the reference's two meshes, side
    by side; returns the directory of their .npz records."""
    out = tmp_path_factory.mktemp("sharded_steps")
    spawn = dict(stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    refs = [subprocess.Popen(
        [sys.executable, os.path.join(_DIR, "_torch_sharded_ref_prog.py"), str(out), m, group],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu"),
        **spawn) for m in MESHES for group in ("lm", "models")]
    ranks = []
    for world in (4, 8):
        store = out / f"store{world}"
        ranks += [subprocess.Popen(
            [sys.executable, os.path.join(_DIR, "_torch_sharded_prog.py"), str(r), str(world),
             str(store), str(out)], env=_env(OMP_NUM_THREADS="1"), **spawn)
            for r in range(world)]
    _join(ranks, "the port's gloo ranks")
    _join(refs, "the reference's 8-device programs")
    return out


@pytest.fixture(scope="module")
def one_device():
    return {f: port_run(f) for f in FAMILIES}


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("mesh,family", CASES)
def test_sharded_step_matches_one_device(runs, one_device, mesh, family):
    check_records(_load(runs / f"{family}.{mesh}.port.npz"), one_device[family], family)


@pytest.mark.parametrize("mesh,family", REF_CASES)
def test_sharded_step_matches_reference(runs, mesh, family):
    check_records(_load(runs / f"{family}.{mesh}.port.npz"), _load(runs / f"{family}.{mesh}.ref.npz"),
           family)


def test_one_device_step_takes_plain_tensors(one_device):
    """Outside a mesh every constraint is a no-op: the one-device record
    holds both losses and a falling loss for every family."""
    for fam, rec in one_device.items():
        assert np.isfinite(rec["loss0"]) and np.isfinite(rec["loss1"]), fam
        assert rec["loss1"] < rec["loss0"], fam
    assert torch.get_num_threads() == 1
