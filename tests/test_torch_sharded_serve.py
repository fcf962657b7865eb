"""Sharded serving steps of ``repro_torch`` on gloo ranks, against the
port's one-device step and the reference's sharded step.

Cases (tests/_torch_sharded_cases.py ``SERVE_CASES``), each on the meshes
(2, 2) with ``dp_axes=("data",)`` and (2, 2, 2) with ``("pod", "data")``,
parameters placed by ``param_specs`` and inputs by ``input_specs``:
  * prefill of the reduced granite-moe in two ``batch_chunks`` (the
    reference's global rows, which fix the tokens an MoE layer drops);
  * four decode steps against caches placed by ``_cache_specs``: KV heads
    split over "model" (starcoder2 in f32 and in its bf16, qwen's int8),
    one KV head so head_dim splits (f32, and int8 with its scales split over
    the sequence), deepseek-v3's MLA latent split by columns; each step's
    logits and the caches after the last;
  * MIND's ``serve_p99``-style scores and ``retrieval_cand``-style scores.
The ranks are processes (tests/_torch_sharded_prog.py ``serve``); the
reference runs ``jax.jit`` of its steps on 8 forced host devices
(tests/_torch_sharded_ref_prog.py ``serve``).  Every process is joined with
a time limit.

Tolerances (``|got - want| <= atol + rtol·|want|``):
  * f32 logits and caches: test_torch_lm.py's LOGITS, rtol 1e-5 with atol
    5e-5·max|want| (sums over "model" in another order);
  * logits that read an int8 cache: atol 5e-3·max|want| (a key a hair
    apart may round to the next int8 step, 1/127 of its head's max, which
    moves a logit by up to ~1.4e-3·max here); the int8 payloads equal but
    ±1 on at most 0.1 % of entries, their bf16 scales within one bf16 step
    (rtol 2^-7);
  * the bf16 decode: rtol and atol 2e-2·max|want| (bf16 rounding of every
    activation, summed in another order);
  * MIND's scores: rtol 1e-5 with atol 1e-5·max|want|.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per test worker)
from _torch_sharded_cases import MESHES, SERVE_CASES, check_serve, port_serve
from test_torch_sharded_steps import _env, _join

_DIR = os.path.dirname(os.path.abspath(__file__))
CASES = [(m, c) for m in MESHES for c in SERVE_CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's 4- and 8-rank worlds and the reference's two meshes, side
    by side; returns the directory of their .npz records."""
    out = tmp_path_factory.mktemp("sharded_serve")
    spawn = dict(stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    refs = [subprocess.Popen(
        [sys.executable, os.path.join(_DIR, "_torch_sharded_ref_prog.py"), str(out), m, "serve"],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu"),
        **spawn) for m in MESHES]
    ranks = []
    for world in (4, 8):
        store = out / f"store{world}"
        ranks += [subprocess.Popen(
            [sys.executable, os.path.join(_DIR, "_torch_sharded_prog.py"), str(r), str(world),
             str(store), str(out), "serve"], env=_env(OMP_NUM_THREADS="1"), **spawn)
            for r in range(world)]
    _join(ranks, "the port's gloo ranks")
    _join(refs, "the reference's 8-device programs")
    return out


@pytest.fixture(scope="module")
def one_device():
    return {c: port_serve(c) for c in SERVE_CASES}


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("mesh,case", CASES)
def test_sharded_serving_matches_one_device(runs, one_device, mesh, case):
    check_serve(_load(runs / f"{case}.{mesh}.port.npz"), one_device[case], case)


@pytest.mark.parametrize("mesh,case", CASES)
def test_sharded_serving_matches_reference(runs, mesh, case):
    check_serve(_load(runs / f"{case}.{mesh}.port.npz"), _load(runs / f"{case}.{mesh}.ref.npz"),
                case)


def test_one_device_decode_fills_its_caches(one_device):
    """Four decode steps write positions 0-3 of every cache and nothing
    past them; the logits are finite."""
    for case, rec in one_device.items():
        for k, v in rec.items():
            assert np.isfinite(v).all(), (case, k)
            if k.startswith("c."):
                assert np.abs(v[:, :, :4]).max() > 0 and not v[:, :, 4:].any(), (case, k)
    assert torch.get_num_threads() == 1
