"""The port's int8 gradient compression against the reference's.

``compress_tree`` bit for bit on the CPU (the int8 payload, the block
scales and the error residuals) on trees of f32 and bf16 leaves whose
sizes are and are not multiples of QBLOCK = 256; the reference's
error-feedback test (tests/test_substrate.py) ported; ``compressed_psum``
on 2 and 4 gloo ranks (processes meeting through a FileStore,
tests/_torch_compress_prog.py) against the reference's under ``shard_map``
over 2 and 4 forced host devices, run op by op (``jax.disable_jit``: under
``jit`` XLA computes the residual ``g32 - q·s/127`` as one FMA with the
reciprocal of 127, one rounding away from the reference's own expression,
which the port keeps): exact on 2 ranks (a sum of two values does not
depend on order) and within rtol 1e-6 of the mean's magnitude on 4, where
the order of the f32 sum may differ; the new error residuals are local,
and exact on both.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per test worker)
from repro.distributed import compression as jc
from repro_torch.distributed import compression as tc

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.abspath(os.path.join(_DIR, "..", "src"))
LIMIT_S = 120
SIZES = [1, 255, 256, 257, 1000, 4099, (7, 300)]


def _tree(seed, dtype):
    r = np.random.default_rng(seed)
    g, e = {}, {}
    for i, n in enumerate(SIZES):
        shape = n if isinstance(n, tuple) else (n,)
        g[f"w{i}"] = (r.normal(size=shape) * r.uniform(0.01, 100)).astype(np.float32)
        e[f"w{i}"] = (r.normal(size=shape) * 1e-3).astype(np.float32)
    g["zero"] = np.zeros((300,), np.float32)
    e["zero"] = np.zeros((300,), np.float32)
    if dtype == "bfloat16":
        g = {k: v.astype(ml_dtypes.bfloat16) for k, v in g.items()}
    return g, e


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_compress_tree_is_bit_identical(seed, dtype):
    g, e = _tree(seed, dtype)
    jq, je = jc.compress_tree({k: jnp.asarray(v) for k, v in g.items()},
                              {k: jnp.asarray(v) for k, v in e.items()})
    tq, te = tc.compress_tree({k: _torch(v) for k, v in g.items()},
                              {k: _torch(v) for k, v in e.items()})
    assert sorted(tq) == sorted(jq)
    for k in jq:
        (q, s), (tq_, ts) = jq[k], tq[k]
        assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
        assert tq_.shape[1] == tc.QBLOCK == jc.QBLOCK
        np.testing.assert_array_equal(tq_.numpy(), np.asarray(q), err_msg=k)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(s), err_msg=k)
        np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]), err_msg=k)
        deq = tc._dequant(tq_, ts, tuple(g[k].shape), torch.float32)
        np.testing.assert_array_equal(
            deq.numpy(), np.asarray(jc._dequant(q, s, g[k].shape, jnp.float32)), err_msg=k)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6, 7, 8])
def test_group_mean_divides_like_pmean(n):
    """The compressed mean's division by the group size is a true f32
    division (``psum / n``, as ``jax.lax.pmean``), not a multiply by 1/n."""
    x = (np.random.default_rng(n).normal(size=100_003) * 1e3).astype(np.float32)
    got = tc.group_mean(torch.from_numpy(x), n)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), x / np.float32(n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.asarray(x) / jnp.float32(n)))
    if n in (3, 5, 6, 7):  # where the reciprocal is inexact, a multiply would differ
        assert np.any(x * np.float32(1 / n) != x / np.float32(n))


def test_round_half_to_even_like_the_reference():
    """A block whose scaled values fall on .5 exactly: both round to even."""
    x = np.zeros(256, np.float32)
    x[0] = 127.0
    x[1:6] = [0.5, 1.5, 2.5, -0.5, -2.5]
    jq, _ = jc.compress_tree({"x": jnp.asarray(x)}, {"x": jnp.zeros(256)})
    tq, _ = tc.compress_tree({"x": torch.from_numpy(x)}, {"x": torch.zeros(256)})
    np.testing.assert_array_equal(tq["x"][0].numpy(), np.asarray(jq["x"][0]))
    assert tq["x"][0].numpy().ravel()[1:6].tolist() == [0, 2, 2, 0, -2]


def test_compression_error_feedback_converges():
    """Mean of compressed grads over steps ≈ mean of true grads (the
    reference's test_substrate.py test, on the port)."""
    rng = np.random.default_rng(0)
    params = {"w": torch.zeros((300,), dtype=torch.float32)}
    err = tc.init_error(params)
    acc_true = np.zeros(300)
    acc_q = np.zeros(300)
    for _ in range(50):
        g = {"w": torch.from_numpy((rng.normal(size=300) * (1 + np.arange(300) / 50))
                                   .astype(np.float32))}
        qtree, err = tc.compress_tree(g, err)
        q, s = qtree["w"]
        deq = tc._dequant(q, s, (300,), torch.float32)
        acc_true += g["w"].numpy()
        acc_q += deq.numpy()
    # error feedback keeps the ACCUMULATED signal nearly unbiased
    denom = np.abs(acc_true).mean()
    assert np.abs(acc_q - acc_true).mean() < 0.02 * denom


def _env(**extra):
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.pathsep.join([_SRC, _DIR, env.get("PYTHONPATH", "")])
    return env


@pytest.fixture(scope="module")
def psum_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("psum")
    prog = os.path.join(_DIR, "_torch_compress_prog.py")
    spawn = dict(stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs = [subprocess.Popen([sys.executable, prog, "ref", str(out)],
                              env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                                       JAX_PLATFORMS="cpu"), **spawn)]
    for world in (2, 4):
        procs += [subprocess.Popen([sys.executable, prog, "port", str(r), str(world),
                                    str(out / f"store{world}"), str(out)],
                                   env=_env(OMP_NUM_THREADS="1"), **spawn)
                  for r in range(world)]
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
        pytest.fail("a process failed or hung:\n" + "\n".join(p.stdout.read()[-3000:]
                                                               for p in bad))
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_matches_the_reference_under_shard_map(psum_runs, world):
    with np.load(psum_runs / f"psum{world}.ref.npz") as z:
        want = {k: z[k] for k in z.files}
    for r in range(world):
        with np.load(psum_runs / f"psum{world}.rank{r}.npz") as z:
            got = {k: z[k] for k in z.files}
        assert sorted(got) == sorted(want)
        for k in want:
            w = want[k][r]
            if k.startswith("err.") or world == 2:
                np.testing.assert_array_equal(got[k], w, err_msg=f"rank {r} {k}")
            else:
                np.testing.assert_allclose(got[k], w, rtol=1e-6,
                                           atol=1e-6 * np.abs(w).max(), err_msg=f"rank {r} {k}")
        if r:  # every rank holds the same mean
            with np.load(psum_runs / f"psum{world}.rank0.npz") as z0:
                for k in (k for k in want if k.startswith("red.")):
                    np.testing.assert_array_equal(got[k], z0[k])
