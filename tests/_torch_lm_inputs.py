"""Shared inputs for the LM parity tests of ``repro_torch`` against ``repro``.

The reduced config of each LM architecture, in both packages; the
reference's parameters from its own ``init_params`` (a fixed PRNG key),
carried into the port through ``convert.lm_params_from_numpy``; token
batches made with numpy from a seed.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import torch

import _torch_parity  # noqa: F401  (one torch thread per test worker)
from repro.configs import get_arch as jget_arch
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_arch as tget_arch

LM_IDS = ("starcoder2-3b", "qwen1.5-32b", "stablelm-12b", "granite-moe-1b-a400m",
          "deepseek-v3-671b")


def configs(arch: str, dtype: str = "float32"):
    """(reference config, port config): the arch's reduced config in ``dtype``."""
    return (dataclasses.replace(jget_arch(arch).reduced, dtype=dtype),
            dataclasses.replace(tget_arch(arch).reduced, dtype=dtype))


@functools.lru_cache(maxsize=None)
def ref_params_numpy(arch: str, dtype: str = "float32", seed: int = 0):
    """The reference's ``init_params`` as a tree of numpy arrays."""
    jcfg, _ = configs(arch, dtype)
    init = jax.jit(jtf.init_params, static_argnums=0)
    return jax.tree.map(np.asarray, init(jcfg, jax.random.PRNGKey(seed)))


def both_params(arch: str, dtype: str = "float32", seed: int = 0):
    """(reference params as JAX arrays, the same weights in the port on the CPU)."""
    tree = ref_params_numpy(arch, dtype, seed)
    _, tcfg = configs(arch, dtype)
    return (jax.tree.map(jax.numpy.asarray, tree),
            convert.lm_params_from_numpy(tree, tcfg, device="cpu"))


def tokens(vocab: int, B: int, S: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def host(x) -> np.ndarray:
    """A JAX array or a torch tensor as f32/int numpy (bf16 exactly as f32)."""
    if isinstance(x, torch.Tensor):
        return convert.tensor_to_numpy(x)
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.kind == "V" else a


def assert_close(got, want, *, rtol: float, atol_frac: float, what: str = ""):
    """|got - want| <= atol_frac * max|want| + rtol * |want|, elementwise."""
    got, want = host(got), host(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * scale, err_msg=what)


def assert_tree_close(got, want, *, rtol: float, atol_frac: float, path: str = ""):
    """Two trees of the reference's layout (dicts; leaves as arrays or tensors)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_tree_close(got[k], want[k], rtol=rtol, atol_frac=atol_frac,
                              path=f"{path}/{k}")
    else:
        assert_close(got, want, rtol=rtol, atol_frac=atol_frac, what=path)
