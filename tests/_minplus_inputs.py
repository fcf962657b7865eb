"""Inputs of the min-plus kernel sweeps (numpy only, no JAX): the same
random ELL tiles as tests/test_kernels.py."""

import numpy as np


def ell_inputs(R, K, N, seed):
    """(nbr, wgt, dist, lab) as numpy: ids int32, weights and distances f32
    with a share of +inf padding lanes and unreached vertices."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, N, (R, K)).astype(np.int32)
    wgt = np.asarray(rng.uniform(1, 10, (R, K)), np.float32)
    wgt[rng.random((R, K)) < 0.25] = np.inf
    dist = np.where(rng.random(N) < 0.5, rng.uniform(0, 50, N), np.inf).astype(np.float32)
    lab = rng.integers(0, 7, N).astype(np.int32)
    return nbr, wgt, dist, lab
