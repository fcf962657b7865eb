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


def lane_inputs(R, K, N, B, seed):
    """ell_inputs with B lanes of dist/lab, lane b drawn from seed + 1 + b
    (B = None: one (N,) query)."""
    nbr, wgt, dist, lab = ell_inputs(R, K, N, seed=seed)
    if B is None:
        return nbr, wgt, dist, lab
    lanes = [ell_inputs(R, K, N, seed=seed + 1 + b)[2:] for b in range(B)]
    return nbr, wgt, np.stack([d for d, _ in lanes]), np.stack([lb for _, lb in lanes])


def tie_inputs(R, K, N, seed, B=None):
    """Tie-heavy (nbr, wgt, dist, lab): integer weights 1..3, integer
    distances and labels 0..2 (a share of the distances +inf, a share of
    the weights +inf padding), so equal candidates abound and most minima
    are decided on the label or the neighbor id.  ``B`` adds a lane axis
    to dist and lab."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, N, (R, K)).astype(np.int32)
    wgt = rng.integers(1, 4, (R, K)).astype(np.float32)
    wgt[rng.random((R, K)) < 0.25] = np.inf
    shape = (N,) if B is None else (B, N)
    dist = rng.integers(0, 3, shape).astype(np.float32)
    dist[rng.random(shape) < 0.2] = np.inf
    lab = rng.integers(0, 3, shape).astype(np.int32)
    return nbr, wgt, dist, lab
