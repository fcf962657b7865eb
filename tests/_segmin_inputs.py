"""Inputs of the segment-min sweeps (numpy only, no JAX): the random
buckets of tests/test_kernels.py, and a tie-heavy variant."""

import numpy as np


def segmin_inputs(NB, EB, VB, seed, ties=False):
    """(cand, ldst, lab, src) as numpy: cand f32 with 30 % +inf lanes, ids
    int32.  ``ties`` draws integer candidates in [0, 4) and three labels,
    so most minima are decided on the second or third key."""
    rng = np.random.default_rng(seed)
    if ties:
        vals = rng.integers(0, 4, (NB, EB)).astype(np.float64)
        lab = rng.integers(0, 3, (NB, EB))
    else:
        vals = rng.uniform(0, 100, (NB, EB))
        lab = rng.integers(0, 9, (NB, EB))
    cand = np.where(rng.random((NB, EB)) < 0.7, vals, np.inf).astype(np.float32)
    ldst = rng.integers(0, VB, (NB, EB)).astype(np.int32)
    src = rng.integers(0, 10**6, (NB, EB)).astype(np.int32)
    return cand, ldst, lab.astype(np.int32), src
