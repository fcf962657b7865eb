"""Dense (S, S) float32 matrices for Prim (numpy only, no JAX): the tables
that the kernel and its plain loop are held equal on."""

import numpy as np

PRIM_KINDS = ("uniform", "ties", "components", "isolated_root")


def prim_table(S, kind, seed):
    """An (S, S) float32 matrix of ``kind``:

    uniform        weights in [0, 1), 30 % +inf, neither symmetric nor with
                   an infinite diagonal (any matrix the kernel takes);
    ties           integer weights 1..8, symmetric, +inf diagonal;
    components     as ties, but +inf between three random groups of
                   vertices, so Prim stops with several components left;
    isolated_root  as ties, but vertex 0 has no finite edge.
    """
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        m = rng.random((S, S), dtype=np.float32)
        m[rng.random((S, S), dtype=np.float32) < 0.3] = np.inf
        return m
    m = rng.integers(1, 9, (S, S), dtype=np.int8).astype(np.float32)
    m = np.minimum(m, m.T)
    np.fill_diagonal(m, np.inf)
    if kind == "components":
        group = rng.integers(0, 3, S)
        m[group[:, None] != group[None, :]] = np.inf
    elif kind == "isolated_root":
        m[0, :] = m[:, 0] = np.inf
    elif kind != "ties":
        raise ValueError(f"unknown kind {kind!r}")
    return m
