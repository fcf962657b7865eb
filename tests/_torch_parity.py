"""Shared inputs for the parity tests of ``repro_torch`` against ``repro``.

Inputs are made with numpy from a seed and handed to both packages; results
come back as numpy for comparison.  JAX stays on the CPU (JAX_PLATFORMS=cpu)
and the port runs with ``device="cpu"``, its plain PyTorch path.
"""

from __future__ import annotations

import numpy as np
import torch

import repro.core.graph as jgraph
from repro.data.graphs import er_edges, grid_edges, rmat_edges
from repro_torch.core import graph as tgraph

# Many xdist workers share the machine's cores; torch's intra-op threads
# would oversubscribe them and slow small ops by orders of magnitude.
torch.set_num_threads(1)


def instance(trial: int, n_seeds: int = 5):
    """A small graph and seed set: ER, RMAT or grid by ``trial % 3``."""
    kind = trial % 3
    if kind == 0:
        src, dst, w, n = er_edges(30 + 2 * trial, 0.12, max_weight=9, seed=trial)
    elif kind == 1:
        src, dst, w, n = rmat_edges(6, 6, max_weight=20, seed=trial)
    else:
        src, dst, w, n = grid_edges(6, 7, max_weight=8, seed=trial)
    rng = np.random.default_rng(1000 + trial)
    seeds = rng.choice(n, size=min(n_seeds, n), replace=False).astype(np.int32)
    return src, dst, w, n, seeds


def both_graphs(src, dst, w, n, pad_to=8):
    """The same edge list as a JAX Graph and as a port Graph on the CPU."""
    return (
        jgraph.from_edges(src, dst, w, n, pad_to=pad_to),
        tgraph.from_edges(src, dst, w, n, pad_to=pad_to, device="cpu"),
    )


def host(x) -> np.ndarray:
    """A JAX array or a torch tensor as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def assert_same(a, b):
    """Bit-equal arrays (NaN-free; +inf equals +inf)."""
    a, b = host(a), host(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)
