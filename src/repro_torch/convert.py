"""Turns the JAX package's arrays, given as numpy, into this package's objects.

The data takes the place of weights in this system: these functions let the
two packages compute on the same graph, ELL view and Voronoi state.  Pass
``np.asarray(x)`` of the JAX arrays; nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import EllGraph, Graph
from repro_torch.core.voronoi import VoronoiState


def _t(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=dtype), device=device)  # a copy


def graph_from_numpy(src, dst, w, n: int, *, device="cuda") -> Graph:
    """A padded COO :class:`Graph` (as stored, no symmetrizing or padding)."""
    return Graph(
        src=_t(src, np.int32, device),
        dst=_t(dst, np.int32, device),
        w=_t(w, np.float32, device),
        n=int(n),
    )


def ell_from_numpy(nbr, wgt, row2v, n: int, *, device="cuda") -> EllGraph:
    """An :class:`EllGraph` from (R, K) nbr/wgt and (R,) row2v arrays."""
    return EllGraph(
        nbr=_t(nbr, np.int32, device),
        wgt=_t(wgt, np.float32, device),
        row2v=_t(row2v, np.int32, device),
        n=int(n),
    )


def state_from_numpy(dist, lab, pred, *, device="cuda") -> VoronoiState:
    """A :class:`VoronoiState` from (N,) dist/lab/pred arrays."""
    return VoronoiState(
        dist=_t(dist, np.float32, device),
        lab=_t(lab, np.int32, device),
        pred=_t(pred, np.int32, device),
    )
