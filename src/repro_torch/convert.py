"""Turns the JAX package's arrays, given as numpy, into this package's objects.

The data takes the place of weights in this system: these functions let the
two packages compute on the same graph, ELL view and Voronoi state, and the
LM, GNN and MIND families on the same weights and optimizer state (with
their inverses, for comparisons).  Pass ``np.asarray(x)`` of the JAX arrays; nothing here
imports JAX.
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


# ---- the LM family: parameter and optimizer-state trees -------------------------


def tensor_from_numpy(a, *, device="cuda") -> torch.Tensor:
    """A numpy array as a tensor of the same dtype; bf16 (ml_dtypes, numpy
    kind 'V') travels as its 16 bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "V":
        if a.dtype.name != "bfloat16":
            raise TypeError(f"no torch dtype for {a.dtype}")
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 as f32 (exact), for comparisons."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _params_from_numpy(tree, defs, nest, device):
    """The leaves of ``tree`` named by ``defs`` ({dotted path: (shape,
    dtype)}), each checked against its entry, nested by ``nest``."""
    flat = {}
    for name, (shape, dtype) in defs.items():
        node = tree
        for part in name.split("."):
            node = node[part]
        t = tensor_from_numpy(node, device=device)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {t.dtype}{tuple(t.shape)}, the config wants "
                             f"{dtype}{shape}")
        flat[name] = t
    return nest(flat)


def lm_params_from_numpy(tree, cfg, *, device="cuda"):
    """The reference's LM parameter tree (``init_params``' nested dict, its
    leaves as numpy) as this package's, each leaf checked against
    ``param_defs(cfg)``."""
    from repro_torch.models.transformer import _nest, param_defs

    return _params_from_numpy(tree, param_defs(cfg), _nest, device)


def lm_params_to_numpy(params):
    """The inverse of :func:`lm_params_from_numpy` (bf16 leaves as f32)."""
    from repro_torch.tree import tree_map

    return tree_map(tensor_to_numpy, params)


def gnn_params_from_numpy(tree, cfg, d_feat: int, *, device="cuda"):
    """The reference's GNN parameter dict (``repro.models.gnn.init_params``'
    nested dict, leaves as numpy) as this package's, each leaf checked
    against ``param_defs(cfg, d_feat)``."""
    from repro_torch.models.gnn import _nest, param_defs

    return _params_from_numpy(tree, param_defs(cfg, d_feat), _nest, device)


def gnn_params_to_numpy(params):
    """The inverse of :func:`gnn_params_from_numpy`."""
    return lm_params_to_numpy(params)


def recsys_params_from_numpy(tree, cfg, *, device="cuda"):
    """The reference's MIND parameters (a flat dict, leaves as numpy) as
    this package's, each leaf checked against ``param_defs(cfg)``."""
    from repro_torch.models.recsys import param_defs

    return _params_from_numpy(tree, param_defs(cfg), dict, device)


def recsys_params_to_numpy(params):
    """The inverse of :func:`recsys_params_from_numpy`."""
    return lm_params_to_numpy(params)


def opt_state_from_numpy(state, *, device="cuda"):
    """The reference's AdamW state (``{"mu": ..., "count": ...}``, leaves as
    numpy; a ``Q8State``'s fields as numpy) as this package's."""
    from repro_torch.optim.adamw import Q8State
    from repro_torch.tree import tree_map

    def leaf(x):
        if hasattr(x, "scale"):
            return Q8State(q=tensor_from_numpy(x.q, device=device),
                           scale=tensor_from_numpy(x.scale, device=device),
                           shape=tuple(x.shape))
        return tensor_from_numpy(x, device=device)

    return tree_map(leaf, state)


def opt_state_to_numpy(state):
    """The inverse of :func:`opt_state_from_numpy`: numpy leaves, a
    ``Q8State`` with numpy fields."""
    from repro_torch.optim.adamw import Q8State
    from repro_torch.tree import tree_map

    def leaf(x):
        if isinstance(x, Q8State):
            return Q8State(q=tensor_to_numpy(x.q), scale=tensor_to_numpy(x.scale),
                           shape=x.shape)
        return tensor_to_numpy(x)

    return tree_map(leaf, state)
