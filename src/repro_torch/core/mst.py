"""Minimum spanning tree of the distance graph G'1 (paper Alg. 2 Step 3).

:func:`prim_dense` is Prim's algorithm over the dense (S, S) pair matrix,
one vectorised step a vertex, as in ``repro.core.mst``.  It returns a parent
array over seed indices with ``parent[root] == root``.

Not ported yet: ``boruvka_dense`` and ``_root_parents`` (see ROADMAP.md).
"""

from __future__ import annotations

import torch

INF = float("inf")


def prim_dense(wmat: torch.Tensor) -> torch.Tensor:
    """Prim's MST over a dense (S, S) weight matrix (+inf = non-edge).

    Returns parent: (S,) int32, parent[0] == 0 (root).  Vertices in other
    components keep ``parent[v] == v``.  The S - 1 steps never sync with
    the host: the picked vertex stays a device tensor.
    """
    S = wmat.shape[0]
    dev = wmat.device
    in_tree = torch.zeros(S, dtype=torch.bool, device=dev)
    in_tree[0] = True
    best = wmat[0].clone()
    best_from = torch.zeros(S, dtype=torch.int32, device=dev)
    parent = torch.arange(S, dtype=torch.int32, device=dev)
    for _ in range(S - 1):
        # next vertex: lexicographic (weight, id) argmin outside the tree;
        # torch.argmin returns the first minimum, like jnp.argmin
        masked = torch.where(in_tree, INF, best)
        # a (1,) index, not a 0-d one: torch reads a 0-d index on the host
        v = torch.argmin(masked).view(1)
        ok = torch.isfinite(masked[v])
        parent[v] = torch.where(ok, best_from[v], parent[v])
        in_tree[v] = in_tree[v] | ok
        row = wmat[v][0]
        better = ok & (row < best) & ~in_tree
        best = torch.where(better, row, best)
        best_from = torch.where(better, v.to(torch.int32), best_from)
    return parent


def mst_pairs(parent: torch.Tensor, S: int) -> torch.Tensor:
    """Flat pair keys of the MST edges; S*S sentinel for the root row."""
    child = torch.arange(S, dtype=torch.int32, device=parent.device)
    key = torch.minimum(parent, child) * S + torch.maximum(parent, child)
    return torch.where(parent == child, S * S, key)
