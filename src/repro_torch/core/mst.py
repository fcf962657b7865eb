"""Minimum spanning tree of the distance graph G'1 (paper Alg. 2 Step 3).

:func:`prim_dense` is Prim's algorithm over the dense (S, S) pair matrix:
on the card one kernel launch for every step, on the CPU one vectorised
step a vertex; :func:`boruvka_dense` is Borůvka's, O(log S)
rounds of component minima and pointer jumping, as in ``repro.core.mst``.
Both return a parent array over seed indices with ``parent[root] == root``.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.graph import segment_min
from repro_torch.kernels.mst.prim import prim_call

INF = float("inf")
IMAX = torch.iinfo(torch.int32).max


def prim_dense(wmat: torch.Tensor) -> torch.Tensor:
    """Prim's MST over a dense (S, S) weight matrix (+inf = non-edge).

    Returns parent: (S,) int32, parent[0] == 0 (root).  Vertices in other
    components keep ``parent[v] == v``.  A CUDA tensor launches the kernel
    (:func:`~repro_torch.kernels.mst.prim.prim_call`: all S - 1 steps in one
    launch) or raises; a CPU tensor runs :func:`prim_loop`, the kernel's
    plain version.  Neither syncs with the host.
    """
    if wmat.device.type != "cpu":
        return prim_call(wmat)
    return prim_loop(wmat)


def prim_loop(wmat: torch.Tensor) -> torch.Tensor:
    """Prim's MST as S - 1 vectorised steps, on any device: the plain
    version of the kernel, equal to it bit for bit.

    The steps never sync with the host: the picked vertex stays a device
    tensor.
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


def boruvka_dense(wmat: torch.Tensor) -> torch.Tensor:
    """Borůvka's MST over a dense (S, S) matrix: O(log S) rounds.

    Deterministic through one strict order on undirected edges, (weight,
    min(u, v), max(u, v)): the simultaneous per-component picks then all
    belong to the unique MST under that order, so no round picks an unsafe
    edge.  Returns the same parent-array encoding as :func:`prim_dense`
    (the chosen adjacency folded into a parent array rooted at 0).  The
    reference's two data-dependent loops (rounds, capped at 2S + 2, and
    pointer jumping) are host loops here, one sync a test.
    """
    S = wmat.shape[0]
    dev = wmat.device
    ids = torch.arange(S, dtype=torch.int32, device=dev)
    lo_m = torch.minimum(ids[:, None], ids[None, :])  # min(u, v) per entry
    hi_m = torch.maximum(ids[:, None], ids[None, :])
    comp = ids
    chosen = torch.zeros((S, S), dtype=torch.bool, device=dev)
    rounds = 0
    while rounds < 2 * S + 2:
        # mask intra-component entries; stop once no inter-component edge
        w = torch.where(comp[:, None] == comp[None, :], INF, wmat)
        obs.host_read()
        if not bool(torch.isfinite(w).any()):
            break
        seg = comp.long()
        # per-component min weight; empty segments keep the fill (+inf)
        cmin = segment_min(w.amin(dim=1), seg, S, INF)
        valid = torch.isfinite(cmin)
        # among entries achieving cmin: min canonical (lo, hi), two passes
        e0 = w == cmin[seg][:, None]
        clo = segment_min(torch.where(e0, lo_m, S).amin(dim=1), seg, S, IMAX)
        e1 = e0 & (lo_m == clo[seg][:, None])
        chi = segment_min(torch.where(e1, hi_m, S).amin(dim=1), seg, S, IMAX)
        u = torch.where(valid, clo, 0).long()  # chosen undirected edge {u, v}
        v = torch.where(valid, chi, 0).long()
        # record the valid components' picks only (an index_put_ with
        # duplicate indices and different values would not be deterministic)
        chosen[u[valid], v[valid]] = True
        chosen[v[valid], u[valid]] = True
        obs.host_read(4)  # the four masked gathers
        # hook: component root c adopts the component of the FOREIGN endpoint
        outside = torch.where(comp[u] == ids, v, u)
        tgt = torch.where(valid, comp[outside], ids)
        # break mutual (2-cycle) hooks: the smaller id becomes the root
        # (with a strict total order on edges these are the only cycles)
        mutual = (tgt[tgt.long()] == ids) & (tgt != ids)
        tgt = torch.where(mutual & (ids < tgt), ids, tgt)
        # pointer jumping to the chain root (acyclic after 2-cycle removal)
        while True:
            obs.host_read()
            if not bool((tgt != tgt[tgt.long()]).any()):
                break
            tgt = tgt[tgt.long()]
        comp = tgt[seg]
        # canonical representative = min member id of the merged component
        comp = segment_min(ids, comp.long(), S, IMAX)[comp.long()]
        rounds += 1
    return _root_parents(chosen)


def _root_parents(adj: torch.Tensor) -> torch.Tensor:
    """Folds a tree adjacency matrix into a parent array rooted at 0.

    BFS by repeated frontier expansion (at most S rounds, one host sync a
    round): a vertex adjacent to the visited set adopts its smallest
    visited neighbor as parent.
    """
    S = adj.shape[0]
    dev = adj.device
    parent = torch.arange(S, dtype=torch.int32, device=dev)
    visited = torch.zeros(S, dtype=torch.bool, device=dev)
    visited[0] = True
    while True:
        nbr_vis = adj & visited[None, :]
        has = nbr_vis.any(dim=1) & ~visited
        obs.host_read()
        if not bool(has.any()):
            return parent
        # torch.argmax rejects bool and, like jnp.argmax, returns the first
        # maximum
        first = torch.argmax(nbr_vis.to(torch.uint8), dim=1).to(torch.int32)
        parent = torch.where(has, first, parent)
        visited = visited | has


def mst_pairs(parent: torch.Tensor, S: int) -> torch.Tensor:
    """Flat pair keys of the MST edges; S*S sentinel for the root row."""
    child = torch.arange(S, dtype=torch.int32, device=parent.device)
    key = torch.minimum(parent, child) * S + torch.maximum(parent, child)
    return torch.where(parent == child, S * S, key)
