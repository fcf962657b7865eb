"""The plain reference of the Steiner configurations, in PyTorch and NumPy.

Mehlhorn's 2-approximation (the paper's Alg. 2), worked out again from the
edges and seeds the benchmark made, with the deterministic answer that the
configurations guarantee.  It imports nothing of ``repro_torch`` or
``repro`` and reads nothing the program made.

1. Voronoi cells.  A seed ``seeds[i]`` holds ``(0, i, seeds[i])`` (a vertex
   listed twice keeps its lowest index); every other vertex ``v`` holds the
   lexicographic least ``(dist[u] + w(u, v), lab[u], u)`` over its
   neighbours ``u``: its distance to the nearest seed, the least seed index
   among the nearest, and the least neighbour that gives both.  Worked out
   by synchronous Bellman-Ford rounds over one int64 key a vertex,
   ``dist | lab | pred`` in bit fields, until a round changes nothing.
2. Distance graph.  For each pair of cells a < b, the least
   ``dist[u] + w + dist[v]`` over the edges (u, v) with u in cell a and v
   in cell b, and of those the least (u, v).
3. MST.  Prim's from seed 0 over the dense pair matrix: next the first
   vertex of least weight outside the tree; a vertex's parent the tree
   vertex that first gave it its best weight.
4. Tree.  The bridge of each MST edge, and every vertex on the ``pred``
   chain from a bridge's ends to its seed; the total distance is the sum
   of the weights of those edges.

Weights are integers, so in ``float32`` (the configurations' precision)
every distance and total is exact below 2**24, which :func:`solve` checks.
``precision="bfloat16"`` rounds every sum to bfloat16 instead: the control
that a sound comparison has to fail.
"""

from __future__ import annotations

import numpy as np
import torch

INF_KEY = torch.iinfo(torch.int64).max
IMAX = torch.iinfo(torch.int32).max
F32_EXACT = 1 << 24


def _rounder(precision: str):
    if precision == "float32":
        return lambda x: x
    if precision == "bfloat16":
        return lambda x: x.to(torch.float32).to(torch.bfloat16).to(torch.float32).to(torch.int64)
    raise ValueError(f"unknown precision {precision!r}")


def voronoi(src, dst, w, n: int, seeds, precision: str = "float32"):
    """Voronoi cells of ``seeds`` over the directed edges (src, dst, w),
    int64 ids and int64 weights.  Returns (dist, lab, pred, rounds): dist
    int64 (-1 where unreached), lab int64 (``len(seeds)`` where unreached),
    pred int64 (the vertex itself for seeds and unreached)."""
    rnd = _rounder(precision)
    dev = src.device
    S = int(seeds.shape[0])
    pb = max(1, (n - 1).bit_length())
    lb = S.bit_length()
    db = 62 - pb - lb  # one spare bit, so an overflow shows before it wraps
    pmask = (1 << pb) - 1
    lmask = ((1 << (lb + pb)) - 1) ^ pmask
    key = torch.full((n,), INF_KEY, dtype=torch.int64, device=dev)
    idx = torch.arange(S, dtype=torch.int64, device=dev)
    key.scatter_reduce_(0, seeds, (idx << pb) | seeds, "amin")
    over = torch.zeros((), dtype=torch.bool, device=dev)
    rounds = 0
    while True:
        ks = key[src]
        fin = ks != INF_KEY
        d = rnd((ks >> (lb + pb)) + w)
        over |= (torch.where(fin, d, 0) >> db).any()
        cand = torch.where(fin, (d << (lb + pb)) | (ks & lmask) | src, INF_KEY)
        del ks, d, fin
        new = key.scatter_reduce(0, dst, cand, "amin", include_self=True)
        del cand
        rounds += 1
        if torch.equal(new, key):
            break
        key = new
    if bool(over):
        raise OverflowError(f"a distance passes the {db} bits of the key")
    reached = key != INF_KEY
    dist = torch.where(reached, key >> (lb + pb), -1)
    lab = torch.where(reached, (key & lmask) >> pb, S)
    pred = torch.where(reached, key & pmask, torch.arange(n, device=dev))
    return dist, lab, pred, rounds


def distance_graph(src, dst, w, dist, lab, n: int, S: int, precision: str = "float32"):
    """The pair tables over the cross-cell edges: (dmat, umat, vmat), each
    (S*S,) int64 at ``min(a, b) * S + max(a, b)``; -1 in dmat and IMAX in
    umat and vmat where no edge joins the two cells."""
    rnd = _rounder(precision)
    ls, ld = lab[src], lab[dst]
    cross = torch.nonzero((ls != ld) & (ls < S) & (ld < S)).squeeze(1)
    s, t, la, lt = src[cross], dst[cross], ls[cross], ld[cross]
    d = rnd(rnd(dist[s] + w[cross]) + dist[t])
    pair = torch.minimum(la, lt) * S + torch.maximum(la, lt)
    lower_first = la < lt
    u, v = torch.where(lower_first, s, t), torch.where(lower_first, t, s)
    dmin = torch.full((S * S,), INF_KEY, dtype=torch.int64, device=src.device)
    dmin.scatter_reduce_(0, pair, d, "amin")
    uv = torch.where(d == dmin[pair], u * n + v, INF_KEY)
    uvmin = torch.full((S * S,), INF_KEY, dtype=torch.int64, device=src.device)
    uvmin.scatter_reduce_(0, pair, uv, "amin")
    none = dmin == INF_KEY
    return (torch.where(none, -1, dmin), torch.where(none, IMAX, uvmin // n),
            torch.where(none, IMAX, uvmin % n))


def prim(dmat: np.ndarray, S: int) -> np.ndarray:
    """Prim's MST from seed 0 over the (S*S,) pair table (-1: no edge).
    Returns parent (S,) int64, ``parent[v] == v`` for the root and for
    vertices it cannot reach."""
    W = np.where(dmat < 0, np.inf, dmat.astype(np.float64)).reshape(S, S)
    W = np.minimum(W, W.T)
    np.fill_diagonal(W, np.inf)
    in_tree = np.zeros(S, bool)
    in_tree[0] = True
    best = W[0].copy()
    best_from = np.zeros(S, np.int64)
    parent = np.arange(S, dtype=np.int64)
    for _ in range(S - 1):
        masked = np.where(in_tree, np.inf, best)
        v = int(np.argmin(masked))
        if not np.isfinite(masked[v]):
            break
        parent[v] = best_from[v]
        in_tree[v] = True
        better = (W[v] < best) & ~in_tree
        best = np.where(better, W[v], best)
        best_from = np.where(better, v, best_from)
    return parent


def tree(dist: np.ndarray, pred: np.ndarray, dmat: np.ndarray, umat: np.ndarray,
         vmat: np.ndarray, parent: np.ndarray, S: int, precision: str = "float32") -> dict:
    """The Steiner tree of the MST ``parent`` (host arrays)."""
    rnd = _rounder(precision)
    child = np.arange(S)
    valid = parent != child
    k = np.where(valid, np.minimum(parent, child) * S + np.maximum(parent, child), 0)
    bu = np.where(valid, umat[k], 0)
    bv = np.where(valid, vmat[k], 0)
    bw = np.where(valid, dmat[k] - dist[bu] - dist[bv], 0)
    n = dist.shape[0]
    marked = np.zeros(n, bool)
    for x in np.unique(np.concatenate([bu[valid], bv[valid]])):
        x = int(x)
        while not marked[x]:
            marked[x] = True
            if pred[x] == x:
                break
            x = int(pred[x])
    ids = np.arange(n)
    path_edge = marked & (pred != ids)
    weights = np.concatenate([(dist - dist[pred])[path_edge], bw[valid]])
    total = int(rnd(torch.tensor(int(weights.sum()))))
    return dict(in_tree_vertex=marked, path_edge=path_edge, bridge_u=bu, bridge_v=bv,
                bridge_w=bw, bridge_valid=valid, total_distance=total,
                num_edges=int(path_edge.sum() + valid.sum()))


def solve(src, dst, w, n: int, seeds, precision: str = "float32") -> dict:
    """The whole answer for one query: the directed edges (src, dst, w) of
    the symmetric graph (int64 ids, integer float weights) and (S,) seeds,
    on one device.  Host arrays, in the program's encoding: dist float64
    (+inf unreached), lab, pred, dmat float64 (+inf where no edge), parent,
    the tree's arrays, its total distance and edge count."""
    if not bool(torch.equal(w, torch.round(w))):
        raise ValueError("the reference holds integer weights only")
    wi = torch.where(torch.isfinite(w), w, 0).to(torch.int64)
    live = torch.isfinite(w)
    if not bool(live.all()):
        src, dst, wi = src[live], dst[live], wi[live]
    seeds = torch.as_tensor(seeds, dtype=torch.int64, device=src.device)
    S = int(seeds.shape[0])
    dist, lab, pred, rounds = voronoi(src, dst, wi, n, seeds, precision)
    dmat, umat, vmat = distance_graph(src, dst, wi, dist, lab, n, S, precision)
    dist_h, lab_h, pred_h = (x.cpu().numpy() for x in (dist, lab, pred))
    dmat_h, umat_h, vmat_h = (x.cpu().numpy() for x in (dmat, umat, vmat))
    parent = prim(dmat_h, S)
    t = tree(np.where(dist_h < 0, 0, dist_h), pred_h, dmat_h, umat_h, vmat_h, parent, S,
             precision)
    if precision == "float32" and max(int(dmat_h.max(initial=0)), t["total_distance"]) >= F32_EXACT:
        raise ValueError("a distance passes 2**24, where float32 is no longer exact")
    out = dict(
        dist=np.where(dist_h < 0, np.inf, dist_h.astype(np.float64)),
        lab=lab_h, pred=pred_h,
        dmat=np.where(dmat_h < 0, np.inf, dmat_h.astype(np.float64)),
        parent=parent, rounds=rounds,
    )
    out.update(t)
    out["bridge_w"] = out["bridge_w"].astype(np.float64)
    return out
