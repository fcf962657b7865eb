"""The comparison that decides ``correct``: the program's answers against
the plain reference's, number by number, each against its limit.

A solve's answer is every stage the program produced for it: the Voronoi
state (dist, lab, pred of every vertex), the distance graph and its MST
(the pair table and the parent array), and the tree (its vertices, path
edges, bridges, total distance and edge count).  A mesh solve returns no
pair table and no parent: its bridge rows, which follow from both, hold
them to the reference.  A served answer is what the server returns for a
request: the total distance and the edge count.  Answers are exact, so
every limit is 0.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

STATE = ("dist", "lab", "pred")
BRIDGE = ("bridge_u", "bridge_v", "bridge_w", "bridge_valid")


def solve_answer(raw) -> Dict[str, np.ndarray]:
    """Host copy of what a solve produced, in the reference's encoding: a
    single solve's ``SteinerResult`` (tensors), or a mesh solve's
    ``DistSteinerResult`` (host arrays; its ``marked`` is the tree's
    vertices, and it has no ``dmat`` and no ``parent``)."""
    if hasattr(raw, "marked"):
        out = {k: getattr(raw, k) for k in ("dist", "lab", "pred", "path_edge") + BRIDGE}
        out["in_tree_vertex"] = raw.marked
    else:
        st, t = raw.state, raw.tree
        out = {"dist": st.dist, "lab": st.lab, "pred": st.pred, "dmat": raw.dmat,
               "parent": raw.parent, "in_tree_vertex": t.in_tree_vertex,
               "path_edge": t.path_edge, "bridge_u": t.bridge_u, "bridge_v": t.bridge_v,
               "bridge_w": t.bridge_w, "bridge_valid": t.bridge_valid}
        out = {k: v.detach().cpu().numpy() for k, v in out.items()}
        raw = t
    out["total_distance"] = float(raw.total_distance)
    out["num_edges"] = int(raw.num_edges)
    return out


def _rows_differ(got: dict, ref: dict, keys) -> int:
    """Rows (vertices, pairs, seeds) where any of ``keys`` differs; every
    row where a shape differs."""
    rows = np.asarray(ref[keys[0]]).shape[0]
    bad = np.zeros(rows, bool)
    for k in keys:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        if g.shape != r.shape:
            return rows
        bad |= g != r
    return int(bad.sum())


def compare_solve(got: dict, ref: dict) -> Dict[str, float]:
    """The numbers of one solve: vertices whose state differs, pair-table
    and parent entries that differ (where the answer has them), tree
    entries that differ (vertices, path edges, bridge rows, the edge count)
    and the gap of the totals."""
    tree = (_rows_differ(got, ref, ("in_tree_vertex",)) + _rows_differ(got, ref, ("path_edge",))
            + _rows_differ(got, ref, BRIDGE) + int(got["num_edges"] != ref["num_edges"]))
    out = {
        "state_mismatch": _rows_differ(got, ref, STATE),
        "tree_mismatch": tree,
        "total_gap": abs(float(got["total_distance"]) - float(ref["total_distance"])),
    }
    if "dmat" in got:
        out["graph_mismatch"] = (_rows_differ(got, ref, ("dmat",))
                                 + _rows_differ(got, ref, ("parent",)))
    return out


def compare_served(got: Tuple[float, int], ref: dict) -> Dict[str, float]:
    """The numbers of one served request: (total distance, edge count)."""
    total, edges = got
    gap = abs(float(total) - float(ref["total_distance"]))
    return {"answer_mismatch": int(gap != 0 or int(edges) != ref["num_edges"]),
            "total_gap": gap}


def combine(parts: Iterable[Dict[str, float]], extra: Dict[str, float]) -> Dict[str, float]:
    """Counts add up over the compared answers; gaps take the largest."""
    out: Dict[str, float] = {}
    for p in parts:
        for k, v in p.items():
            out[k] = max(out.get(k, 0), v) if k.endswith("_gap") else out.get(k, 0) + v
    out.update(extra)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[str]]:
    """``correct`` and one line a number, ``name value limit``.  A number
    the limits name but the run did not produce fails, and so does a run
    that compared no answer."""
    compared = int(numbers.get("compared", 0))
    ok = compared > 0
    lines = [f"check compared {compared} answers (at least 1) {'ok' if ok else 'FAIL'}"]
    for name, limit in limits.items():
        value = numbers.get(name)
        passed = value is not None and np.isfinite(value) and value <= limit
        ok &= bool(passed)
        lines.append(f"check {name} {value} limit {limit} {'ok' if passed else 'FAIL'}")
    return ok, lines


def sample(count: int, k: int, rng: np.random.Generator, must: Iterable[int] = ()) -> List[int]:
    """Up to ``k`` distinct indices below ``count``, those in ``must``
    first, the rest drawn by ``rng``."""
    chosen = [i for i in dict.fromkeys(must) if 0 <= i < count][:k]
    rest = np.setdiff1d(np.arange(count), chosen)
    extra = rng.choice(rest, size=min(k - len(chosen), rest.size), replace=False)
    return sorted(chosen + [int(i) for i in extra])


def batch_sample(sizes: List[List[int]], k: int, rng: np.random.Generator) -> List[int]:
    """Indices into the batches' answers laid end to end: every answer of
    the batch holding the largest query, so that every lane of a batch is
    compared, and up to ``k`` more drawn by ``rng``."""
    flat = [s for b in sizes for s in b]
    if not flat:
        return []
    largest = int(np.argmax(flat))
    start = 0
    for b in sizes:
        if largest < start + len(b):
            break
        start += len(b)
    lanes = list(range(start, start + len(b)))
    return sample(len(flat), len(lanes) + k, rng, must=lanes)
