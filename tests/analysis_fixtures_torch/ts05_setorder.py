"""TS05 — array construction from unordered set iteration."""

import numpy as np


def bad_layouts(edges, names):
    verts = np.array(list({u for u, _ in edges}))  # expect: TS05
    ids = np.asarray(set(names))  # expect: TS05
    both = np.fromiter({1, 2, 3}, dtype=np.int64)  # expect: TS05
    merged = list(set(names) | set(ids))  # expect: TS05
    return verts, ids, both, merged


def sorted_is_deterministic(edges, names):
    # sorting the set before materializing pins the layout — quiet
    verts = np.array(sorted({u for u, _ in edges}))
    ids = np.asarray(sorted(set(names)))
    return verts, ids


def lists_are_ordered(names):
    # list/tuple sources preserve order — quiet
    a = np.array([n for n in names])
    b = np.asarray(tuple(names))
    return a, b
