"""The one generator of every traffic mix: the queries of a
mix's parameters (``bench/traffic/<name>.json``) and ``--seed``.

A query is a set of distinct seed vertices drawn uniformly from the graph.
Sizes are ``fixed`` or ``loguniform`` over [lo, hi] (the serving mix of the
repo's perf_serve: ``floor(exp(U(log lo, log(hi + 1))))``).  Every seed is
given the same sizes in another order, so that two seeds
differ in which vertices they ask for and in what order, not in how much
work they send: log-uniform sizes are the quantiles of the law at the
midpoints of ``block`` equal steps, shuffled block by block.

Kinds of mix:

* ``closed``: one client, the next query sent when the last returns; an
  endless stream of fresh queries (:func:`query_stream`).
* ``backlog``: the same stream, dispatched ahead of the server in full
  batches, one bucket at a time (:func:`full_batches`).
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

# purposes of the run's seed (the graph takes 0; see perfkit.graphgen)
QUERIES, SAMPLE, WARMUP = 1, 4, 5


def rng_for(seed: int, purpose: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, purpose]))


def size_block(sizes: dict) -> np.ndarray:
    """One block of query sizes, in order (shuffle before use)."""
    if sizes["dist"] == "fixed":
        return np.array([int(sizes["value"])])
    if sizes["dist"] != "loguniform":
        raise ValueError(f"unknown size law {sizes['dist']!r}")
    lo, hi, k = int(sizes["lo"]), int(sizes["hi"]), int(sizes["block"])
    u = (np.arange(k) + 0.5) / k
    return np.clip(np.exp(np.log(lo) + u * (np.log(hi + 1) - np.log(lo))).astype(int), lo, hi)


def _fresh(rng: np.random.Generator, n: int, k: int, seen: set) -> np.ndarray:
    """k distinct vertices, uniform, forming a set not asked for before."""
    while True:
        q = rng.choice(n, size=k, replace=False).astype(np.int32)
        key = np.sort(q).tobytes()
        if key not in seen:
            seen.add(key)
            return q


def query_stream(spec: dict, n: int, seed: int) -> Iterator[np.ndarray]:
    """Endless fresh queries (distinct seed sets) of a closed or backlog mix."""
    rng = rng_for(seed, QUERIES)
    block = size_block(spec["sizes"])
    seen: set = set()
    while True:
        for k in rng.permutation(block):
            yield _fresh(rng, n, int(k), seen)


def bucket_of(k: int, buckets) -> int:
    """The server's shape bucket of a query of k distinct seeds."""
    for b in sorted(buckets):
        if k <= b:
            return int(b)
    raise ValueError(f"a query of {k} seeds fits no bucket of {buckets}")


def full_batches(stream: Iterator[np.ndarray], buckets, lanes: int) -> Iterator[List[np.ndarray]]:
    """The queries of ``stream`` queued by shape bucket; each bucket's batch
    of ``lanes`` queries as soon as it is full."""
    buf = {int(b): [] for b in buckets}
    for q in stream:
        b = bucket_of(len(q), buckets)
        buf[b].append(q)
        if len(buf[b]) == lanes:
            yield buf[b]
            buf[b] = []
