"""Query planning: canonicalization, shape buckets, inert padding.

A numpy-only copy of ``repro.serve.plan``.  Every query is padded up to a
small ladder of shape buckets (default {8, 16, 32, 64}), so the server runs
a handful of fixed (B, bucket) batch shapes whatever the seed-set sizes.

Padding must not change the answer.  A query is padded *with duplicates of
its own first seed*: under the lex-min Voronoi initialization
(:func:`repro_torch.core.voronoi.init_state`) a duplicated seed vertex is
owned by its lowest index, the higher duplicate indices label empty cells,
empty cells contribute no bridges to G'1, the MST leaves them as isolated
roots, and isolated roots add no bridge weight to the tree, so
``total_distance`` is bitwise identical to the unpadded query.

Canonicalization (sort + dedup) also gives the result cache its key: two
users asking for the same seed set in different orders hit the same entry.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

DEFAULT_BUCKETS: Tuple[int, ...] = (8, 16, 32, 64)


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """A query after canonicalization + bucketing.

    Attributes:
      key: canonical cache key, sorted and deduped seed ids.
      padded: (bucket,) int32, the canonical seeds padded with duplicates of
        the first seed (inert under the lex-min update).
      bucket: the shape bucket (== len(padded)).
      num_unique: |key|, the true seed count.
    """

    key: Tuple[int, ...]
    padded: np.ndarray
    bucket: int
    num_unique: int


def canonical_key(seeds: Sequence[int]) -> Tuple[int, ...]:
    """Sorted, deduped seed ids: the cache identity of a query."""
    return tuple(np.unique(np.asarray(seeds, np.int64)).tolist())


def choose_bucket(k: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket holding k seeds; raises if none fits."""
    for b in sorted(buckets):
        if k <= b:
            return int(b)
    raise ValueError(
        f"seed set of size {k} exceeds the largest shape bucket "
        f"{max(buckets)}; raise ServeConfig.buckets"
    )


def pad_seed_set(key: Sequence[int], bucket: int) -> np.ndarray:
    """Pads canonical seeds to ``bucket`` with duplicates of the first seed."""
    arr = np.asarray(key, np.int32)
    if arr.size == 0:
        raise ValueError("empty seed set")
    if arr.size > bucket:
        raise ValueError(f"{arr.size} seeds do not fit bucket {bucket}")
    pad = np.full(bucket - arr.size, arr[0], np.int32)
    return np.concatenate([arr, pad])


def plan_query(
    seeds: Sequence[int], buckets: Sequence[int] = DEFAULT_BUCKETS
) -> QueryPlan:
    """Canonicalize + bucket + pad one incoming seed set."""
    key = canonical_key(seeds)
    if len(key) < 2:
        raise ValueError(f"need >= 2 distinct seeds, got {len(key)}")
    bucket = choose_bucket(len(key), buckets)
    return QueryPlan(
        key=key,
        padded=pad_seed_set(key, bucket),
        bucket=bucket,
        num_unique=len(key),
    )
