"""The traffic generator (bench/perfkit/traffic.py): seeded, and the laws
the cells state."""

import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from perfkit import traffic  # noqa: E402

N = 1 << 23
LOGU = {"dist": "loguniform", "lo": 2, "hi": 32, "block": 64}


def take(it, k):
    return [next(it) for _ in range(k)]


def test_same_seed_same_queries():
    spec = {"sizes": LOGU}
    a = take(traffic.query_stream(spec, N, 3_000_000_001), 50)
    b = take(traffic.query_stream(spec, N, 3_000_000_001), 50)
    c = take(traffic.query_stream(spec, N, 3_000_000_002), 50)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_queries_are_distinct_uniform_sets():
    qs = take(traffic.query_stream({"sizes": {"dist": "fixed", "value": 1024}}, N, 9), 8)
    assert all(len(np.unique(q)) == 1024 and q.min() >= 0 and q.max() < N for q in qs)
    keys = {np.sort(q).tobytes() for q in qs}
    assert len(keys) == len(qs)
    # uniform over the vertices: the mean id sits near N / 2
    assert abs(np.concatenate(qs).mean() / N - 0.5) < 0.02


def test_loguniform_sizes_follow_the_law():
    block = traffic.size_block(LOGU)
    assert len(block) == 64 and block.min() == 2 and block.max() == 32
    # P(size <= k) = log((k + 1) / 2) / log(33 / 2) for the floor of exp(U(log 2, log 33))
    for k in (2, 4, 8, 16, 31):
        want = np.log((k + 1) / 2) / np.log(33 / 2)
        assert abs((block <= k).mean() - want) <= 1 / 64 + 1e-9
    # every block of 64 queries has the same sizes, in another order
    sizes = [len(q) for q in take(traffic.query_stream({"sizes": LOGU}, N, 4), 128)]
    assert sorted(sizes[:64]) == sorted(sizes[64:]) == sorted(block.tolist())
    assert sizes[:64] != sizes[64:]


def test_full_batches_fill_one_bucket_at_a_time():
    stream = traffic.query_stream({"sizes": LOGU}, N, 5)
    gen = traffic.full_batches(stream, (8, 16, 32), 8)
    batches = take(gen, 40)
    assert all(len(b) == 8 for b in batches)
    # each batch holds one bucket's queries, in the stream's order
    for b in batches:
        assert len({traffic.bucket_of(len(q), (8, 16, 32)) for q in b}) == 1
    again = take(traffic.full_batches(traffic.query_stream({"sizes": LOGU}, N, 5),
                                      (8, 16, 32), 8), 40)
    assert all(np.array_equal(x, y) for a, b in zip(batches, again) for x, y in zip(a, b))


def test_bucket_of():
    assert [traffic.bucket_of(k, (8, 16, 32)) for k in (2, 8, 9, 16, 17, 32)] == \
        [8, 8, 16, 16, 32, 32]
    with pytest.raises(ValueError):
        traffic.bucket_of(33, (8, 16, 32))
