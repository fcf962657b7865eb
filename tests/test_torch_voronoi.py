"""Voronoi state and the min-plus fixpoint loop of ``repro_torch`` against
``repro`` (JAX kernels in interpret mode) and the Dijkstra oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.voronoi as jvor
import repro.kernels.minplus.ops as jops
from repro.core.graph import to_ell as jto_ell
from repro.core.ref import voronoi_ref
from _torch_parity import assert_same, both_graphs, host, instance
from repro_torch.core import voronoi as tvor
from repro_torch.core.graph import to_ell as tto_ell
from repro_torch.kernels.minplus import ops as tops


@pytest.mark.parametrize(
    "seeds", [[3, 0, 7], [5, 5, 2, 5], [9, 1, 9, 1, 4, 1]], ids=["plain", "dup", "dups"]
)
def test_init_state_matches(seeds):
    seeds = np.asarray(seeds, np.int32)
    j = jvor.init_state(12, jnp.asarray(seeds))
    t = tvor.init_state(12, torch.from_numpy(seeds))
    for f in ("dist", "lab", "pred"):
        assert_same(getattr(j, f), getattr(t, f))


def test_hist_write_spills_into_last_row():
    hist = torch.zeros((3, 4))
    row = torch.arange(4, dtype=torch.float32)
    tvor._hist_write(hist, 0, row)
    tvor._hist_write(hist, 5, row + 10)
    tvor._hist_write(hist, 9, row + 20)
    j = jnp.zeros((3, 4), jnp.float32)
    j = jvor._hist_write(j, jnp.int32(0), jnp.arange(4, dtype=jnp.float32))
    j = jvor._hist_write(j, jnp.int32(5), jnp.arange(4, dtype=jnp.float32) + 10)
    j = jvor._hist_write(j, jnp.int32(9), jnp.arange(4, dtype=jnp.float32) + 20)
    assert_same(j, hist)


def test_round_row_matches():
    dist = np.array([0.0, np.inf, 3.0, np.inf], np.float32)
    j = jvor._round_row(jnp.int32(3), jnp.float32(7.0), jnp.float32(2.0), jnp.asarray(dist))
    t = tvor._round_row(torch.tensor(3), torch.tensor(7), torch.tensor(2),
                        torch.from_numpy(dist))
    assert_same(j, t)


def _solve_both(trial, k, src_block, block_rows=16, max_iters=None, n_seeds=5, rounds=8):
    src, dst, w, n, seeds = instance(trial, n_seeds)
    jg, tg = both_graphs(src, dst, w, n)
    jst, jstats = jops.voronoi_cells_pallas(
        jto_ell(jg, k), jnp.asarray(seeds), block_rows=block_rows, src_block=src_block,
        interpret=True, max_iters=max_iters, telemetry_rounds=rounds,
    )
    tst, tstats = tops.voronoi_cells_pallas(
        tto_ell(tg, k), torch.from_numpy(seeds), block_rows=block_rows,
        src_block=src_block, max_iters=max_iters, telemetry_rounds=rounds,
    )
    return (src, dst, w, n, seeds), (jst, jstats), (tst, tstats)


@pytest.mark.parametrize("trial,k,src_block", [
    (0, 4, None), (1, 8, None), (2, 4, None), (3, 4, 16), (4, 32, 40), (5, 8, 7),
])
def test_voronoi_cells_pallas_matches_jax(trial, k, src_block):
    _, (jst, jstats), (tst, tstats) = _solve_both(trial, k, src_block)
    for f in ("dist", "lab", "pred"):
        assert_same(getattr(jst, f), getattr(tst, f))
    for f in ("iterations", "relaxations", "messages", "history"):
        assert_same(getattr(jstats, f), getattr(tstats, f))


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_voronoi_cells_pallas_matches_dijkstra(trial):
    (src, dst, w, n, seeds), _, (tst, _) = _solve_both(trial, 4, None)
    edges = list(zip(src.tolist(), dst.tolist(), w.tolist()))
    dist, lab, pred = voronoi_ref(n, edges, seeds.tolist())
    np.testing.assert_array_equal(host(tst.dist), dist.astype(np.float32))
    np.testing.assert_array_equal(host(tst.lab), lab)
    np.testing.assert_array_equal(host(tst.pred), pred)


def test_max_iters_honoured_and_matches_jax():
    _, (jst, jstats), (tst, tstats) = _solve_both(1, 4, None, max_iters=2)
    assert int(tstats.iterations) == 2
    for f in ("dist", "lab", "pred"):
        assert_same(getattr(jst, f), getattr(tst, f))
    assert_same(jstats.history, tstats.history)


def test_history_spills_past_telemetry_rounds():
    """More rounds than telemetry rows: the spill row holds the last round."""
    _, (_, jstats), (_, tstats) = _solve_both(2, 4, None, n_seeds=1, rounds=3)
    assert int(tstats.iterations) > 3
    assert_same(jstats.history, tstats.history)


def test_duplicate_seeds_inert():
    src, dst, w, n, seeds = instance(1)
    _, tg = both_graphs(src, dst, w, n)
    ell = tto_ell(tg, 8)
    base, _ = tops.voronoi_cells_pallas(ell, torch.from_numpy(seeds))
    padded = np.concatenate([seeds, np.full(3, seeds[0], np.int32)])
    out, _ = tops.voronoi_cells_pallas(ell, torch.from_numpy(padded))
    for f in ("dist", "lab", "pred"):
        assert_same(getattr(base, f), getattr(out, f))


def test_no_telemetry_gives_no_history():
    src, dst, w, n, seeds = instance(0)
    _, tg = both_graphs(src, dst, w, n)
    _, stats = tops.voronoi_cells_pallas(tto_ell(tg, 4), torch.from_numpy(seeds))
    assert stats.history is None
    assert stats.iterations.dtype == torch.int32
    assert stats.relaxations.dtype == stats.messages.dtype == torch.float32
