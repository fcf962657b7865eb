"""The CUDA kernels of ``repro_torch`` on the card, held bit for bit against
their plain PyTorch version, and the solver's fixed answers on the card.

Every test here needs a CUDA device and skips without one.  This file
imports neither JAX nor ``repro``, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from _minplus_inputs import ell_inputs, lane_inputs, tie_inputs
from _segmin_inputs import segmin_inputs
from repro_torch.core.graph import from_edges
from repro_torch.data.graphs import rmat_edges, select_seeds
from repro_torch.kernels.minplus import minplus as tmp
from repro_torch.kernels.minplus import ops as tops
from repro_torch.kernels.minplus.ref import minplus_torch
from repro_torch.kernels.segmin import segmin as tseg
from repro_torch.kernels.segmin.ops import segmin_bucketed
from repro_torch.kernels.segmin.ref import segmin_bucketed_torch
from repro_torch.serve import ServeConfig, SteinerServer
from repro_torch.solver import SolverConfig, SteinerSolver

IMAX = np.iinfo(np.int32).max
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _on(dev, dtype, nbr, wgt, dist, lab):
    return (torch.from_numpy(nbr).to(dev), torch.from_numpy(wgt).to(dev, dtype),
            torch.from_numpy(dist).to(dev, dtype), torch.from_numpy(lab).to(dev))


def _assert_triples_equal(want, got):
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(128, 4, 64), (300, 8, 300), (512, 16, 1024),
                                   (129, 32, 4096), (77, 48, 500)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(cuda, shape, dtype):
    R, K, N = shape
    t = _on(cuda, dtype, *ell_inputs(R, K, N, seed=R + K))
    want = minplus_torch(*t)
    n0 = tmp.minplus_call.launches
    _assert_triples_equal(want, tmp.minplus_call(*t, block_rows=64))
    assert tmp.minplus_call.launches == n0 + 1
    for sb in (64, 100, N):
        _assert_triples_equal(
            want, tmp.minplus_blocked_call(*t, block_rows=128, src_block=sb)
        )


def test_kernel_empty_rows(cuda):
    R, K, N = 200, 8, 64
    m, ml, ms = tmp.minplus_call(
        torch.zeros((R, K), dtype=torch.int32, device=cuda),
        torch.full((R, K), float("inf"), device=cuda),
        torch.zeros(N, device=cuda),
        torch.zeros(N, dtype=torch.int32, device=cuda),
    )
    torch.cuda.synchronize()
    assert torch.isinf(m).all()
    assert (ml == IMAX).all() and (ms == IMAX).all()


def test_kernel_rejects_mixed_devices(cuda):
    t = list(_on(cuda, torch.float32, *ell_inputs(32, 4, 16, seed=0)))
    t[2] = t[2].cpu()
    with pytest.raises(ValueError, match="dist"):
        tmp.minplus_call(*t)


@pytest.mark.parametrize("src_block", [None, 256])
def test_scale10_fixed_answers_on_card(cuda, src_block):
    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    seeds = select_seeds(n, src, dst, 16, strategy="uniform", seed=1000)
    g = from_edges(src, dst, w, n, pad_to=8, device=cuda)
    cfg = SolverConfig(backend="single", mode="pallas", src_block=src_block)
    launches = (tmp.minplus_call.launches, tmp.minplus_blocked_call.launches)
    out = SteinerSolver(cfg).prepare(g).solve(seeds)
    t = out.telemetry
    assert (out.total_distance, out.num_edges) == (547.0, 44)
    assert (t.iterations, t.relaxations, t.messages) == (10, 2638, 45912)
    grew = (tmp.minplus_call.launches - launches[0],
            tmp.minplus_blocked_call.launches - launches[1])
    assert grew == ((10, 0) if src_block is None else (0, 10))
    st = out.raw.state
    new, upd = tops.relax_ell(SteinerSolver(cfg).prepare(g).artifact("ell"), st)
    assert not bool(upd.any())


@pytest.mark.parametrize("B", [1, 2, 3, 4, 5, 8, 9, 16, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_kernels_match_plain(cuda, B, dtype):
    """(B, N) distances: one launch for all lanes, equal to the plain
    version; the last lane is entirely unreached (+inf)."""
    R, K, N = 777, 32, 3000
    nbr, wgt, dist, lab = lane_inputs(R, K, N, B, seed=B)
    dist[-1] = np.inf
    t = _on(cuda, dtype, nbr, wgt, dist, lab)
    want = minplus_torch(*t)
    n0 = (tmp.minplus_call.launches, tmp.minplus_call.lane_launches)
    _assert_triples_equal(want, tmp.minplus_call(*t, block_rows=64))
    assert (tmp.minplus_call.launches, tmp.minplus_call.lane_launches) == (n0[0] + 1,
                                                                           n0[1] + 1)
    for sb in (500, N):
        _assert_triples_equal(
            want, tmp.minplus_blocked_call(*t, block_rows=128, src_block=sb))


@pytest.mark.parametrize("K", [4, 33, 48])
@pytest.mark.parametrize("B", [None, 3, 8])
@pytest.mark.parametrize("block_rows", [1, 256])
def test_resident_kernels_k_sweep_ragged(cuda, K, B, block_rows):
    """K not a multiple of 4 (bulk copies end off 16 bytes) and a ragged R
    (the last tile is short), with and without a lane axis."""
    for dtype in (torch.float32, torch.bfloat16):
        t = _on(cuda, dtype, *lane_inputs(1537, K, 3001, B, seed=K))
        _assert_triples_equal(minplus_torch(*t), tmp.minplus_call(*t, block_rows=block_rows))


@pytest.mark.parametrize("K", [1800, 2500])
@pytest.mark.parametrize("B", [None, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resident_kernels_wide_rows(cuda, K, B, dtype):
    """Rows too wide for two stages of eight in shared memory (K = 2500; K =
    1800 in f32 is just under that) are read in place, still exact."""
    t = _on(cuda, dtype, *lane_inputs(37, K, 4001, B, seed=K))
    _assert_triples_equal(minplus_torch(*t), tmp.minplus_call(*t))


def test_resident_kernels_reject_unaligned_views(cuda):
    """A row slice that does not start on 16 bytes raises, it is not copied."""
    nbr, wgt, dist, lab = _on(cuda, torch.float32, *ell_inputs(64, 3, 32, seed=0))
    with pytest.raises(ValueError, match="nbr must start on 16 bytes"):
        tmp.minplus_call(nbr[1:], wgt[1:].clone(), dist, lab)
    with pytest.raises(ValueError, match="wgt must start on 16 bytes"):
        tmp.minplus_call(nbr[1:].clone(), wgt[1:], dist, lab)


@pytest.mark.parametrize("B", [None, 1, 2, 3, 8, 9, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_records_kernel_matches_plain(cuda, B, dtype):
    """The card's record table equals the plain version's, padding lanes
    and +inf distances included."""
    _, _, dist, lab = lane_inputs(16, 4, 3001, B, seed=11)
    d, lb = torch.from_numpy(dist).to(dtype), torch.from_numpy(lab)
    n0 = tmp.pack_records.launches
    got = tmp.pack_records(d.to(cuda), lb.to(cuda))
    assert tmp.pack_records.launches == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), tmp.pack_records(d, lb))


def test_lane_kernel_all_padding_rows(cuda):
    """Rows whose every slot is +inf padding give (+inf, IMAX, IMAX) in all
    eight lanes."""
    R, K, N, B = 203, 8, 64, 8
    m, ml, ms = tmp.minplus_call(
        torch.zeros((R, K), dtype=torch.int32, device=cuda),
        torch.full((R, K), float("inf"), device=cuda),
        torch.zeros((B, N), device=cuda),
        torch.zeros((B, N), dtype=torch.int32, device=cuda),
    )
    torch.cuda.synchronize()
    assert m.shape == (B, R) and torch.isinf(m).all()
    assert (ml == IMAX).all() and (ms == IMAX).all()


@pytest.mark.parametrize("B", [None, 2, 8])
@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.float32),
                                    (torch.float32, torch.bfloat16)])
def test_resident_kernels_mixed_types(cuda, B, dtypes):
    """bf16 weights over f32 distances, and f32 weights over bf16 ones."""
    wd, dd = dtypes
    nbr, wgt, dist, lab = lane_inputs(500, 32, 2000, B, seed=9)
    t = (torch.from_numpy(nbr).to(cuda), torch.from_numpy(wgt).to(cuda, wd),
         torch.from_numpy(dist).to(cuda, dd), torch.from_numpy(lab).to(cuda))
    _assert_triples_equal(minplus_torch(*t), tmp.minplus_call(*t))


@pytest.mark.parametrize("B", [None, 1, 2, 5, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resident_kernels_tie_heavy(cuda, B, dtype):
    """Integer weights, distances and labels: most minima are decided on
    the label or the neighbor id."""
    t = _on(cuda, dtype, *tie_inputs(1000, 32, 50, seed=3, B=B))
    _assert_triples_equal(minplus_torch(*t), tmp.minplus_call(*t, block_rows=64))
    _assert_triples_equal(minplus_torch(*t), tmp.minplus_blocked_call(*t, src_block=16))


@pytest.mark.parametrize("shape", [(1, 256, 32), (4, 512, 64), (2, 1000, 128),
                                   (8, 64, 256), (3, 4096, 8192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ties", [False, True])
def test_segmin_kernel_matches_plain(cuda, shape, dtype, ties):
    NB, EB, VB = shape  # vb = 8192 takes 96 KB of shared memory
    cand, ldst, lab, src = segmin_inputs(NB, EB, VB, seed=EB, ties=ties)
    t = (torch.from_numpy(cand).to(cuda, dtype), torch.from_numpy(ldst).to(cuda),
         torch.from_numpy(lab).to(cuda), torch.from_numpy(src).to(cuda))
    n0 = tseg.segmin_bucketed_call.launches
    got = segmin_bucketed(*t, vb=VB, edge_block=256)
    assert tseg.segmin_bucketed_call.launches == n0 + 1
    _assert_triples_equal(segmin_bucketed_torch(*t, VB), got)


def test_segmin_kernel_all_padding(cuda):
    NB, EB, VB = 2, 128, 16
    z = torch.zeros((NB, EB), dtype=torch.int32, device=cuda)
    m, ml, ms = segmin_bucketed(torch.full((NB, EB), float("inf"), device=cuda), z, z, z,
                                vb=VB, edge_block=128)
    torch.cuda.synchronize()
    assert torch.isinf(m).all() and (ml == IMAX).all() and (ms == IMAX).all()


@pytest.mark.parametrize("src_block", [None, 256])
def test_batch_backend_on_card_matches_cpu(cuda, src_block):
    """Scale 10, a (6, 16) batch: the card's batch solve equals the CPU's bit
    for bit, and the kernel runs once a round for all lanes."""
    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    rng = np.random.default_rng(0)
    seeds = np.stack([rng.choice(n, 16, replace=False) for _ in range(6)]).astype(np.int32)
    seeds[1, 8:] = seeds[1, 0]
    cfg = SolverConfig(backend="batch", mode="pallas", src_block=src_block)
    out = {}
    for d in (cuda, "cpu"):
        h = SteinerSolver(cfg, device=d).prepare(from_edges(src, dst, w, n, pad_to=8, device=d))
        kern = tmp.minplus_call if src_block is None else tmp.minplus_blocked_call
        n0 = kern.lane_launches
        out[str(d)] = (h.solve(seeds), kern.lane_launches - n0)
    (a, la), (b, lb) = out[str(cuda)], out["cpu"]
    assert la == a.telemetry.iterations and lb == 0
    for f in ("dist", "lab", "pred"):
        assert torch.equal(getattr(a.raw.state, f).cpu(), getattr(b.raw.state, f))
    for f in ("path_edge", "bridge_u", "bridge_v", "bridge_w", "total_distance"):
        assert torch.equal(getattr(a.raw.tree, f).cpu(), getattr(b.raw.tree, f))
    assert torch.equal(a.raw.stats.history.cpu(), b.raw.stats.history)
    assert (a.total_distance == b.total_distance).all()
    ta, tb = a.telemetry, b.telemetry
    assert (ta.iterations, ta.relaxations, ta.messages) == (tb.iterations, tb.relaxations,
                                                            tb.messages)
    assert (ta.per_round == tb.per_round).all()


def test_server_on_card_matches_cpu(cuda):
    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    rng = np.random.default_rng(1)
    stream = [rng.choice(n, int(k), replace=False).tolist()
              for k in rng.integers(2, 30, 12)]
    stream += stream[:4]
    cfg = ServeConfig(mode="pallas", buckets=(8, 16, 32), max_batch=4)
    res = {}
    for d in (cuda, "cpu"):
        srv = SteinerServer(from_edges(src, dst, w, n, pad_to=8, device=d), cfg, device=d)
        res[str(d)] = ([(r.total_distance, r.num_edges, r.from_cache)
                        for r in srv.query_many(stream)], srv.stats())
    (a, sa), (b, sb) = res[str(cuda)], res["cpu"]
    assert a == b
    timed = ("qps", "latency_p50_ms", "latency_p99_ms", "fresh_p50_ms", "fresh_p99_ms",
             "cached_p50_ms", "cached_p99_ms")
    assert {k: v for k, v in sa.items() if k not in timed} == {
        k: v for k, v in sb.items() if k not in timed}
