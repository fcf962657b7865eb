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
from repro_torch.kernels.minplus.ref import minplus_blocked_torch, minplus_torch
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
        # slices of one block each: one launch a slice
        layout = tmp.blocked_layout(t[0], t[1], N, sb, budget=8 * sb)
        n0 = tmp.minplus_blocked_call.launches
        _assert_triples_equal(
            want, tmp.minplus_blocked_call(*t, block_rows=128, src_block=sb, layout=layout)
        )
        assert tmp.minplus_blocked_call.launches == n0 + len(layout.slices)


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
        out[str(d)] = (h.solve(seeds), kern.lane_launches - n0, h)
    (a, la, hc), (b, lb, _) = out[str(cuda)], out["cpu"]
    per_round = 1
    if src_block is not None:  # one launch a (lane group, source slice)
        layout = tops.ell_layout(hc.artifact("ell"), src_block, seeds.shape[0])
        per_round = -(-seeds.shape[0] // tmp.blocked_stride(6)) * len(layout.slices)
    assert la == a.telemetry.iterations * per_round and lb == 0
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


def test_src_block_builds_the_layout_once_on_the_card(cuda):
    """A scale-10 fixpoint with ``src_block`` builds its layout once, not a
    round; a prepared handle builds it in ``prepare`` and never again; a
    batch handle once for every batch width; each equals the solve without
    ``src_block``."""
    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    g = from_edges(src, dst, w, n, pad_to=8, device=cuda)
    h0 = SteinerSolver(SolverConfig(backend="single", mode="pallas"), device=cuda).prepare(g)
    ell = h0.artifact("ell")
    seeds = torch.arange(0, 1024, 64, dtype=torch.int32, device=cuda)
    b0 = tmp.blocked_layout.builds
    st, stats = tops.voronoi_cells_pallas(ell, seeds, src_block=256)
    assert int(stats.iterations) > 2 and tmp.blocked_layout.builds == b0 + 1
    ref, _ = tops.voronoi_cells_pallas(ell, seeds)
    for f in ("dist", "lab", "pred"):
        assert torch.equal(getattr(ref, f), getattr(st, f))

    b0 = tmp.blocked_layout.builds
    cfg = SolverConfig(backend="single", mode="pallas", src_block=256)
    h = SteinerSolver(cfg, device=cuda).prepare(g)
    assert tmp.blocked_layout.builds == b0 + 1
    L = h.artifact("blocked_layout")
    assert (L.src_block, L.n, L.rows) == (256, n, ell.nbr.shape[0])
    want = h0.solve(seeds.cpu().numpy()).total_distance
    for _ in range(2):
        assert h.solve(seeds.cpu().numpy()).total_distance == want
    assert tmp.blocked_layout.builds == b0 + 1
    assert h0.artifact("blocked_layout") is None

    hb = SteinerSolver(cfg.replace(backend="batch"), device=cuda).prepare(g)
    s = seeds.cpu().numpy()
    for width in (3, 5, 8, 3):
        batch = np.stack([s + i for i in range(width)])
        out = hb.solve(batch)
        assert out.total_distance[0] == want
    assert tmp.blocked_layout.builds == b0 + 2


def _lane_groups(B):
    """Lane groups of a blocked call with B lanes (1 for an (N,) input)."""
    return 1 if B is None else -(-B // max(1, tmp.blocked_stride(B)))


@pytest.mark.parametrize("src_block", [16, 4096, 2**20])
@pytest.mark.parametrize("B", [None, 1, 2, 5, 8, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_kernel_src_blocks(cuda, src_block, B, dtype):
    """Small, large and larger-than-N source blocks, over several slices
    (a budget of about 2048 vertices) and one (the default): equal to
    the plain version and to the plain fold over the same layout; one
    launch a (lane group, slice)."""
    R, K, N = 1537, 32, 20000
    t = _on(cuda, dtype, *lane_inputs(R, K, N, B, seed=src_block % 97 + (B or 0)))
    want = minplus_torch(*t)
    lanes = B is not None and B > 1
    for budget in (8 * max(src_block, 2048), None):
        layout = tmp.blocked_layout(t[0], t[1], N, src_block, lanes, budget=budget)
        n0 = (tmp.minplus_blocked_call.launches, tmp.minplus_blocked_call.lane_launches)
        got = tmp.minplus_blocked_call(*t, src_block=src_block, layout=layout)
        launches = _lane_groups(B) * len(layout.slices)
        assert tmp.minplus_blocked_call.launches == n0[0] + launches
        assert tmp.minplus_blocked_call.lane_launches == n0[1] + (0 if B is None else launches)
        _assert_triples_equal(want, got)
        _assert_triples_equal(want, minplus_blocked_torch(layout, t[2], t[3]))
    assert len(layout.slices) == 1


@pytest.mark.parametrize("B", [None, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_kernel_edge_shapes(cuda, B, dtype):
    """All-padding rows, a source slice with no runs, rows wider than two
    ring stages (read in place), tie-heavy and mixed-type inputs."""
    lanes = B is not None and B > 1
    # all-padding rows: the identity
    R, K, N = 203, 8, 64
    shape = (N,) if B is None else (B, N)
    z = (torch.zeros((R, K), dtype=torch.int32, device=cuda),
         torch.full((R, K), float("inf"), device=cuda).to(dtype),
         torch.zeros(shape, device=cuda).to(dtype), torch.zeros(shape, dtype=torch.int32,
                                                                  device=cuda))
    _assert_triples_equal(minplus_torch(*z), tmp.minplus_blocked_call(*z, src_block=16))
    # neighbors only in slices 0 and 2 of three: the middle slice has no runs
    nbr, wgt, dist, lab = lane_inputs(500, 16, 3000, B, seed=5)
    nbr = np.where(nbr < 1000, nbr, nbr % 1000 + 2000).astype(np.int32)
    t = _on(cuda, dtype, nbr, wgt, dist, lab)
    layout = tmp.blocked_layout(t[0], t[1], 3000, 1000, lanes, budget=8 * 1000)
    assert len(layout.slices) == 2
    _assert_triples_equal(minplus_torch(*t),
                          tmp.minplus_blocked_call(*t, src_block=1000, layout=layout))
    # rows too wide for two ring stages of eight runs
    t = _on(cuda, dtype, *lane_inputs(37, 2500, 4001, B, seed=2500))
    layout = tmp.blocked_layout(t[0], t[1], 4001, 512, lanes, budget=8 * 1024)
    _assert_triples_equal(minplus_torch(*t),
                          tmp.minplus_blocked_call(*t, src_block=512, layout=layout))
    # ties, and bf16 weights over f32 distances and back
    t = _on(cuda, dtype, *tie_inputs(1000, 32, 50, seed=3, B=B))
    _assert_triples_equal(minplus_torch(*t), tmp.minplus_blocked_call(*t, src_block=8))
    nbr, wgt, dist, lab = lane_inputs(500, 32, 2000, B, seed=9)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    t = (torch.from_numpy(nbr).to(cuda), torch.from_numpy(wgt).to(cuda, dtype),
         torch.from_numpy(dist).to(cuda, other), torch.from_numpy(lab).to(cuda))
    layout = tmp.blocked_layout(t[0], t[1], 2000, 128, lanes, budget=8 * 256)
    _assert_triples_equal(minplus_torch(*t),
                          tmp.minplus_blocked_call(*t, src_block=128, layout=layout))


def test_blocked_kernel_empty_and_foreign_layout(cuda):
    """R = 0 launches nothing; a layout built for other inputs raises."""
    t = _on(cuda, torch.float32, *ell_inputs(0, 4, 32, seed=0))
    n0 = tmp.minplus_blocked_call.launches
    m, ml, ms = tmp.minplus_blocked_call(*t, src_block=8)
    assert m.shape == (0,) and tmp.minplus_blocked_call.launches == n0
    t = _on(cuda, torch.float32, *ell_inputs(64, 4, 32, seed=0))
    layout = tmp.blocked_layout(t[0], t[1], 32, 8)
    with pytest.raises(ValueError, match="layout"):
        tmp.minplus_blocked_call(*t, src_block=16, layout=layout)
    with pytest.raises(ValueError, match="layout"):
        tmp.minplus_blocked_call(t[0], t[1], t[2][:16], t[3][:16], src_block=8, layout=layout)


@pytest.mark.parametrize("shape", [(1000,), (3, 5000), (1, 70000)])
@pytest.mark.parametrize("k", [1, 7, 512])
def test_smallest_k_on_card_matches_cpu(cuda, shape, k):
    """The top-K selection picks the same rows on the card as on the CPU:
    the k smallest, lower index first among ties (integer priorities, +inf,
    -0.0 and +0.0)."""
    from repro_torch.core.voronoi import smallest_k

    rng = np.random.default_rng(k)
    p = rng.integers(0, 4, shape).astype(np.float32)
    p[rng.random(shape) < 0.3] = np.inf
    p[rng.random(shape) < 0.05] = -0.0
    p = torch.from_numpy(p)
    want = torch.sort(smallest_k(p, k), dim=-1).values
    got = torch.sort(smallest_k(p.to(cuda), k), dim=-1).values
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("src_block", [None, 256])
def test_pallas_frontier_on_card_matches_cpu(cuda, src_block):
    """Scale 10: the top-K kernel schedule on the card equals the CPU's bit
    for bit, one launch a round (with src_block, a tile layout a round)."""
    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    seeds = select_seeds(n, src, dst, 16, strategy="uniform", seed=1000)
    out = {}
    for d in (cuda, "cpu"):
        g = from_edges(src, dst, w, n, pad_to=8, device=d)
        ell = SteinerSolver(SolverConfig(mode="pallas"), device=d).prepare(g).artifact("ell")
        n0 = (tmp.minplus_call.launches, tmp.minplus_blocked_call.launches,
              tmp.blocked_layout.builds)
        sd = torch.as_tensor(seeds, device=d)
        st, stats = tops.voronoi_cells_pallas_frontier(
            ell, sd, frontier_size=64, src_block=src_block, telemetry_rounds=300)
        grew = (tmp.minplus_call.launches - n0[0], tmp.minplus_blocked_call.launches - n0[1],
                tmp.blocked_layout.builds - n0[2])
        out[str(d)] = (st, stats, grew)
    (a, sa, grew), (b, sb, _) = out[str(cuda)], out["cpu"]
    rounds = int(sa.iterations)
    if src_block is None:
        assert grew == (rounds, 0, 0)
    else:
        assert grew[0] == 0 and grew[2] == rounds and grew[1] >= rounds
    for f in ("dist", "lab", "pred"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f))
    for f in ("iterations", "relaxations", "messages", "history"):
        assert torch.equal(getattr(sa, f).cpu(), getattr(sb, f))


def test_pallas_frontier_lanes_on_card_match_cpu_and_single(cuda):
    """Scale 10, a (5, 16) batch: the top-K lane loop launches the kernel once
    a round for all active lanes; every lane equals the card's single loop
    and the CPU's lane loop bit for bit."""
    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    rng = np.random.default_rng(2)
    seeds = np.stack([rng.choice(n, 16, replace=False) for _ in range(5)]).astype(np.int32)
    seeds[1, 8:] = seeds[1, 0]
    out = {}
    for d in (cuda, "cpu"):
        g = from_edges(src, dst, w, n, pad_to=8, device=d)
        ell = SteinerSolver(SolverConfig(mode="pallas"), device=d).prepare(g).artifact("ell")
        n0 = tmp.minplus_call.launches
        st, stats = tops.voronoi_cells_pallas_frontier_lanes(
            ell, torch.as_tensor(seeds, device=d), frontier_size=32, telemetry_rounds=300)
        out[str(d)] = (st, stats, tmp.minplus_call.launches - n0, ell)
    (a, sa, la, ell), (b, sb, _, _) = out[str(cuda)], out["cpu"]
    assert la == int(sa.iterations.max())
    for f in ("dist", "lab", "pred"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f))
    for f in ("iterations", "relaxations", "messages", "history"):
        assert torch.equal(getattr(sa, f).cpu(), getattr(sb, f))
    for lane in range(len(seeds)):
        one, ostats = tops.voronoi_cells_pallas_frontier(
            ell, torch.as_tensor(seeds[lane], device=cuda), frontier_size=32,
            telemetry_rounds=300)
        for f in ("dist", "lab", "pred"):
            assert torch.equal(getattr(one, f), getattr(a, f)[lane])
        for f in ("iterations", "relaxations", "messages", "history"):
            assert torch.equal(getattr(ostats, f), getattr(sa, f)[lane])


@pytest.mark.parametrize("mode", ["dense", "bucket", "frontier"])
def test_schedules_on_card_match_cpu(cuda, mode):
    """Scale 10: the COO and ELL schedules of the single backend give the
    same answer on the card as on the CPU, counters and telemetry included
    (the bucket width, an exact mean, is the same on both)."""
    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    w = (w / 7.0).astype(np.float32)  # non-integer weights: Δ's sum is inexact in f32
    seeds = select_seeds(n, src, dst, 16, strategy="uniform", seed=1000)
    cfg = SolverConfig(mode=mode, frontier_size=64)
    out = {}
    for d in (cuda, "cpu"):
        g = from_edges(src, dst, w, n, pad_to=8, device=d)
        out[str(d)] = SteinerSolver(cfg, device=d).prepare(g).solve(seeds)
    a, b = out[str(cuda)], out["cpu"]
    for f in ("dist", "lab", "pred"):
        assert torch.equal(getattr(a.raw.state, f).cpu(), getattr(b.raw.state, f))
    ta, tb = a.telemetry, b.telemetry
    assert (ta.iterations, ta.relaxations, ta.messages) == (tb.iterations, tb.relaxations,
                                                            tb.messages)
    assert (ta.per_round == tb.per_round).all()
    assert a.num_edges == b.num_edges


def test_default_server_on_card_matches_cpu(cuda):
    """SteinerServer(g) with the default ServeConfig() (mode "bucket") serves
    on the card, and equals the CPU server."""
    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    rng = np.random.default_rng(3)
    stream = [rng.choice(n, int(k), replace=False).tolist() for k in rng.integers(2, 30, 10)]
    stream += stream[:3]
    res = {}
    for d in (cuda, "cpu"):
        srv = SteinerServer(from_edges(src, dst, w, n, pad_to=8, device=d), device=d)
        res[str(d)] = [(r.total_distance, r.num_edges, r.from_cache)
                       for r in srv.query_many(stream)]
    assert res[str(cuda)] == res["cpu"]


def _mixed_records(rng, n, src, dst, k):
    """k random add/delete/reweight records (deletes and reweights hit base
    pairs)."""
    recs = []
    for _ in range(k):
        kind = int(rng.integers(0, 3))
        if kind == 0:
            u, v = (int(x) for x in rng.integers(0, n, size=2))
            recs.append(("add", u, v if u != v else (v + 1) % n, float(rng.integers(1, 50))))
        else:
            i = int(rng.integers(0, len(src)))
            u, v = int(src[i]), int(dst[i])
            recs.append(("delete", u, v) if kind == 1
                        else ("reweight", u, v, float(rng.integers(1, 50))))
    return recs


@pytest.mark.parametrize("src_block", [None, 256])
def test_store_prepared_pallas_on_card_matches_cpu(cuda, tmp_path, src_block):
    """Scale 10 from a store with ell_pad_rows=256 (spare all-+inf rows): the
    card's solve equals the CPU's and the in-memory graph's bit for bit; with
    src_block the layout describes the store's padded ELL, is built once in
    prepare and once more after refresh(), and one launch a round and slice
    runs on it."""
    from repro_torch.graphstore import ArraySource, build_store, open_store
    from repro_torch.solver.backends import blocked_layout_cached

    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    seeds = select_seeds(n, src, dst, 16, strategy="uniform", seed=1000)
    path, _ = build_store(ArraySource(src, dst, w, n), tmp_path / "g.gstore")
    cfg = SolverConfig(mode="pallas", ell_pad_rows=256, src_block=src_block)
    out = {}
    for d in (cuda, "cpu"):
        b0 = tmp.blocked_layout.builds
        h = SteinerSolver(cfg, device=d).prepare(open_store(path))
        built = tmp.blocked_layout.builds - b0
        n0 = (tmp.minplus_call.launches, tmp.minplus_blocked_call.launches)
        o = h.solve(seeds)
        grew = (tmp.minplus_call.launches - n0[0], tmp.minplus_blocked_call.launches - n0[1])
        out[str(d)] = (h, o, built, grew)
    (h, a, built, grew), (_, b, _, _) = out[str(cuda)], out["cpu"]
    ell = h.artifact("ell")
    assert ell.nbr.shape[0] % 256 == 0
    rounds = a.telemetry.iterations
    if src_block is None:
        assert (built, grew) == (0, (rounds, 0))
    else:
        layout = h.artifact("blocked_layout")
        assert built == 1 and layout.rows == ell.nbr.shape[0]
        assert blocked_layout_cached(ell, cfg) is layout
        assert grew == (0, rounds * len(layout.slices))
    mem = SteinerSolver(cfg, device=cuda).prepare(
        from_edges(src, dst, w, n, pad_to=8, device=cuda)).solve(seeds)
    for other in (b, mem):
        for f in ("dist", "lab", "pred"):
            assert torch.equal(getattr(a.raw.state, f).cpu(), getattr(other.raw.state, f).cpu())
        assert torch.equal(a.raw.parent.cpu(), other.raw.parent.cpu())
        assert (a.total_distance, a.num_edges) == (other.total_distance, other.num_edges)
    # after an epoch the layout is rebuilt from the refreshed ELL
    from repro_torch.delta import append_deltas

    append_deltas(path, _mixed_records(np.random.default_rng(0), n, src, dst, 20))
    b0 = tmp.blocked_layout.builds
    rep = h.refresh()
    assert rep["epoch"] == 1 and "ell" in rep["refreshed"]
    assert tmp.blocked_layout.builds - b0 == (0 if src_block is None else 1)
    fresh = SteinerSolver(cfg, device="cpu").prepare(open_store(path)).solve(seeds)
    again = h.solve(seeds)
    assert (again.total_distance, again.num_edges) == (fresh.total_distance, fresh.num_edges)
    assert torch.equal(again.raw.state.dist.cpu(), fresh.raw.state.dist)


@pytest.mark.parametrize("mst_algo", ["prim", "boruvka"])
def test_incremental_session_on_card_matches_cpu(cuda, tmp_path, mst_algo):
    """Scale 10, two epochs: the session on the card equals the CPU's (state,
    MST parent, pair tables, EpochResult) and a cold frontier solve."""
    import dataclasses

    from repro_torch.delta import IncrementalSession
    from repro_torch.graphstore import ArraySource, build_store, open_store

    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    seeds = select_seeds(n, src, dst, 16, strategy="uniform", seed=1000)
    sess = {}
    for d in (cuda, "cpu"):
        path, _ = build_store(ArraySource(src, dst, w, n), tmp_path / f"{d}.gstore")
        sess[str(d)] = IncrementalSession(open_store(path), seeds, ell_pad_rows=256,
                                          frontier_size=64, mst_algo=mst_algo, device=d)
    a, b = sess[str(cuda)], sess["cpu"]
    rng = np.random.default_rng(1)
    for _ in range(2):
        recs = _mixed_records(rng, n, src, dst, 30)
        ra, rb = a.apply_deltas(recs), b.apply_deltas(recs)
        assert dataclasses.asdict(ra) == dataclasses.asdict(rb)
        for f in ("dist", "lab", "pred"):
            assert torch.equal(getattr(a.state, f).cpu(), getattr(b.state, f))
        assert np.array_equal(a.parent, b.parent) and np.array_equal(a.dmat, b.dmat)
    cold = SteinerSolver(SolverConfig(mode="frontier", frontier_size=64, mst_algo=mst_algo),
                         device=cuda).prepare(a.store).solve(seeds)
    assert (cold.total_distance, cold.num_edges) == (ra.total_distance, ra.num_edges)
    assert np.array_equal(cold.raw.parent.cpu().numpy(), a.parent)


def test_boruvka_on_card_matches_cpu(cuda):
    """Borůvka's parent on the card equals the CPU's on random, tie-heavy
    and disconnected pair tables, and through the solver."""
    from repro_torch.core.mst import boruvka_dense

    rng = np.random.default_rng(0)
    for S in (2, 17, 64, 300):
        for kind in range(3):
            W = (rng.random((S, S)) if kind == 0 else rng.integers(1, 4, (S, S))).astype(np.float32)
            if kind == 2:
                W[rng.random((S, S)) < 0.9] = np.inf
            W = np.minimum(W, W.T)
            np.fill_diagonal(W, np.inf)
            want = boruvka_dense(torch.from_numpy(W))
            assert torch.equal(boruvka_dense(torch.from_numpy(W).to(cuda)).cpu(), want)
    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    seeds = select_seeds(n, src, dst, 64, strategy="uniform", seed=1000)
    out = {}
    for d in (cuda, "cpu"):
        g = from_edges(src, dst, w, n, pad_to=8, device=d)
        out[str(d)] = SteinerSolver(SolverConfig(mode="pallas", mst_algo="boruvka"),
                                    device=d).prepare(g).solve(seeds)
    a, b = out[str(cuda)], out["cpu"]
    assert torch.equal(a.raw.parent.cpu(), b.raw.parent)
    assert (a.total_distance, a.num_edges) == (b.total_distance, b.num_edges)


MESH_CARD_RUNS = [
    dict(backend="mesh1d", mode="bucket"),
    dict(backend="mesh1d", mode="dense", local_steps=2, pair_chunks=3),
    dict(backend="mesh1d", mode="frontier", frontier_size=64),
    dict(backend="mesh1d", mode="bucket", lab_i16=True, mst_algo="boruvka"),
    dict(backend="mesh1d", mode="bucket", fuse_gather=False, telemetry_per_rank=True),
    dict(backend="mesh2d", mode="bucket", telemetry_per_rank=True),
]
MESH_FIELDS = ("dist", "lab", "pred", "marked", "path_edge", "bridge_u", "bridge_v",
               "bridge_w", "bridge_valid", "total_distance", "num_edges", "iterations",
               "relaxations", "messages", "history", "per_rank")


@pytest.mark.parametrize("kw", MESH_CARD_RUNS,
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_mesh_on_card_matches_cpu(cuda, kw):
    """Scale 10 at mesh (1, 1): the card's rank (its collectives through
    NCCL) equals the CPU's (gloo) bit for bit, counters, telemetry and
    per-rank rows included, on non-integer weights."""
    from repro_torch.core.mesh import backend_name

    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    w = (w / 7.0).astype(np.float32)
    seeds = select_seeds(n, src, dst, 16, strategy="uniform", seed=1000)
    cfg = SolverConfig(**kw)
    out = {}
    for d in (cuda, "cpu"):
        h = SteinerSolver(cfg, device=d).prepare(from_edges(src, dst, w, n, pad_to=8, device=d))
        assert h.artifact("edges")[0].device.type == torch.device(d).type
        out[str(d)] = h.solve(seeds)
    assert backend_name("cuda") == "nccl" and backend_name("cpu") == "gloo"
    a, b = out[str(cuda)].raw, out["cpu"].raw
    for f in MESH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f)
    assert out[str(cuda)].telemetry.per_round.shape == out["cpu"].telemetry.per_round.shape


def _same_solve(a, b):
    """Two SolveOutputs bit for bit: state, MST, tree, counters, rows."""
    for f in ("dist", "lab", "pred"):
        assert torch.equal(getattr(a.raw.state, f).cpu(), getattr(b.raw.state, f).cpu()), f
    assert torch.equal(a.raw.parent.cpu(), b.raw.parent.cpu())
    for f in ("in_tree_vertex", "path_edge", "bridge_u", "bridge_v", "bridge_w"):
        assert torch.equal(getattr(a.raw.tree, f).cpu(), getattr(b.raw.tree, f).cpu()), f
    np.testing.assert_array_equal(np.asarray(a.total_distance), np.asarray(b.total_distance))
    np.testing.assert_array_equal(np.asarray(a.num_edges), np.asarray(b.num_edges))
    ta, tb = a.telemetry, b.telemetry
    assert (ta.iterations, ta.relaxations, ta.messages) == (tb.iterations, tb.relaxations,
                                                           tb.messages)
    np.testing.assert_array_equal(ta.per_round, tb.per_round)


@pytest.fixture
def traced():
    from repro_torch import obs

    obs.reset()
    yield obs
    obs.reset()


def test_traced_pallas_solve_on_card_equals_untraced(cuda, traced):
    """Scale 10, mode "pallas" on the card: a solve with obs on equals the
    same handle's solve with obs off bit for bit, with as many kernel
    launches (one a round); the trace validates and holds the solve, its
    synthetic round spans and its messages counter."""
    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    seeds = select_seeds(n, src, dst, 16, strategy="uniform", seed=1000)
    g = from_edges(src, dst, w, n, pad_to=8, device=cuda)
    h = SteinerSolver(SolverConfig(mode="pallas"), device=cuda).prepare(g)
    h.solve(seeds)
    runs = []
    for on in (False, True):
        if on:
            traced.enable()
            h = SteinerSolver(SolverConfig(mode="pallas"), device=cuda).prepare(g)
        n0 = tmp.minplus_call.launches
        out = h.solve(seeds)
        runs.append((out, tmp.minplus_call.launches - n0))
    (off, l_off), (on, l_on) = runs
    _same_solve(off, on)
    assert l_off == l_on == on.telemetry.iterations
    doc = traced.tracer().chrome_trace()
    names = [e["name"] for e in doc["traceEvents"]]
    assert traced.validate_chrome_trace(doc) == len(names) - 1
    assert {"prepare", "prepare:ell_build", "solve"} <= set(names)
    assert names.count("round[single/pallas]") == on.telemetry.iterations
    samples = traced.parse_prometheus(traced.prometheus_text())
    assert samples['solver_messages_total{backend="single",mode="pallas"}'] == \
        on.telemetry.messages


def test_traced_served_batch_on_card_equals_untraced(cuda, traced):
    """Scale 10, a batch of distinct keys through a pallas server, untraced
    then traced: the same answers with as many lane-kernel launches, and the
    four serve spans recorded."""
    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    g = from_edges(src, dst, w, n, pad_to=8, device=cuda)
    rng = np.random.default_rng(3)
    keys = [rng.choice(n, size=12, replace=False).tolist() for _ in range(8)]
    runs = []
    for on in (False, True):
        if on:
            traced.enable()
        srv = SteinerServer(g, ServeConfig(mode="pallas", buckets=(16,), max_batch=8),
                            device=cuda)
        n0 = tmp.minplus_call.launches
        res = srv.query_many(keys)
        runs.append(([(r.total_distance, r.num_edges) for r in res],
                     tmp.minplus_call.launches - n0))
    assert runs[0] == runs[1] and runs[0][1] > 0
    names = {e["name"] for e in traced.tracer().events()}
    assert {"serve:assemble", "serve:queue_wait", "serve:solve", "serve:stash"} <= names


def test_compacted_store_on_card_solves_like_overlay(cuda, tmp_path):
    """Scale 10 with two delta segments: the overlay store and its compacted
    copy, prepared on the card with the same ell_pad_rows, solve bit for bit
    alike (and like the CPU's solve of the compacted store)."""
    import shutil

    from repro_torch.delta import append_deltas, compact
    from repro_torch.graphstore import ArraySource, build_store, open_store

    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    seeds = select_seeds(n, src, dst, 16, strategy="uniform", seed=1000)
    path, _ = build_store(ArraySource(src, dst, w, n), tmp_path / "g.gstore")
    rng = np.random.default_rng(2)
    for k in (40, 25):
        append_deltas(path, _mixed_records(rng, n, src, dst, k))
    cpath = tmp_path / "c.gstore"
    shutil.copytree(path, cpath)
    stats = compact(cpath, verify=True)
    assert stats.records_folded == 65 and stats.epoch == 2
    cfg = SolverConfig(mode="pallas", ell_pad_rows=256)
    overlay = SteinerSolver(cfg, device=cuda).prepare(open_store(path)).solve(seeds)
    compacted = SteinerSolver(cfg, device=cuda).prepare(open_store(cpath)).solve(seeds)
    cpu = SteinerSolver(cfg, device="cpu").prepare(open_store(cpath)).solve(seeds)
    _same_solve(overlay, compacted)
    _same_solve(compacted, cpu)


# ---- the LM stack of the trainer on the card (plain PyTorch: no kernel of
# the package runs on this path)

LM_CARD_ARCHS = ("starcoder2-3b", "deepseek-v3-671b")  # dense; MoE with MLA


def _lm_on_both(cuda, arch):
    """A reduced LM config's f32 variant, the same seeded weights on the CPU
    and on the card, and a token batch."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_arch(arch).reduced, dtype="float32")
    cpu = tf.init_params(cfg, torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to(cuda, copy=True), cpu)
    tok = torch.from_numpy(TokenStream(cfg.vocab, 4, 32, seed=2).batch_at(0))
    return cfg, cpu, card, tok


def _close(got, want, atol_frac):
    """|got - want| <= atol_frac·max|want| + 1e-5·|want| (f32 rounding of two
    devices' summation orders; the CPU parity tests' tolerances)."""
    got, want = got.float().cpu(), want.float().cpu()
    tol = atol_frac * float(want.abs().max()) + 1e-5 * want.abs()
    assert bool(((got - want).abs() <= tol).all()), float((got - want).abs().max())


@pytest.mark.parametrize("arch", LM_CARD_ARCHS)
def test_lm_train_step_on_card_matches_cpu(cuda, arch):
    """One AdamW train step of a reduced config (f32) on the card and on the
    CPU: the same loss, gradients and first moments (m = 0.1·g after one
    step); the weights after the step are not compared elementwise (a
    near-zero gradient's sign decides its ±lr move)."""
    from repro_torch.models import transformer as tf
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.tree import tree_leaves

    cfg, cpu, card, tok = _lm_on_both(cuda, arch)
    lc, gc = tf.loss_and_grads(cfg, cpu, tok)
    ld, gd = tf.loss_and_grads(cfg, card, tok.to(cuda))
    assert gd["embed"].device.type == cuda.type
    np.testing.assert_allclose(float(ld), float(lc), rtol=1e-5)
    for a, b in zip(tree_leaves(gd), tree_leaves(gc)):
        _close(a, b, 2e-4)
    opt = OptConfig(lr=1e-3)
    sc, sd = adamw_init(cpu, opt), adamw_init(card, opt)
    _, sc, lc = tf.make_train_step(cfg, opt)(cpu, sc, tok)
    _, sd, ld = tf.make_train_step(cfg, opt)(card, sd, tok.to(cuda))
    np.testing.assert_allclose(float(ld), float(lc), rtol=1e-5)
    for a, b in zip(tree_leaves(sd["mu"]), tree_leaves(sc["mu"])):
        _close(a, b, 2e-4)


@pytest.mark.parametrize("arch", LM_CARD_ARCHS)
def test_lm_decode_on_card_matches_cpu(cuda, arch):
    from repro_torch.models import transformer as tf

    cfg, cpu, card, tok = _lm_on_both(cuda, arch)
    caches = [tf.init_caches(cfg, 2, 16, device=d) for d in ("cpu", cuda)]
    step = tf.make_decode_step(cfg)
    for i in range(2):
        t = tok[:2, i].contiguous()
        lc, caches[0] = step(cpu, caches[0], t, i)
        ld, caches[1] = step(card, caches[1], t.to(cuda), i)
        assert ld.device.type == cuda.type and ld.shape == (2, cfg.vocab_padded)
        _close(ld, lc, 5e-5)


def test_lm_checkpoint_round_trip_from_the_card(cuda, tmp_path):
    """Params (bf16) and AdamW state of a reduced config saved from the card
    restore bit for bit, onto the card and onto the CPU."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_arch("granite-moe-1b-a400m").reduced
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(3))
    state = {"params": params, "opt": adamw_init(params, OptConfig(quantized=True))}
    tok = torch.randint(0, cfg.vocab, (2, 16), device=cuda)
    tf.make_train_step(cfg, OptConfig(quantized=True))(params, state["opt"], tok)
    mgr = CheckpointManager(tmp_path)
    mgr.save(0, state, blocking=True)
    for device in (None, "cpu"):
        template = tree_map(torch.zeros_like, state["params"])
        step, back = mgr.restore({"params": template, "opt": adamw_init(
            template, OptConfig(quantized=True))}, device=device)
        assert step == 0
        want = [t for leaf in tree_leaves(state) for t in _q8_fields(leaf)]
        got = [t for leaf in tree_leaves(back) for t in _q8_fields(leaf)]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            assert a.device.type == (cuda.type if device is None else "cpu")
            assert torch.equal(a.cpu(), b.cpu())


def _q8_fields(leaf):
    """A tensor, or an 8-bit state's payload and scales."""
    return [leaf.q, leaf.scale] if hasattr(leaf, "scale") else [leaf]


# ---- the GNN family and MIND on the card (plain PyTorch: the card's
# index_add sums a row in atomic order, so card and CPU agree within f32
# rounding, as tests/test_torch_gnn.py states)

GNN_CARD_CELLS = [("graphsage-reddit", "gnn_full"), ("graphsage-reddit", "gnn_sampled"),
                  ("gatedgcn", "gnn_full"), ("schnet", "gnn_full"), ("schnet", "gnn_batched"),
                  ("graphcast", "gnn_full")]


def _gnn_inputs(cfg, kind, gen):
    """A small batch of a GNN cell (24 nodes, 80 edges, 16 features), on the CPU."""
    N, E, F = 24, 80, 16

    def randn(*s):
        return torch.randn(s, generator=gen)

    def randint(hi, *s):
        return torch.randint(0, hi, s, generator=gen, dtype=torch.int32)

    if kind == "gnn_sampled":
        return {"feats": (randn(8, F), randn(24, F), randn(48, F)),
                "labels": randint(cfg.n_classes, 8)}
    if kind == "gnn_batched":
        return {"z": randn(4, N, F), "pos": randn(4, N, 3), "edges_t": randint(N, E, 2),
                "energy": randn(4)}
    if cfg.kind == "schnet":
        return {"x": randn(N, F), "pos": randn(N, 3), "edges": randint(N, E, 2),
                "energy_sum": torch.ones(())}
    if cfg.kind == "graphcast":
        nm = N // 4 + 1
        return {"x": randn(N, F), "g2m": torch.stack([randint(N, E), randint(nm, E)], 1),
                "mesh_e": randint(nm, 56, 2), "m2g": torch.stack([randint(nm, E), randint(N, E)], 1),
                "target": randn(N, cfg.n_vars)}
    batch = {"x": randn(N, F), "edges": randint(N, E, 2), "labels": randint(cfg.n_classes, N)}
    if cfg.kind == "gatedgcn":
        batch["ew"] = torch.rand(E, generator=gen)
    return batch


@pytest.mark.parametrize("arch,kind", GNN_CARD_CELLS)
def test_gnn_train_step_on_card_matches_cpu(cuda, arch, kind):
    """One AdamW step of a reduced GNN config on the card and on the CPU: the
    same loss, gradients and first moments."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import gnn
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_arch(arch).reduced
    shape = ShapeSpec(name="small", kind=kind)
    gen = torch.Generator().manual_seed(0)
    cpu = gnn.init_params(cfg, 16, gen)
    batch = _gnn_inputs(cfg, kind, gen)
    card = tree_map(lambda t: t.to(cuda, copy=True), cpu)
    bcard = {k: tuple(x.to(cuda) for x in v) if isinstance(v, tuple) else v.to(cuda)
             for k, v in batch.items()}
    lc, gc = gnn.loss_and_grads(cfg, shape, cpu, batch)
    ld, gd = gnn.loss_and_grads(cfg, shape, card, bcard)
    np.testing.assert_allclose(float(ld), float(lc), rtol=1e-5)
    for a, b in zip(tree_leaves(gd), tree_leaves(gc)):
        assert a.device.type == cuda.type
        _close(a, b, 2e-4)
    opt = OptConfig(lr=1e-3)
    sc, sd = adamw_init(cpu, opt), adamw_init(card, opt)
    _, sc, lc = gnn.make_train_step(cfg, shape, opt)(cpu, sc, batch)
    _, sd, ld = gnn.make_train_step(cfg, shape, opt)(card, sd, bcard)
    np.testing.assert_allclose(float(ld), float(lc), rtol=1e-5)
    for a, b in zip(tree_leaves(sd["mu"]), tree_leaves(sc["mu"])):
        _close(a, b, 2e-4)


def test_mind_step_and_scores_on_card_match_cpu(cuda):
    """Reduced MIND on the card and on the CPU: a train step's loss and
    gradients (at the scale of the largest gradient), the serve and
    retrieval scores; an out-of-range id raises on the card too."""
    from repro_torch.configs import get_arch
    from repro_torch.data.recsys import BehaviorStream
    from repro_torch.models import recsys

    cfg = get_arch("mind").reduced
    cpu = recsys.init_params(cfg, torch.Generator().manual_seed(0))
    card = {k: v.to(cuda, copy=True) for k, v in cpu.items()}
    b = {k: torch.from_numpy(v) for k, v in
         BehaviorStream(cfg.n_items, cfg.hist_len, 16, seed=0).batch_at(0).items()}
    bd = {k: v.to(cuda) for k, v in b.items()}
    lc, gc = recsys.loss_and_grads(cfg, cpu, b)
    ld, gd = recsys.loss_and_grads(cfg, card, bd)
    np.testing.assert_allclose(float(ld), float(lc), rtol=1e-5)
    scale = max(float(g.abs().max()) for g in gc.values())
    for k in gc:
        got, want = gd[k].cpu(), gc[k]
        assert bool(((got - want).abs() <= 2e-4 * scale + 1e-5 * want.abs()).all()), k
    cand = torch.randint(0, cfg.n_items, (16, 32), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    _close(recsys.serve_scores(cfg, card, dict(bd, cand_ids=cand.to(cuda))),
           recsys.serve_scores(cfg, cpu, dict(b, cand_ids=cand)), 1e-5)
    one = {k: v[:1] for k, v in b.items()}
    _close(recsys.retrieval_scores(cfg, card, {**{k: v.to(cuda) for k, v in one.items()},
                                               "cand_ids": cand.reshape(-1).to(cuda)}),
           recsys.retrieval_scores(cfg, cpu, dict(one, cand_ids=cand.reshape(-1))), 1e-5)
    bad = cand.clone()
    bad[0, 0] = cfg.n_items
    with pytest.raises(IndexError):
        recsys.serve_scores(cfg, card, dict(bd, cand_ids=bad.to(cuda)))


# ---------------------------------------------------------------------------
# distributed/: int8 compression and a sharded step on one NCCL rank
# ---------------------------------------------------------------------------


def test_compress_tree_on_card_is_bit_identical_to_cpu(cuda):
    """q, scales and residuals of f32 and bf16 leaves, sizes off QBLOCK."""
    from repro_torch.distributed.compression import compress_tree

    gen = torch.Generator().manual_seed(5)
    grads = {f"g{i}": torch.randn(n, generator=gen) * 10 ** (i - 2)
             for i, n in enumerate((1, 255, 257, 4099, 100_003))}
    grads["h"] = torch.randn(3, 517, generator=gen).bfloat16()
    err = {k: torch.randn(v.shape, generator=gen) * 1e-3 for k, v in grads.items()}
    qc, ec = compress_tree(grads, err)
    qd, ed = compress_tree({k: v.to(cuda) for k, v in grads.items()},
                           {k: v.to(cuda) for k, v in err.items()})
    for k in grads:
        assert torch.equal(qd[k][0].cpu(), qc[k][0]), k
        assert torch.equal(qd[k][1].cpu(), qc[k][1]), k
        assert torch.equal(ed[k].cpu(), ec[k]), k


@pytest.mark.parametrize("family", ["starcoder2", "starcoder2_h3", "granite_moe",
                                    "granite_accum", "deepseek_q8", "sage_full", "gatedgcn",
                                    "schnet_mol", "schnet_graph", "graphcast", "mind"])
def test_sharded_step_on_one_nccl_rank_matches_unsharded(cuda, family):
    """Two steps of a reduced config on a (1, 1) mesh (one NCCL rank:
    parameters by ``param_specs``, moments by ``opt_state_specs``, inputs by
    ``input_specs``) against the unsharded steps on the card, within
    tests/test_torch_sharded_steps.py's tolerances (the card's scatter-adds
    sum in atomic order, so not always bit for bit)."""
    from _torch_sharded_cases import check_records, port_run
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh((1, 1), ("data", "model"), device="cuda")
    assert mesh.device_type == "cuda"
    check_records(port_run(family, mesh, ("data",)), port_run(family, device=cuda), family)


@pytest.mark.parametrize("case", ["prefill_granite", "decode_starcoder2", "decode_starcoder2_bf16",
                                  "decode_kv1", "decode_qwen_int8", "decode_qwen_int8_kv1",
                                  "decode_deepseek", "mind_serve", "mind_retrieval"])
def test_sharded_serving_on_one_nccl_rank_matches_plain(cuda, case):
    """Prefill, decode against DTensor caches and MIND's scores on a (1, 1)
    mesh of one NCCL rank against the plain path on the card, within
    tests/test_torch_sharded_serve.py's tolerances."""
    from _torch_sharded_cases import check_serve, port_serve
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh((1, 1), ("data", "model"), device="cuda")
    check_serve(port_serve(case, mesh, ("data",)), port_serve(case, device=cuda), case)


# ----------------------------------------------------------------------------
# the runtime sanitizer on the card (repro_torch.analysis.sanitize)
# ----------------------------------------------------------------------------


def _sanitized_solves(dev, cfg, seeds, scale=12):
    """A warm solve under ``sanitizer()`` beside the unguarded one, on
    ``dev``: (unguarded, guarded, report)."""
    from repro_torch.analysis.sanitize import sanitizer

    src, dst, w, n = rmat_edges(scale, 8, max_weight=100, seed=0)
    h = SteinerSolver(cfg, device=dev).prepare(from_edges(src, dst, w, n, pad_to=8, device=dev))
    plain = h.solve(seeds)
    with sanitizer(device=dev) as rep:
        out = h.solve(seeds)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
    return plain, out, rep


@pytest.mark.parametrize("backend,frontier", [("single", False), ("single", True),
                                              ("batch", False)])
def test_sanitized_pallas_solve_on_card_counts_like_cpu(cuda, backend, frontier):
    """Guarded = unguarded bit for bit, no rebuild, the dispatch mode's
    count equal to the function mode's on the card, and the card's host
    reads equal the CPU's, kind by kind."""
    src, dst, w, n = rmat_edges(12, 8, max_weight=100, seed=0)
    seeds = select_seeds(n, src, dst, 32, strategy="uniform", seed=1000)
    if backend == "batch":
        seeds = np.stack([seeds, select_seeds(n, src, dst, 32, strategy="uniform", seed=7)])
    cfg = SolverConfig(backend=backend, mode="pallas", pallas_frontier=frontier,
                       frontier_size=256)
    plain, out, rep = _sanitized_solves(cuda, cfg, seeds)
    for part in ("state", "tree"):
        a, b = getattr(plain.raw, part), getattr(out.raw, part)
        for f in a.__dataclass_fields__:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert rep.rebuilds == 0 and rep.sync_warnings is not None
    assert rep.dispatch_reads == rep.host_reads
    _, cpu_out, cpu_rep = _sanitized_solves("cpu", cfg, seeds)
    assert cpu_out.telemetry.iterations == out.telemetry.iterations
    assert (cpu_rep.host_reads, cpu_rep.reads_by_kind) == (rep.host_reads, rep.reads_by_kind)


def test_h2d_guard_counts_copies_onto_the_card(cuda):
    from repro_torch.analysis.sanitize import TraceSafetyError, h2d_guard

    host = torch.arange(4)
    with h2d_guard() as rep:
        on = host.to(cuda)
        torch.empty(4, dtype=host.dtype, device=cuda).copy_(host)
        on + 1  # on the card already: no copy
    assert rep.h2d == 2
    with pytest.raises(TraceSafetyError, match="host-to-device"):
        with h2d_guard(allow=0):
            host.to(cuda)


def test_host_reads_on_card_count_like_cpu(cuda):
    from repro_torch.analysis.sanitize import host_read_guard

    def reads(x):
        with host_read_guard() as rep:
            x.sum().item()
            x.tolist()
            x.cpu().numpy()
            bool(x[0] > 0)
            x[x > 2]
            torch.nonzero(x)
        return rep

    card, host = reads(torch.arange(6.0, device=cuda)), reads(torch.arange(6.0))
    assert card.reads_by_kind == host.reads_by_kind and card.host_reads == 6
    assert card.dispatch_reads == card.host_reads > host.dispatch_reads


# ---- the perf-regression gate (repro_torch.obs.regress) on the card


def test_pinned_pallas_solve_on_card_equals_cpu(cuda):
    """The gate's pinned pallas solve (RMAT scale 8, 8 seeds, ell_width=16)
    on the card is the CPU's bit for bit, one kernel launch a round."""
    from repro_torch.obs import regress

    out, launched = {}, {}
    for d in (cuda, "cpu"):
        g, n = regress._rmat_graph(regress.STEINER_SCALE, device=d)
        h = SteinerSolver(regress.steiner_config("pallas"), device=d).prepare(g)
        n0 = tmp.minplus_call.launches
        out[str(d)] = h.solve(regress.pinned_seeds(n))
        launched[str(d)] = tmp.minplus_call.launches - n0
    _same_solve(out[str(cuda)], out["cpu"])
    assert launched == {str(cuda): out["cpu"].telemetry.iterations, "cpu": 0}


def test_env_stamp_on_card_names_the_device(cuda):
    import shutil

    from repro_torch.obs import regress

    stamp = regress.env_stamp()
    assert stamp["device"] == torch.cuda.get_device_name(0)
    assert stamp["torch"] == torch.__version__ and stamp["cuda"] == torch.version.cuda
    assert "jax" not in stamp
    if shutil.which("nvidia-smi"):
        assert stamp["power_limit"].endswith(" W")
    assert regress.env_stamp("cpu")["device"] == "cpu"


def test_steiner_bench_group_on_card(cuda):
    """run_bench's steiner group on the card: its four metrics, and the
    deterministic message count equal to the CPU's."""
    from repro_torch.obs import regress

    res = {r.metric: r for r in regress.run_bench(["steiner"], k=1, quick=True)}
    assert sorted(res) == sorted(m for m in regress.METRIC_POLICY if m.startswith("steiner"))
    for m in ("bucket", "frontier", "pallas"):
        assert res[f"steiner_warm_ms_{m}"].value > 0
    assert res["steiner_frontier_messages"].value == regress.pinned_frontier_messages("cpu")
