"""Min-plus kernels of ``repro_torch`` against the Pallas kernels of ``repro``.

On the CPU the wrappers run their plain PyTorch version; it is held bit for
bit against the JAX kernels run in interpret mode (as tests/test_kernels.py
runs them) and against ``minplus_ref``.  The CUDA kernels themselves are held
against the plain version on the card in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.minplus.minplus as jmp
import repro.kernels.minplus.ops as jops
from repro.core.voronoi import VoronoiState as JState
from repro.kernels.minplus.ref import minplus_ref
from _minplus_inputs import ell_inputs as _ell_inputs
from _minplus_inputs import lane_inputs
from _torch_parity import assert_same, both_graphs, instance
from repro.core.graph import to_ell as jto_ell
from repro_torch.core.graph import to_ell as tto_ell
from repro_torch.core.voronoi import VoronoiState as TState
from repro_torch.kernels.minplus import minplus as tmp
from repro_torch.kernels.minplus import ops as tops
from repro_torch.kernels.minplus.ref import minplus_blocked_torch, minplus_torch

IMAX = np.iinfo(np.int32).max
_TDTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
_JDTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _both(nbr, wgt, dist, lab, dtype):
    j = (jnp.asarray(nbr), jnp.asarray(wgt, _JDTYPES[dtype]),
         jnp.asarray(dist, _JDTYPES[dtype]), jnp.asarray(lab))
    t = (torch.from_numpy(nbr), torch.from_numpy(wgt).to(_TDTYPES[dtype]),
         torch.from_numpy(dist).to(_TDTYPES[dtype]), torch.from_numpy(lab))
    return j, t


def _triples_equal(a, b):
    for x, y in zip(a, b):
        assert_same(x, y)


@pytest.mark.parametrize("shape", [(128, 4, 64), (256, 8, 300), (512, 16, 1024), (128, 32, 4096)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_minplus_resident_sweep(shape, dtype):
    R, K, N = shape
    j, t = _both(*_ell_inputs(R, K, N, seed=R + K), dtype)
    out = tmp.minplus_call(*t, block_rows=min(128, R))
    _triples_equal(jmp.minplus_call(*j, block_rows=min(128, R), interpret=True), out)
    _triples_equal(minplus_ref(*j), out)


@pytest.mark.parametrize("shape", [(128, 8, 256, 64), (256, 4, 512, 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_minplus_blocked_sweep(shape, dtype):
    R, K, N, SB = shape
    j, t = _both(*_ell_inputs(R, K, N, seed=N), dtype)
    out = tmp.minplus_blocked_call(*t, block_rows=min(128, R), src_block=SB)
    _triples_equal(
        jmp.minplus_blocked_call(*j, block_rows=min(128, R), src_block=SB, interpret=True),
        out,
    )


def test_minplus_empty_rows():
    """Rows whose every lane is +inf padding return the identity triple."""
    R, K, N = 128, 8, 64
    m, ml, ms = tmp.minplus_call(
        torch.zeros((R, K), dtype=torch.int32),
        torch.full((R, K), float("inf")),
        torch.zeros(N),
        torch.zeros(N, dtype=torch.int32),
    )
    assert torch.isinf(m).all()
    assert (ml == IMAX).all() and (ms == IMAX).all()


def test_cpu_tensors_take_plain_path_without_launch():
    nbr, wgt, dist, lab = _ell_inputs(64, 8, 100, seed=3)
    _, t = _both(nbr, wgt, dist, lab, "f32")
    before = (tmp.minplus_call.launches, tmp.minplus_blocked_call.launches)
    _triples_equal(minplus_torch(*t), tmp.minplus_call(*t, block_rows=7))
    _triples_equal(minplus_torch(*t), tmp.minplus_blocked_call(*t, src_block=33))
    assert (tmp.minplus_call.launches, tmp.minplus_blocked_call.launches) == before


def test_wrappers_reject_bad_inputs():
    _, (nbr, wgt, dist, lab) = _both(*_ell_inputs(16, 4, 32, seed=1), "f32")
    with pytest.raises(ValueError, match="nbr"):
        tmp.minplus_call(nbr.long(), wgt, dist, lab)
    with pytest.raises(ValueError, match="wgt"):
        tmp.minplus_call(nbr, wgt[:, :2], dist, lab)
    with pytest.raises(ValueError, match="dist"):
        tmp.minplus_call(nbr, wgt, dist.double(), lab)
    with pytest.raises(ValueError, match="lab"):
        tmp.minplus_call(nbr, wgt, dist, lab[:-1])
    with pytest.raises(ValueError, match="block_rows"):
        tmp.minplus_call(nbr, wgt, dist, lab, block_rows=0)
    with pytest.raises(ValueError, match="src_block"):
        tmp.minplus_blocked_call(nbr, wgt, dist, lab, src_block=0)


def _records_unpacked(rec, lanes):
    """(dist f32, lab) as (lanes, N), unpacked from a record table."""
    d = rec[..., 0].contiguous().view(torch.float32)[:, :lanes].t()
    return d, rec[..., 1][:, :lanes].t()


@pytest.mark.parametrize("B", [None, 1, 2, 3, 8, 9])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pack_records_roundtrip(B, dtype):
    """The resident kernels' records, unpacked in plain torch, are the
    inputs (bf16 upcast to f32), lane-minor with an even stride for B > 1."""
    N = 300
    rng = np.random.default_rng(7 if B is None else B)
    shape = (N,) if B is None else (B, N)
    dist = np.where(rng.random(shape) < 0.3, np.inf, rng.uniform(0, 50, shape))
    lab = rng.integers(0, 10**6, shape).astype(np.int32)
    d = torch.from_numpy(dist.astype(np.float32)).to(_TDTYPES[dtype])
    lab_t = torch.from_numpy(lab)
    rec = tmp.pack_records(d, lab_t)
    lanes = 1 if B is None else B
    stride = tmp.record_stride(d)
    assert stride == (1 if lanes == 1 else lanes + lanes % 2)
    assert rec.dtype == torch.int32 and rec.is_contiguous()
    assert tuple(rec.shape) == (N, stride, 2)
    got_d, got_l = _records_unpacked(rec, lanes)
    want_d = d.to(torch.float32).reshape(lanes, N)
    assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
    assert torch.equal(got_l, lab_t.reshape(lanes, N))
    # vertex u, lane b sits at flat record u * stride + b
    flat = rec.reshape(-1, 2)
    u, b = N - 1, lanes - 1
    assert int(flat[u * stride + b, 1]) == int(lab_t.reshape(lanes, N)[b, u])


@pytest.mark.parametrize("B", [3, 5, 17])
def test_pack_records_pads_odd_lanes(B):
    """An odd B pads each vertex's records to B + 1 lanes with (+inf, IMAX),
    so every vertex starts on 16 bytes."""
    N = 40
    d = torch.arange(B * N, dtype=torch.float32).reshape(B, N)
    lab = torch.arange(B * N, dtype=torch.int32).reshape(B, N)
    rec = tmp.pack_records(d, lab)
    assert tuple(rec.shape) == (N, B + 1, 2)
    pad = rec[:, B]
    assert torch.isinf(pad[:, 0].contiguous().view(torch.float32)).all()
    assert (pad[:, 1] == IMAX).all()
    got_d, got_l = _records_unpacked(rec, B)
    assert torch.equal(got_d, d) and torch.equal(got_l, lab)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pack_records_keeps_inf(dtype):
    """Unreached vertices (+inf) keep the f32 +inf bits in their records."""
    d = torch.full((2, 16), float("inf")).to(_TDTYPES[dtype])
    d[1, ::2] = 0.0
    rec = tmp.pack_records(d, torch.zeros((2, 16), dtype=torch.int32))
    bits = rec[..., 0]
    assert (bits[:, 0] == 0x7F800000).all()
    assert (bits[::2, 1] == 0).all() and (bits[1::2, 1] == 0x7F800000).all()
    one = tmp.pack_records(d[0], torch.zeros(16, dtype=torch.int32))
    assert tuple(one.shape) == (16, 1, 2) and (one[:, 0, 0] == 0x7F800000).all()


def test_cap_clamps_to_int32():
    big_default = 4 * 2**30 + 64
    assert tops._cap(None, big_default) == 2**31 - 2 == int(jops._cap(None, big_default))
    assert tops._cap(7, big_default) == 7
    assert tops._cap(None, 100) == 100


def _mid_state(n, seed):
    """A partially relaxed state: some vertices reached, with ties."""
    rng = np.random.default_rng(seed)
    dist = np.where(rng.random(n) < 0.6, rng.integers(0, 6, n), np.inf).astype(np.float32)
    lab = np.where(np.isfinite(dist), rng.integers(0, 3, n), 3).astype(np.int32)
    pred = np.arange(n, dtype=np.int32)
    return dist, lab, pred


@pytest.mark.parametrize("trial", [0, 1, 2])
@pytest.mark.parametrize("src_block", [None, 16])
def test_relax_ell_matches(trial, src_block):
    src, dst, w, n, _ = instance(trial)
    jg, tg = both_graphs(src, dst, w, n)
    je, te = jto_ell(jg, 4), tto_ell(tg, 4)
    dist, lab, pred = _mid_state(n, seed=trial)
    jnew, jupd = jops.relax_ell(
        je, JState(jnp.asarray(dist), jnp.asarray(lab), jnp.asarray(pred)),
        block_rows=16, src_block=src_block, interpret=True,
    )
    tst = TState(torch.from_numpy(dist), torch.from_numpy(lab), torch.from_numpy(pred))
    tnew, tupd = tops.relax_ell(te, tst, block_rows=16, src_block=src_block)
    assert_same(jupd, tupd)
    for f in ("dist", "lab", "pred"):
        assert_same(getattr(jnew, f), getattr(tnew, f))


# ---- the source-blocked layout and its plain fold


def _live_multiset(nbr, wgt, r):
    """Sorted (nbr, wgt bits) of the live slots of row r."""
    live = torch.isfinite(wgt[r])
    pairs = zip(nbr[r][live].tolist(), wgt[r][live].float().view(torch.int32).tolist())
    return sorted(pairs)


@pytest.mark.parametrize("case", [
    (300, 32, 1000, 96, False, 2 * 8 * 96),    # SB does not divide N, six slices
    (77, 48, 4096, 1000, True, 0),             # a one-block budget: five slices of SB
    (200, 4, 50, 1000, False, None),           # SB > N: one slice
    (128, 8, 256, 64, True, None),             # a lane axis' default budget: one slice
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_blocked_layout_keeps_row_slot_multisets(case, dtype):
    """Every row's live slots, as a multiset, are its runs' slots; a row has
    at most one run a slice, every row has a run, the first run of a row is
    the only one not marked for merging, and runs are sorted by (slice,
    row) with contiguous slots."""
    R, K, N, SB, lanes, budget = case
    nbr, wgt, _, _ = _ell_inputs(R, K, N, seed=R)
    wgt[::7] = np.inf  # all-padding rows
    nbr_t, wgt_t = torch.from_numpy(nbr), torch.from_numpy(wgt).to(_TDTYPES[dtype])
    kw = {} if budget is None else {"budget": budget}
    L = tmp.blocked_layout(nbr_t, wgt_t, N, SB, lanes, **kw)
    W = L.slice_width
    assert W % SB == 0 and W >= SB
    if budget is not None:
        assert W == SB * max(1, budget // (8 * SB))
    assert (L.n, L.rows, L.width, L.src_block) == (N, R, K, SB)
    assert L.slot_nbr.shape[0] % 8 == 0 and L.slot_nbr.shape[0] >= int(L.run_off[-1]) + 8
    assert L.slot_wgt.dtype == wgt_t.dtype
    code = L.run_row.long()
    rows = torch.where(code < 0, ~code, code)
    slots = {r: [] for r in range(R)}
    seen = {}
    prev = (-1, -1)
    n_runs = 0
    for run0, nruns in L.slices:
        n_runs += nruns
        for j in range(run0, run0 + nruns):
            a, b = int(L.run_off[j]), int(L.run_off[j + 1])
            r = int(rows[j])
            sl = int(L.slot_nbr[a]) // W if b > a else 0
            assert (sl, r) > prev  # sorted, one run a (slice, row)
            prev = (sl, r)
            assert b - a <= K
            ids = L.slot_nbr[a:b]
            assert bool(((ids // W) == sl).all())
            assert (int(code[j]) >= 0) == (r not in seen)
            seen[r] = True
            slots[r] += list(zip(ids.tolist(),
                                 L.slot_wgt[a:b].float().view(torch.int32).tolist()))
    assert n_runs == L.num_runs and len(seen) == R
    for r in range(R):
        assert sorted(slots[r]) == _live_multiset(nbr_t, wgt_t, r)
    # a kernel stage holds the widest tile of T runs, its span aligned out
    off = L.run_off.tolist()
    for T in (8, 64, 256):
        spans = [-(-off[min(a + T, r0 + n)] // 8) * 8 - off[a] // 8 * 8
                 for r0, n in L.slices for a in range(r0, r0 + n, T)]
        assert L.tile_cap(T) == max(spans)


def test_blocked_layout_rejects_neighbors_out_of_range():
    nbr, wgt, _, _ = _ell_inputs(16, 4, 32, seed=1)
    nbr[3, 1], wgt[3, 1] = 40, 1.0
    with pytest.raises(ValueError, match="outside"):
        tmp.blocked_layout(torch.from_numpy(nbr), torch.from_numpy(wgt), 32, 8)
    wgt[3, 1] = np.inf  # a padding slot may point anywhere
    tmp.blocked_layout(torch.from_numpy(nbr), torch.from_numpy(wgt), 32, 8)


def test_blocked_stride_and_slice_width():
    for b in (1, 2, 3, 5, 8, 9, 17, 10**4):
        lanes = torch.zeros(min(b, tmp.LANE_GROUP), 1)
        assert tmp.blocked_stride(b) == tmp.record_stride(lanes)
    one = tmp.slice_budget(False)
    assert tmp.slice_width(50, 1000, one) == 1000  # SB > N: one block
    assert tmp.slice_width(10**6, 4096, 8 * 4096 * 3) == 3 * 4096
    assert tmp.slice_width(10**6, 4096, 8 * 4096 * 3 - 1) == 2 * 4096
    assert tmp.slice_width(10**6, 4096, 0) == 4096  # at least one block
    assert tmp.slice_width(10**4, 4096, one) == 3 * 4096  # at most N rounded up
    # one lane: slices of L2_BUDGET bytes of records; a lane axis: one slice
    assert tmp.slice_width(10**8, 4096, one) == tmp.L2_BUDGET // 8 // 4096 * 4096
    assert tmp.slice_width(10**8, 4096, tmp.slice_budget(True)) == -(-10**8 // 4096) * 4096
    assert one == tmp.L2_BUDGET and tmp.slice_budget(True) >= 2**62


def _jax_blocked(nbr, wgt, dist, lab, SB, BR):
    """JAX ``minplus_blocked_call`` in interpret mode on (N,) or (B, N)
    inputs: rows padded to a ``BR`` multiple and N to an ``SB`` multiple
    with inert entries, as its grid needs; a lane axis through vmap."""
    R, N = nbr.shape[0], dist.shape[-1]
    pr, pn = (-R) % BR, (-N) % SB
    nbr = jnp.pad(nbr, ((0, pr), (0, 0)))
    wgt = jnp.pad(wgt, ((0, pr), (0, 0)), constant_values=jnp.inf)
    widths = [(0, 0)] * (dist.ndim - 1) + [(0, pn)]
    dist = jnp.pad(dist, widths, constant_values=jnp.inf)
    lab = jnp.pad(lab, widths, constant_values=IMAX)

    def one(d, lb):
        out = jmp.minplus_blocked_call(nbr, wgt, d, lb, block_rows=BR, src_block=SB,
                                       interpret=True)
        return tuple(x[:R] for x in out)

    return one(dist, lab) if dist.ndim == 1 else jax.vmap(one)(dist, lab)


@pytest.mark.parametrize("case", [
    # (R, K, N, SB, B, budget blocks, what)
    (96, 8, 300, 64, None, 1, "SB does not divide N"),
    (64, 4, 50, 128, None, None, "SB > N"),
    (128, 8, 256, 256, None, None, "a single slice"),
    (64, 8, 200, 32, 1, 2, "one lane"),
    (64, 8, 200, 32, 2, 1, "two lanes"),
    (32, 16, 130, 40, 5, 1, "five lanes"),
])
@pytest.mark.parametrize("dtypes", [("f32", "f32"), ("bf16", "bf16"), ("bf16", "f32"),
                                    ("f32", "bf16")], ids=lambda d: f"w{d[0]}-d{d[1]}")
def test_minplus_blocked_torch_matches_jax(case, dtypes):
    """The plain fold over the layout equals JAX's blocked kernel (interpret
    mode) and ``minplus_torch``, with all-padding rows and rows whose slots
    all fall in one slice."""
    R, K, N, SB, B, blocks, _ = case
    wd, dd = dtypes
    nbr, wgt, dist, lab = lane_inputs(R, K, N, B, seed=R + N)
    wgt[::5] = np.inf                                  # all-padding rows
    nbr[1::5] = np.arange(K) % min(SB, N)              # every slot in the first slice
    nbr[2::5] = N - 1 - np.arange(K) % 2               # every slot in the last slice
    j = (jnp.asarray(nbr), jnp.asarray(wgt, _JDTYPES[wd]), jnp.asarray(dist, _JDTYPES[dd]),
         jnp.asarray(lab))
    t = (torch.from_numpy(nbr), torch.from_numpy(wgt).to(_TDTYPES[wd]),
         torch.from_numpy(dist).to(_TDTYPES[dd]), torch.from_numpy(lab))
    kw = {} if blocks is None else {"budget": 8 * SB * blocks}
    L = tmp.blocked_layout(t[0], t[1], N, SB, B is not None and B > 1, **kw)
    assert len(L.slices) == (1 if blocks is None else -(-N // (SB * blocks)))
    got = minplus_blocked_torch(L, t[2], t[3])
    _triples_equal(_jax_blocked(*j, SB, 32), got)
    _triples_equal(minplus_torch(*t), got)
    _triples_equal(got, tmp.minplus_blocked_call(*t, src_block=SB, layout=L))


def test_minplus_blocked_torch_empty_rows_and_graph():
    """R = 0, and rows with no live slot at all, give the identity."""
    L = tmp.blocked_layout(torch.zeros((0, 4), dtype=torch.int32), torch.zeros((0, 4)), 10, 4)
    assert L.slices == () and L.num_runs == 0
    m, ml, ms = minplus_blocked_torch(L, torch.zeros(10), torch.zeros(10, dtype=torch.int32))
    assert m.shape == ml.shape == ms.shape == (0,)
    R, K, N = 40, 8, 64
    nbr, wgt = torch.zeros((R, K), dtype=torch.int32), torch.full((R, K), float("inf"))
    L = tmp.blocked_layout(nbr, wgt, N, 16)
    assert L.slices == ((0, R),) and int(L.run_off[-1]) == 0
    m, ml, ms = minplus_blocked_torch(L, torch.zeros((3, N)), torch.zeros((3, N), dtype=torch.int32))
    assert m.shape == (3, R) and torch.isinf(m).all()
    assert (ml == IMAX).all() and (ms == IMAX).all()


def test_src_block_builds_the_layout_once():
    """On the CPU the layout is built by no path: the plain path reads the
    ELL, so a scale-10 fixpoint with ``src_block``, a prepared handle and a
    batch handle build none and equal the solve without it.  On the card
    each builds it once (``test_torch_cuda.py``)."""
    from repro.data.graphs import rmat_edges
    from repro_torch.core.graph import from_edges
    from repro_torch.solver import SolverConfig, SteinerSolver
    from repro_torch.solver.backends import blocked_layout_cached

    src, dst, w, n = rmat_edges(10, 8, max_weight=100, seed=0)
    g = from_edges(src, dst, w, n, pad_to=8, device="cpu")
    ell = tto_ell(g, 32)
    seeds = torch.arange(0, 1024, 64, dtype=torch.int32)
    b0 = tmp.blocked_layout.builds
    st, stats = tops.voronoi_cells_pallas(ell, seeds, src_block=256)
    assert int(stats.iterations) > 2 and tops.ell_layout(ell, 256) is None
    ref, _ = tops.voronoi_cells_pallas(ell, seeds)
    for f in ("dist", "lab", "pred"):
        assert_same(getattr(ref, f), getattr(st, f))

    batch = np.stack([seeds.numpy(), seeds.numpy() + 1, seeds.numpy() + 2])
    for backend, q in (("single", seeds.numpy()), ("batch", batch)):
        cfg = SolverConfig(backend=backend, mode="pallas", src_block=256)
        h = SteinerSolver(cfg, device="cpu").prepare(g)
        assert h.artifact("blocked_layout") is None
        assert blocked_layout_cached(h.artifact("ell"), cfg, 3) is None
        want = SteinerSolver(cfg.replace(src_block=None), device="cpu").prepare(g).solve(q)
        got = h.solve(q)
        assert np.array_equal(np.asarray(got.total_distance), np.asarray(want.total_distance))
    assert tmp.blocked_layout.builds == b0
