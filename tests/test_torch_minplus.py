"""Min-plus kernels of ``repro_torch`` against the Pallas kernels of ``repro``.

On the CPU the wrappers run their plain PyTorch version; it is held bit for
bit against the JAX kernels run in interpret mode (as tests/test_kernels.py
runs them) and against ``minplus_ref``.  The CUDA kernels themselves are held
against the plain version on the card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.minplus.minplus as jmp
import repro.kernels.minplus.ops as jops
from repro.core.voronoi import VoronoiState as JState
from repro.kernels.minplus.ref import minplus_ref
from _minplus_inputs import ell_inputs as _ell_inputs
from _torch_parity import assert_same, both_graphs, instance
from repro.core.graph import to_ell as jto_ell
from repro_torch.core.graph import to_ell as tto_ell
from repro_torch.core.voronoi import VoronoiState as TState
from repro_torch.kernels.minplus import minplus as tmp
from repro_torch.kernels.minplus import ops as tops
from repro_torch.kernels.minplus.ref import minplus_torch

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


def test_pad_rows_matches():
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    assert_same(jops._pad_rows(jnp.asarray(x), 4, jnp.inf),
                tops._pad_rows(torch.from_numpy(x), 4, float("inf")))
    assert_same(jops._pad_rows(jnp.arange(5, dtype=jnp.int32), 5, IMAX),
                tops._pad_rows(torch.arange(5, dtype=torch.int32), 5, IMAX))
    assert_same(jops._pad_rows(jnp.arange(5, dtype=jnp.int32), 3, IMAX),
                tops._pad_rows(torch.arange(5, dtype=torch.int32), 3, IMAX))


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
