"""The bucketed segment min of ``repro_torch`` against the Pallas kernel of
``repro``.

On the CPU the wrapper runs its plain PyTorch version; it is held bit for
bit against the JAX kernel run in interpret mode (as tests/test_kernels.py
runs it) and against ``segmin_bucketed_ref``.  The CUDA kernel itself is
held against the plain version on the card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segmin.ops import segmin_bucketed as jsegmin
from repro.kernels.segmin.ref import segmin_bucketed_ref
from _segmin_inputs import segmin_inputs
from _torch_parity import assert_same
from repro_torch.kernels.segmin import segmin as tseg
from repro_torch.kernels.segmin.ops import segmin_bucketed
from repro_torch.kernels.segmin.ref import segmin_bucketed_torch

IMAX = np.iinfo(np.int32).max
_TDTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
_JDTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _both(cand, ldst, lab, src, dtype):
    j = (jnp.asarray(cand, _JDTYPES[dtype]), jnp.asarray(ldst), jnp.asarray(lab),
         jnp.asarray(src))
    t = (torch.from_numpy(cand).to(_TDTYPES[dtype]), torch.from_numpy(ldst),
         torch.from_numpy(lab), torch.from_numpy(src))
    return j, t


def _triples_equal(a, b):
    for x, y in zip(a, b):
        assert_same(x, y)


@pytest.mark.parametrize("shape", [(1, 256, 32), (4, 512, 64), (2, 1000, 128), (8, 64, 256)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_segmin_sweep(shape, dtype):
    NB, EB, VB = shape
    j, t = _both(*segmin_inputs(NB, EB, VB, seed=EB), dtype)
    out = segmin_bucketed(*t, vb=VB, edge_block=256)
    _triples_equal(jsegmin(*j, vb=VB, edge_block=256), out)
    _triples_equal(segmin_bucketed_ref(*j, VB), out)


def test_segmin_all_padding():
    """Every lane inert: the identity triple everywhere, as in the reference."""
    NB, EB, VB = 2, 128, 16
    cand = torch.full((NB, EB), float("inf"))
    z = torch.zeros((NB, EB), dtype=torch.int32)
    out = segmin_bucketed(cand, z, z, z, vb=VB, edge_block=128)
    jz, jinf = jnp.zeros((NB, EB), jnp.int32), jnp.full((NB, EB), jnp.inf)
    _triples_equal(jsegmin(jinf, jz, jz, jz, vb=VB, edge_block=128), out)
    _triples_equal(segmin_bucketed_ref(jinf, jz, jz, jz, VB), out)
    m, ml, ms = out
    assert torch.isinf(m).all() and (ml == IMAX).all() and (ms == IMAX).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_segmin_tie_heavy(dtype):
    """Integer candidates in [0, 4) and three labels: most vertices resolve
    their minimum on the second or third key."""
    NB, EB, VB = 3, 768, 40
    j, t = _both(*segmin_inputs(NB, EB, VB, seed=11, ties=True), dtype)
    out = segmin_bucketed(*t, vb=VB, edge_block=256)
    _triples_equal(jsegmin(*j, vb=VB, edge_block=256), out)
    _triples_equal(segmin_bucketed_ref(*j, VB), out)
    m = out[0]
    assert set(torch.unique(m[torch.isfinite(m)]).tolist()) <= {0.0, 1.0, 2.0, 3.0}


@pytest.mark.parametrize("EB,edge_block", [(1000, 256), (300, 128), (7, 512)])
def test_segmin_pads_to_edge_block(EB, edge_block):
    """EB that ``edge_block`` does not divide: both wrappers pad with inert
    lanes, and the result is that of the unpadded buckets."""
    NB, VB = 3, 24
    j, t = _both(*segmin_inputs(NB, EB, VB, seed=EB + 1), "f32")
    out = segmin_bucketed(*t, vb=VB, edge_block=edge_block)
    _triples_equal(jsegmin(*j, vb=VB, edge_block=edge_block), out)
    _triples_equal(segmin_bucketed_torch(*t, VB), out)


def test_segmin_call_checks_like_the_reference():
    cand, ldst, lab, src = (torch.from_numpy(x) for x in segmin_inputs(2, 96, 8, seed=0))
    with pytest.raises(ValueError, match="multiple of edge_block"):
        tseg.segmin_bucketed_call(cand, ldst, lab, src, vb=8, edge_block=64)
    with pytest.raises(ValueError, match="int32"):
        tseg.segmin_bucketed_call(cand, ldst.long(), lab, src, vb=8, edge_block=32)
    with pytest.raises(ValueError, match="vb"):
        tseg.segmin_bucketed_call(cand, ldst, lab, src, vb=0, edge_block=32)
    with pytest.raises(ValueError, match="edge_block"):
        segmin_bucketed(cand, ldst, lab, src, vb=8, edge_block=0)
    n0 = tseg.segmin_bucketed_call.launches
    tseg.segmin_bucketed_call(cand, ldst, lab, src, vb=8, edge_block=32)
    assert tseg.segmin_bucketed_call.launches == n0  # the CPU runs no kernel
