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

from _minplus_inputs import ell_inputs
from repro_torch.core.graph import from_edges
from repro_torch.data.graphs import rmat_edges, select_seeds
from repro_torch.kernels.minplus import minplus as tmp
from repro_torch.kernels.minplus import ops as tops
from repro_torch.kernels.minplus.ref import minplus_torch
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
