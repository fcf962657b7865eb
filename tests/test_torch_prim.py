"""Prim's MST of ``repro_torch`` on the CPU: the plain loop that the kernel
of ``kernels/mst`` is held to, against the JAX reference, and the kernel
wrapper's checks and block counts.

The CUDA kernel itself is held bit for bit against the plain loop on the
card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mst as jmst
from _prim_inputs import PRIM_KINDS, prim_table
from _torch_parity import assert_same
from repro_torch.core import mst as tmst
from repro_torch.data.graphs import rmat_edges, select_seeds
from repro_torch.core.graph import from_edges
from repro_torch.kernels import _build
from repro_torch.kernels.mst import prim as kprim
from repro_torch.solver import SolverConfig, SteinerSolver


@pytest.mark.parametrize("kind", PRIM_KINDS)
@pytest.mark.parametrize("S", [1, 2, 8, 33])
def test_cpu_tensor_takes_the_plain_loop(kind, S):
    m = prim_table(S, kind, seed=S)
    n0 = kprim.prim_call.launches
    got = tmst.prim_dense(torch.from_numpy(m))
    assert kprim.prim_call.launches == n0  # the CPU runs no kernel
    assert torch.equal(got, tmst.prim_loop(torch.from_numpy(m)))
    assert_same(jmst.prim_dense(jnp.asarray(m)), got)


def test_plain_loop_keeps_other_components_and_an_isolated_root():
    m = prim_table(40, "components", seed=3)
    parent = tmst.prim_loop(torch.from_numpy(m)).numpy()
    unreached = parent == np.arange(40)
    assert unreached[1:].any() and not unreached.all()
    iso = tmst.prim_loop(torch.from_numpy(prim_table(40, "isolated_root", seed=3)))
    assert iso.tolist() == list(range(40))


def test_cpu_solve_launches_no_prim_kernel():
    src, dst, w, n = rmat_edges(8, 8, max_weight=100, seed=0)
    seeds = select_seeds(n, src, dst, 16, strategy="uniform", seed=1000)
    g = from_edges(src, dst, w, n, pad_to=8, device="cpu")
    n0 = kprim.prim_call.launches
    cfg = SolverConfig(backend="single", mode="pallas")
    out = SteinerSolver(cfg, device="cpu").prepare(g).solve(seeds)
    assert kprim.prim_call.launches == n0
    assert np.isfinite(out.total_distance) and out.num_edges >= 15


def test_build_sources_list_the_mst_family():
    src = _build.SOURCES["mst"]
    assert src == _build.KERNELS_DIR / "mst" / "csrc" / "prim.cu" and src.exists()
    assert "prim_dense" in src.read_text()


def test_prim_call_checks_like_segmin():
    good = torch.from_numpy(prim_table(8, "ties", seed=0))
    with pytest.raises(ValueError, match=r"\(S, S\)"):
        kprim.prim_call(good[:, :7])
    with pytest.raises(ValueError, match=r"\(S, S\)"):
        kprim.prim_call(good[0])
    with pytest.raises(ValueError, match=r"\(S, S\)"):
        kprim.prim_call(torch.empty((0, 0)))
    with pytest.raises(ValueError, match="float32"):
        kprim.prim_call(good.double())
    with pytest.raises(ValueError, match="contiguous"):
        kprim.prim_call(torch.from_numpy(prim_table(8, "uniform", seed=0)).T)
    big = kprim.MAX_S + 1
    with pytest.raises(ValueError, match="above the kernel"):
        kprim.prim_call(torch.empty((big, big), device="meta"))
    # one device, and it has to be a card: no fallback to the loop
    for t in (good, good.to("meta")):
        with pytest.raises(ValueError, match="unsupported device"):
            kprim.prim_call(t)
    with pytest.raises(ValueError, match="unsupported device meta"):
        tmst.prim_dense(good.to("meta"))
    n0 = kprim.prim_call.launches
    tmst.prim_dense(good)
    assert kprim.prim_call.launches == n0  # the CPU runs no kernel


@pytest.mark.parametrize("S", [1, 2, 1024, kprim.BLOCK_MAX, kprim.BLOCK_MAX + 1,
                               10240, 65536, kprim.MAX_S])
def test_cluster_blocks_fit_the_kernel(S):
    """The count follows S within what the C entry point takes: 1..16
    blocks, each of at most 10,240 vertices."""
    C = kprim.cluster_blocks(S)
    assert 1 <= C <= min(S, kprim.MAX_CLUSTER)
    assert -(-S // C) <= 16 * 640  # 16 vertices a thread, 640 threads
    assert (C == 1) == (S <= kprim.BLOCK_MAX)
    assert C == 1 or -(-S // (C - 1)) > kprim.BLOCK_MAX  # the fewest that hold S
