"""The roofline's byte count (bench/perfkit/roofline.py), by hand, and tied
to the ELL-padded bounds of PERF.md's table of kernels."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from perfkit import roofline  # noqa: E402

E, N = 150_992_768, 8_388_608  # lvj_1k-RMAT: directed edges, vertices
R, K = 11_768_435, 32  # its ELL view


def test_relax_bytes_by_hand():
    # ids and weights of every edge, dist and lab read and (dist, lab, pred)
    # written once a vertex a lane
    assert roofline.relax_bytes(E, N, 1) == 1_207_942_144 + 67_108_864 + 100_663_296
    assert roofline.relax_bytes(E, N, 8) == 1_207_942_144 + 536_870_912 + 805_306_368
    assert roofline.bound_ms(roofline.relax_bytes(E, N, 1)) == pytest.approx(0.41066, abs=1e-5)
    assert roofline.bound_ms(roofline.relax_bytes(E, N, 8)) == pytest.approx(0.76123, abs=1e-5)


def test_ell_bytes_reproduce_the_kernel_table():
    assert roofline.bound_ms(roofline.ell_bytes(R, K, N, 1)) == pytest.approx(0.962, abs=5e-4)
    assert roofline.bound_ms(roofline.ell_bytes(R, K, N, 8)) == pytest.approx(1.397, abs=5e-4)
    # the inputs' work is below the layout's: the padding of the ELL is not work
    assert roofline.relax_bytes(E, N, 8) < roofline.ell_bytes(R, K, N, 8)
