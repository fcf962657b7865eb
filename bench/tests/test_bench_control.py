"""The comparison that decides ``correct`` has to fail its control and the
faults a cell can have: the reference in bfloat16 in the program's place,
and the program with its timed path broken underneath (a relaxation that
returns its state unchanged; half of a batch left out, its answers taken
from the rest; an answer altered where it is produced, in every solve or in
one lane of every batch).  The harness runs here on the CPU at a small
size, the look for a card skipped; a serve cell compares as many answers,
drawn the same way, as it does on the card."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from perfkit import manifest  # noqa: E402
from perfkit.harness import run_cell, run_control  # noqa: E402

torch.set_num_threads(1)
MAN = manifest.load_manifest()
SINGLE = ("lvj1k-single-s1024", "lvj1k-single-s8")
SERVE = ("lvj1k-serve-backlog",)


def small(cell, scale=9):
    tr = {}
    if cell in SINGLE:
        tr["check"] = {"sample": 16, "pool": 24}
    if cell == "lvj1k-single-s1024":
        tr["sizes"] = {"dist": "fixed", "value": 64}
    return {"config": {"graph": {"scale": scale}}, "traffic": tr}


def run(cell, seed=3000000001):
    res, _ = run_cell(MAN, manifest.workload(MAN, cell), seed, 0.4, False, device="cpu",
                      overrides=small(cell))
    return res


@pytest.mark.parametrize("cell", SINGLE + SERVE)
def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("cell", SINGLE + SERVE)
def test_bfloat16_control_is_not_correct(cell, seed):
    numbers, ok, lines = run_control(MAN, manifest.workload(MAN, cell), seed, 0.5,
                                     device="cpu", overrides=small(cell, scale=12))
    assert not ok, lines
    assert numbers["compared"] > 0


def unchanged_step(monkeypatch):
    from repro_torch.kernels.minplus import ops

    monkeypatch.setattr(ops, "relax_ell",
                        lambda ell, st, **kw: (st, torch.zeros_like(st.dist, dtype=torch.bool)))


def half_batch(monkeypatch):
    from repro_torch.solver.backends import BatchBackend

    orig = BatchBackend.solve_raw

    def solve_raw(self, cfg, g, seeds, num_seeds, ell=None):
        seeds = torch.as_tensor(seeds, dtype=torch.int32, device=g.device).clone()
        half = seeds.shape[0] // 2
        seeds[half:] = seeds[:seeds.shape[0] - half]
        return orig(self, cfg, g, seeds, num_seeds, ell)

    monkeypatch.setattr(BatchBackend, "solve_raw", solve_raw)


def altered_answer(monkeypatch):
    from repro_torch.core import tree

    orig = tree.extract_tree

    def extract_tree(*a, **kw):
        t = orig(*a, **kw)
        return dataclasses.replace(t, total_distance=t.total_distance + 1)

    monkeypatch.setattr(tree, "extract_tree", extract_tree)


def one_lane(lane):
    """The answer of one lane of every batch altered where it is produced."""

    def plant(monkeypatch):
        from repro_torch.solver.backends import BatchBackend

        orig = BatchBackend.solve_raw

        def solve_raw(self, *a, **kw):
            res = orig(self, *a, **kw)
            total = res.tree.total_distance.clone()
            total[lane] += 1
            return dataclasses.replace(res, tree=dataclasses.replace(res.tree,
                                                                     total_distance=total))

        monkeypatch.setattr(BatchBackend, "solve_raw", solve_raw)

    return plant


LANES = 8  # lvj1k-serve's max_batch
FAULTS = {"unchanged_step": unchanged_step, "half_batch": half_batch,
          "altered_answer": altered_answer,
          **{f"one_lane_{i}": one_lane(i) for i in range(LANES)}}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in SINGLE for f in
                                        ("unchanged_step", "altered_answer")]
                         + [(c, f) for c in SERVE for f in FAULTS])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_serve_check_compares_every_lane_of_a_batch(seed):
    from perfkit import check, traffic

    rng = np.random.default_rng(seed)
    sizes = [[int(k) for k in rng.integers(2, 33, size=LANES)] for _ in range(20)]
    pick = check.batch_sample(sizes, 8, traffic.rng_for(seed, traffic.SAMPLE))
    flat = [k for b in sizes for k in b]
    largest = int(np.argmax(flat))
    batch = range(largest - largest % LANES, largest - largest % LANES + LANES)
    assert set(batch) <= set(pick) and len(pick) == LANES + 8 == len(set(pick))
    assert pick == check.batch_sample(sizes, 8, traffic.rng_for(seed, traffic.SAMPLE))
