"""The per-rank flight recorder's analytics of ``repro_torch.obs.flight``
against ``repro.obs.flight``: the same buffers give the same report, text
and markdown, the same imbalance, stragglers and consistency verdicts, and
a dump of either package loads in the other."""

import dataclasses

import numpy as np
import pytest

import repro.obs as jobs
import repro.obs.flight as jflight
from repro_torch import obs as tobs
from repro_torch.obs import flight as tflight


def _buffers(seed, rounds=12, ranks=8):
    """An integer-valued (rounds, ranks, 4) f32 buffer, some all-zero
    channels and rounds, and its exact per-round sums."""
    rng = np.random.default_rng(seed)
    per_rank = rng.integers(0, 50, size=(rounds, ranks, 4)).astype(np.float32)
    per_rank[rng.random((rounds, ranks, 4)) < 0.3] = 0.0
    per_rank[rounds // 2, :, 0] = 0.0  # an idle frontier round
    return per_rank, per_rank.sum(axis=1, dtype=np.float32)


def test_round_channels_match():
    assert tobs.ROUND_CHANNELS == jobs.ROUND_CHANNELS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_analyze_and_render_match_reference(seed):
    per_rank, per_round = _buffers(seed)
    got = tflight.analyze(per_rank, label="mesh1d/frontier")
    want = jflight.analyze(per_rank, label="mesh1d/frontier")
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    for fmt in ("text", "markdown"):
        for top in (1, 5):
            assert tflight.render_report(got, fmt, top) == jflight.render_report(want, fmt, top)
    np.testing.assert_array_equal(tflight.load_imbalance(per_rank),
                                  jflight.load_imbalance(per_rank))
    assert tflight.straggler_ranks(per_rank, 2) == jflight.straggler_ranks(per_rank, 2)
    tflight.check_consistency(per_rank, per_round, label="ok")


def test_consistency_and_shape_errors_match_reference():
    per_rank, per_round = _buffers(3)
    bad = per_round.copy()
    bad[4, 1] += 1.0
    with pytest.raises(ValueError) as got:
        tflight.check_consistency(per_rank, bad, label="x")
    with pytest.raises(ValueError) as want:
        jflight.check_consistency(per_rank, bad, label="x")
    assert str(got.value) == str(want.value)
    assert "round 4" in str(got.value)
    with pytest.raises(ValueError, match="per_rank must be"):
        tflight.analyze(per_rank[:, :, :3])
    with pytest.raises(ValueError, match="fmt must be"):
        tflight.render_report(tflight.analyze(per_rank), "html")


def test_dump_and_load_cross_package(tmp_path):
    per_rank, per_round = _buffers(4)
    tflight.dump_flight(str(tmp_path / "t.json"), per_rank, label="t", per_round=per_round,
                        extra={"cell": "lvj_1k"})
    jflight.dump_flight(str(tmp_path / "j.json"), per_rank, label="t", per_round=per_round,
                        extra={"cell": "lvj_1k"})
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    doc = jflight.load_flight(str(tmp_path / "t.json"))
    mine = tflight.load_flight(str(tmp_path / "j.json"))
    np.testing.assert_array_equal(doc["per_rank"], mine["per_rank"])
    np.testing.assert_array_equal(mine["per_round"], per_round)
    assert mine["extra"] == {"cell": "lvj_1k"} and mine["label"] == "t"
    (tmp_path / "bad.json").write_text("{}")
    with pytest.raises(ValueError, match="not a flight file"):
        tflight.load_flight(str(tmp_path / "bad.json"))
