"""``repro_torch.configs`` and ``repro_torch.data.tokens`` against the
reference: the registry holds the same eleven architectures field by field
(configs, reduced configs, shape cells, sources, parameter counts), the
Steiner solver presets are the same ``SolverConfig`` values, and the token
stream's batches are byte-equal for every (seed, step).  Exact everywhere.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401
import repro.configs as jconfigs
import repro.configs.steiner as jsteiner
import repro_torch.configs as tconfigs
import repro_torch.configs.steiner as tsteiner
from repro.data.tokens import TokenStream as JTokenStream
from repro_torch.data.tokens import TokenStream


def test_registry_ids_match():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.ALL_IDS == jconfigs.ALL_IDS and len(tconfigs.ALL_IDS) == 11
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_arch("gpt-2")


@pytest.mark.parametrize("arch", jconfigs.ALL_IDS)
def test_arch_spec_matches_field_by_field(arch):
    j, t = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    assert type(t).__name__ == type(j).__name__ == "ArchSpec"
    for f in ("arch_id", "family", "source"):
        assert getattr(t, f) == getattr(j, f)
    assert [dataclasses.asdict(s) for s in t.shapes] == [dataclasses.asdict(s)
                                                        for s in j.shapes]
    for which in ("model", "reduced"):
        jc, tc = getattr(j, which), getattr(t, which)
        assert type(tc).__name__ == type(jc).__name__
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        if hasattr(jc, "jdtype"):
            assert tc.torch_dtype == getattr(torch, jc.dtype)
        if j.family == "lm":
            assert (tc.hd, tc.vocab_padded) == (jc.hd, jc.vocab_padded)
            assert tc.params_count() == jc.params_count()
            assert tc.active_params_count() == jc.active_params_count()


def test_starcoder2_3b_is_the_full_width_trainer_config():
    cfg = tconfigs.get_arch("starcoder2-3b").model
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
            cfg.vocab, cfg.dtype) == (30, 3072, 24, 2, 128, 12288, 49152, "bfloat16")
    assert cfg.params_count() == 4_312_793_088


@pytest.mark.parametrize("name", sorted(jsteiner.SOLVER_PRESETS))
def test_solver_presets_match(name):
    j, t = jsteiner.solver_preset(name), tsteiner.solver_preset(name)
    assert type(t).__module__ == "repro_torch.solver.config"
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_solver_preset_names_match():
    assert sorted(tsteiner.SOLVER_PRESETS) == sorted(jsteiner.SOLVER_PRESETS)
    with pytest.raises(KeyError, match="no solver preset"):
        tsteiner.solver_preset("nope")


@pytest.mark.parametrize("vocab,batch,seq,seed", [(1000, 4, 16, 3), (49152, 8, 64, 0),
                                                  (256, 2, 32, 0), (4099, 3, 7, 11)])
def test_token_stream_is_byte_equal(vocab, batch, seq, seed):
    j, t = JTokenStream(vocab, batch, seq, seed=seed), TokenStream(vocab, batch, seq, seed=seed)
    for step in (0, 1, 7, 1000):
        a, b = j.batch_at(step), t.batch_at(step)
        assert a.dtype == b.dtype == np.int32 and a.shape == b.shape == (batch, seq)
        assert a.tobytes() == b.tobytes()
    it = iter(t)
    assert next(it).tobytes() == j.batch_at(0).tobytes()
    assert next(it).tobytes() == j.batch_at(1).tobytes()
