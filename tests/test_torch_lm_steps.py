"""The step functions of ``repro_torch.models.transformer`` against the
reference's, for each of the five LM architectures at its reduced size (f32
variants) on the reference's own weights: ``make_decode_step`` over two
tokens (the bf16 KV cache, qwen's int8 cache, deepseek's MLA latent cache),
``make_prefill_step`` with ``batch_chunks=2``, ``make_train_step`` with
``grad_accum=2`` against one batch, and the loss curve of three steps.
(Chunks and microbatches equal one batch for the dense archs only: an MoE
layer's expert capacity follows the tokens it is given, in both packages.)

Tolerances (``|got - want| <= atol + rtol·|want|``): logits and f32 caches
rtol 1e-5 with atol 5e-5·max|want| (test_torch_lm.py says why); int8
caches equal; the accumulated gradient, read as the first moment
m = (1 - b1)·g after one step at lr 0, rtol 1e-5 with atol 2e-4·max|m|;
losses rtol 1e-6 on one step, 1e-3 over three (an Adam step moves a
near-zero gradient's weight by ±lr on its sign, so weights are not
compared after a step: the update itself is held in test_torch_optim.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_inputs import (LM_IDS, assert_close, assert_tree_close, both_params,
                              configs, tokens)
from repro.models import transformer as jtf
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch.models import transformer as ttf
from repro_torch.optim import OptConfig, adamw_init

LOGITS = dict(rtol=1e-5, atol_frac=5e-5)
GRADS = dict(rtol=1e-5, atol_frac=2e-4)


def _jax_caches(cfg, B, smax):
    """The reference's zero caches (as its tests build them)."""
    Ld = cfg.first_dense_layers if cfg.moe else cfg.n_layers
    Lm = cfg.n_layers - Ld if cfg.moe else 0

    def zero(nl):
        if cfg.mla:
            return jnp.zeros((nl, B, smax, cfg.kv_lora_rank + cfg.qk_rope_head_dim), cfg.jdtype)
        kv = (nl, B, smax, cfg.n_kv_heads, cfg.hd)
        if cfg.kv_quant_int8:
            sc = (nl, B, smax, cfg.n_kv_heads, 1)
            return (jnp.zeros(kv, jnp.int8), jnp.zeros(sc, jnp.bfloat16),
                    jnp.zeros(kv, jnp.int8), jnp.zeros(sc, jnp.bfloat16))
        return jnp.zeros(kv, cfg.jdtype), jnp.zeros(kv, cfg.jdtype)

    return {k: zero(n) for k, n in (("dense", Ld), ("moe", Lm)) if n}


@pytest.mark.parametrize("arch", LM_IDS)
def test_decode_steps_match(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(arch)
    B, smax = 2, 16
    jcache = _jax_caches(jcfg, B, smax)
    tcache = ttf.init_caches(tcfg, B, smax, device="cpu")
    jstep = jax.jit(jtf.make_decode_step(jcfg, dp_axes=()))
    tstep = ttf.make_decode_step(tcfg)
    tok = tokens(jcfg.vocab, B, 2, seed=4)
    got_all = []
    for i in range(2):
        want, jcache = jstep(jp, jcache, jnp.asarray(tok[:, i]), jnp.int32(i))
        got, tcache = tstep(tp, tcache, torch.from_numpy(tok[:, i].copy()), i)
        assert got.shape == (B, tcfg.vocab_padded)
        assert_close(got, want, **LOGITS, what=f"logits of token {i}")
        got_all.append(got)
    for name in jcache:
        jc, tc = jcache[name], tcache[name]
        for j, t in zip(jax.tree.leaves(jc), [tc] if tcfg.mla else tc):
            if t.dtype == torch.int8:
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            else:
                assert_close(t, j, **LOGITS, what=f"{name} cache")
    # the port's decode = its own forward at the same positions
    fwd = ttf.forward(tcfg, tp, torch.from_numpy(tok))
    if not tcfg.kv_quant_int8:
        assert_close(torch.stack(got_all, 1), fwd, **LOGITS, what="decode vs forward")


@pytest.mark.parametrize("arch", LM_IDS)
def test_prefill_in_batch_chunks_matches(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(arch)
    tok = tokens(jcfg.vocab, 4, 10, seed=5)
    want = jax.jit(jtf.make_prefill_step(jcfg, dp_axes=(), kv_chunk=4, batch_chunks=2))(
        jp, jnp.asarray(tok))
    got = ttf.make_prefill_step(tcfg, kv_chunk=4, batch_chunks=2)(tp, torch.from_numpy(tok))
    assert got.shape == (4, tcfg.vocab_padded)
    assert_close(got, want, **LOGITS)
    if not tcfg.moe:  # an MoE layer's capacity follows the tokens of a chunk
        one = ttf.make_prefill_step(tcfg, kv_chunk=4)(tp, torch.from_numpy(tok))
        assert_close(got, one, **LOGITS, what="2 chunks vs 1")


@pytest.mark.parametrize("arch", LM_IDS)
def test_grad_accum_matches_the_reference_and_one_batch(arch):
    """At lr 0 a step leaves the weights and sets m = (1 - b1)·g: the moments
    expose the accumulated gradient of both packages."""
    jcfg, tcfg = configs(arch)
    tok = tokens(jcfg.vocab, 4, 12, seed=6)
    jp, tp = both_params(arch)
    jopt = JOptConfig(lr=0.0)
    jstep = jax.jit(jtf.make_train_step(jcfg, jopt, dp_axes=(), grad_accum=2))
    _, jstate, jloss = jstep(jp, jadamw_init(jp, jopt), jnp.asarray(tok))
    ms = {}
    for ga in (2, 1):
        _, tp = both_params(arch)
        opt = OptConfig(lr=0.0)
        step = ttf.make_train_step(tcfg, opt, grad_accum=ga)
        _, state, loss = step(tp, adamw_init(tp, opt), torch.from_numpy(tok))
        ms[ga] = jax.tree.map(lambda mv: mv["m"], state["mu"],
                              is_leaf=lambda x: isinstance(x, dict) and "m" in x)
        if ga == 2:
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
            assert int(state["count"]) == int(jstate["count"]) == 1
        elif not tcfg.moe:  # (an MoE layer's capacity follows the microbatch)
            # the mean of two equal microbatches' means is the batch mean
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jm = jax.tree.map(lambda mv: np.asarray(mv["m"]), jstate["mu"],
                      is_leaf=lambda x: isinstance(x, dict) and "m" in x)
    assert_tree_close(ms[2], jm, **GRADS)
    if not tcfg.moe:
        assert_tree_close(ms[1], jm, **GRADS)


@pytest.mark.parametrize("arch", LM_IDS)
def test_loss_curve_of_three_steps_matches(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(arch)
    tok = tokens(jcfg.vocab, 4, 16, seed=7)
    jopt, opt = JOptConfig(lr=1e-3), OptConfig(lr=1e-3)
    jstep = jax.jit(jtf.make_train_step(jcfg, jopt, dp_axes=()))
    tstep = ttf.make_train_step(tcfg, opt)
    js, ts = jadamw_init(jp, jopt), adamw_init(tp, opt)
    jl, tl = [], []
    for _ in range(3):
        jp, js, loss = jstep(jp, js, jnp.asarray(tok))
        jl.append(float(loss))
        tp, ts, loss = tstep(tp, ts, torch.from_numpy(tok))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]  # it learns the batch
