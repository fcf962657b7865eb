"""The LM family of ``repro_torch`` against ``repro``: the building blocks
(``models/layers.py``) and the transformer's forward pass, loss and
gradients (``models/transformer.py``), for each of the five LM
architectures at its reduced size, on the reference's own weights.

Tolerances (elementwise ``|got - want| <= atol + rtol·|want|``):
  * f32 (``dtype="float32"`` variants): rtol 1e-5 with atol 1e-5·max|want|
    for RoPE, RMSNorm, attention and the MoE FFN; rtol 1e-6 on the loss.
    Logits: atol 5e-5·max, since each package alone sits up to 9e-6·max
    from an f64 run of a dense arch (the two apart by 7e-6·max there, by
    1.9e-5·max for granite's MoE).  Gradients: atol 2e-4·max|want|, since
    both packages sit ~5e-5·max|g| from an f64 run (the softmax and
    attention backward cancel); the two apart by 7e-5·max at most.
  * bf16 (the archs' own dtype): the loss within rtol 2e-2, as a bf16
    forward pass rounds every activation to 8 bits of mantissa; RoPE and
    RMSNorm in bf16 within one bf16 step of max|want| (atol 2^-7·max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_inputs import (LM_IDS, assert_close, assert_tree_close, both_params,
                              configs, tokens)
from repro.models import layers as jL
from repro.models import transformer as jtf
from repro_torch.configs.base import LMConfig
from repro_torch.models import layers as tL
from repro_torch.models import transformer as ttf

F32 = dict(rtol=1e-5, atol_frac=1e-5)
LOGITS = dict(rtol=1e-5, atol_frac=5e-5)
GRADS = dict(rtol=1e-5, atol_frac=2e-4)
BF16_STEP = dict(rtol=0.0, atol_frac=2.0 ** -7)


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _both(a, dtype):
    """A numpy array in JAX and in torch, both in ``dtype`` ("float32" | "bfloat16")."""
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,theta,offset", [((2, 7, 3, 16), 10_000.0, 0),
                                                ((1, 5, 2, 8), 500.0, 37)])
def test_rope_interleaved_pairs_match(dtype, shape, theta, offset):
    jx, tx = _both(_rand(shape, 1), dtype)
    pos = np.broadcast_to(offset + np.arange(shape[1]), shape[:2]).astype(np.int32)
    want = jL.rope(jx, jnp.asarray(pos), theta)
    got = tL.rope(tx, torch.from_numpy(pos.copy()), theta)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, **(F32 if dtype == "float32" else BF16_STEP))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches(dtype):
    jx, tx = _both(_rand((3, 5, 32), 2) * 3, dtype)
    js, ts = _both(_rand((32,), 3), dtype)
    got = tL.rmsnorm(tx, ts)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, jL.rmsnorm(jx, js), **(F32 if dtype == "float32" else BF16_STEP))


# (Sq, Sk, Hq, Hkv, chunk, causal, q_offset): a padded last chunk, GQA, a
# single chunk, and rows with no visible key at all (q_offset < 0)
ATTN_CASES = [
    (20, 20, 4, 2, 8, True, 0),
    (9, 9, 4, 4, 16, True, 0),
    (6, 13, 6, 2, 4, False, 0),
    (8, 8, 4, 2, 3, True, -3),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_chunked_attention_matches(case):
    Sq, Sk, Hq, Hkv, chunk, causal, q_offset = case
    q, k, v = (_rand((2, S, H, 8), s) for S, H, s in ((Sq, Hq, 4), (Sk, Hkv, 5), (Sk, Hkv, 6)))
    want = jL.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                q_offset=q_offset, kv_chunk=chunk)
    got = tL.chunked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               causal=causal, q_offset=q_offset, kv_chunk=chunk)
    assert torch.isfinite(got).all()
    assert_close(got, want, **F32)
    if q_offset < 0:  # fully masked rows come out as zeros, not NaN
        assert float(got[:, :-q_offset].abs().max()) == 0.0


MOE_CFG = LMConfig(name="moe-test", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
                   d_ff=32, vocab=64, moe=True, n_experts=4, top_k=2, n_shared=1,
                   moe_d_ff=8, dtype="float32")


@pytest.mark.parametrize("router,capacity_factor", [
    ("random", 1.25),
    ("random", 0.25),  # capacity overflow: tokens dropped in the reference's order
    ("tied", 1.25),  # every gate equal: top-k takes the lowest expert ids
])
def test_moe_ffn_matches(router, capacity_factor):
    import dataclasses

    cfg = dataclasses.replace(MOE_CFG, capacity_factor=capacity_factor)
    d, E, fm = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    shapes = {"router": (d, E), "we1": (E, d, fm), "we3": (E, d, fm), "we2": (E, fm, d),
              "ws1": (d, fm), "ws3": (d, fm), "ws2": (fm, d)}
    p = {k: _rand(s, 10 + i) * 0.3 for i, (k, s) in enumerate(sorted(shapes.items()))}
    if router == "tied":
        p["router"] = np.zeros_like(p["router"])
    x = _rand((3, 11, d), 9)
    # 33 tokens × top-2 over 4 experts: 24 slots an expert (cf 1.25), 8 (cf 0.25)
    assert tL.moe_capacity(cfg, 33) == {1.25: 24, 0.25: 8}[capacity_factor]
    want = jL.moe_ffn(cfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = tL.moe_ffn(cfg, {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    assert_close(got, want, **F32)


def test_top_k_breaks_ties_toward_the_lower_index():
    x = np.array([[0.5, 0.2, 0.5, 0.5, 0.1], [1.0, 1.0, 1.0, 1.0, 1.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    tv, ti = tL.top_k(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# the transformer: forward, loss, gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["model", "reduced"])
@pytest.mark.parametrize("arch", LM_IDS)
def test_param_defs_match_the_reference(arch, which):
    """Every parameter's path, shape and dtype, at full width too (no
    allocation); the reduced config's init: norms one, biases zero, the
    rest normal with std fan_in^-0.5, in the config's dtype."""
    from repro.configs import get_arch as jget
    from repro_torch.configs import get_arch as tget

    jcfg, tcfg = getattr(jget(arch), which), getattr(tget(arch), which)
    want = {k: (shape, np.dtype(dt).name) for k, (shape, dt, _) in
            jtf.param_defs(jcfg, 1, 1).items()}
    got = {k: (shape, str(dt).removeprefix("torch.")) for k, (shape, dt) in
           ttf.param_defs(tcfg).items()}
    assert got == want
    if which == "reduced":
        params = ttf.init_params(tcfg, torch.Generator().manual_seed(0))
        for name, (shape, dt) in ttf.param_defs(tcfg).items():
            node = params
            for part in name.split("."):
                node = node[part]
            assert tuple(node.shape) == shape and node.dtype == dt, name
            x = node.float()
            if name.endswith(ttf.NORMS):
                assert bool((x == 1).all()), name
            elif name.endswith(ttf.BIASES):
                assert bool((x == 0).all()), name
            else:
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                assert abs(float(x.std()) * fan_in ** 0.5 - 1) < 0.1, name


@pytest.mark.parametrize("arch", LM_IDS)
def test_forward_loss_and_grads_match(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(arch)
    tok = tokens(jcfg.vocab, 2, 24, seed=1)
    # kv_chunk 16 over 24 positions: two chunks, the second padded
    want = jtf.forward(jcfg, jp, jnp.asarray(tok), dp_axes=(), kv_chunk=16)
    got = ttf.forward(tcfg, tp, torch.from_numpy(tok), kv_chunk=16)
    assert got.shape == (2, 24, tcfg.vocab_padded)
    assert_close(got, want, **LOGITS, what="logits")
    jloss, jg = jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, jnp.asarray(tok), dp_axes=(), kv_chunk=16))(jp)
    tloss, tg = ttf.loss_and_grads(tcfg, tp, torch.from_numpy(tok), kv_chunk=16)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    assert_tree_close(tg, jax.tree.map(np.asarray, jg), **GRADS)


@pytest.mark.parametrize("arch", LM_IDS)
def test_bf16_loss_matches(arch):
    jcfg, tcfg = configs(arch, "bfloat16")
    jp, tp = both_params(arch, "bfloat16")
    assert tp["embed"].dtype == torch.bfloat16
    tok = tokens(jcfg.vocab, 2, 16, seed=2)
    want = float(jtf.loss_fn(jcfg, jp, jnp.asarray(tok), dp_axes=()))
    got = float(ttf.loss_fn(tcfg, tp, torch.from_numpy(tok)))
    np.testing.assert_allclose(got, want, rtol=2e-2)


def test_padded_vocab_columns_are_masked_out_of_the_loss():
    """vocab 250 pads to 256: the six pad logits never enter the softmax."""
    import dataclasses

    jcfg, tcfg = configs("starcoder2-3b")
    jcfg, tcfg = (dataclasses.replace(c, vocab=250) for c in (jcfg, tcfg))
    assert tcfg.vocab_padded == 256
    jp = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(3)))
    from repro_torch import convert

    tp = convert.lm_params_from_numpy(jp, tcfg, device="cpu")
    tok = tokens(250, 2, 12, seed=3)
    want = float(jtf.loss_fn(jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(tok), dp_axes=()))
    np.testing.assert_allclose(float(ttf.loss_fn(tcfg, tp, torch.from_numpy(tok))), want,
                               rtol=1e-6)


def test_lm_module_holds_the_tree_under_the_reference_names():
    _, tcfg = configs("deepseek-v3-671b")
    _, tp = both_params("deepseek-v3-671b")
    model = ttf.LM(tcfg, tp)
    names = {k.removeprefix("tree.").replace(".", "/") for k, _ in model.named_parameters()}
    want = set()

    def walk(t, path):
        for k, v in t.items():
            walk(v, f"{path}/{k}") if isinstance(v, dict) else want.add(f"{path}/{k}"[1:])

    walk(tp, "")
    assert names == want
    tok = torch.from_numpy(tokens(tcfg.vocab, 1, 6))
    assert torch.equal(model(tok), ttf.forward(tcfg, tp, tok))
    assert model.params()["moe"]["ffn"]["we1"].data_ptr() == tp["moe"]["ffn"]["we1"].data_ptr()
