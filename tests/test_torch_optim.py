"""``repro_torch.optim.adamw`` against ``repro.optim.adamw`` on identical
inputs: one AdamW update of f32 and bf16 parameters from a state several
steps in (fp32 and 8-bit moments), the 8-bit block quantizer's write and
read, and the port's counterpart of ``test_quantized_adamw_tracks_fp32``.

Tolerances: f32 results rtol 1e-6 (atol 1e-7·max|want|); a bf16
parameter within one bf16 step of itself (its f32 update may round to
the neighbouring bf16 value); int8 payloads equal up to one quantization
step where the f32 value lies on a rounding boundary, and scales rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401
from _torch_lm_inputs import assert_close
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jadam
from repro_torch import convert
from repro_torch.optim import OptConfig, adamw_init, adamw_update
from repro_torch.optim import adamw as tadam

F32 = dict(rtol=1e-6, atol_frac=1e-7)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _q8_close(got, want):
    """Two Q8States (torch, JAX): scales rtol 1e-6, payloads within one step."""
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-6)
    diff = np.abs(got.q.numpy().astype(np.int32) - np.asarray(want.q).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (diff.max(), (diff > 0).mean())
    assert got.shape == tuple(want.shape)


@pytest.mark.parametrize("sqrt_scale", [False, True])
@pytest.mark.parametrize("shape", [(256, 3), (5, 7), (1000,)])  # (5, 7): one padded block
def test_q8_write_and_read_match(shape, sqrt_scale):
    x = _rand(shape, 1)
    if sqrt_scale:
        x = x * x
    jst = jadam._q8_write(jadam._q8_zeros(shape), jnp.asarray(x), sqrt_scale=sqrt_scale)
    tst = tadam._q8_write(tadam._q8_zeros(shape), torch.from_numpy(x), sqrt_scale=sqrt_scale)
    assert tst.q.dtype == torch.int8 and tst.q.shape == (-(-x.size // 128) * 128,)
    _q8_close(tst, jst)
    # reading the reference's payload back
    same = tadam.Q8State(q=torch.from_numpy(np.array(jst.q)),
                         scale=torch.from_numpy(np.array(jst.scale)), shape=shape)
    assert_close(tadam._q8_read(same, sqrt_scale=sqrt_scale),
                 jadam._q8_read(jst, sqrt_scale=sqrt_scale), **F32)


@pytest.mark.parametrize("size", [1, 255, 257, 100_003])
def test_dequant_is_the_reference_division(size):
    """An 8-bit moment read back is ``q * scale / 127`` divided, bit for bit
    the reference's read (a multiply by 1/127 differs for ~4.5 % of them)."""
    x = _rand((size,), size) * 10.0
    jst = jadam._q8_write(jadam._q8_zeros((size,)), jnp.asarray(x))
    tst = tadam.Q8State(q=torch.from_numpy(np.array(jst.q)),
                        scale=torch.from_numpy(np.array(jst.scale)), shape=(size,))
    got = tadam._q8_read(tst).numpy()
    np.testing.assert_array_equal(got, np.asarray(jadam._q8_read(jst)))
    qs = np.array(jst.q).astype(np.float32).reshape(-1, 128) * np.array(jst.scale)[:, None]
    np.testing.assert_array_equal(got, (qs / np.float32(127)).reshape(-1)[:size])


def test_sqrt_is_correctly_rounded():
    """The update's square root equals numpy's and the reference's (both
    correctly rounded) on a million f32 values, where PyTorch's own f32
    ``sqrt`` need not."""
    x = np.random.default_rng(7).random(1_000_000).astype(np.float32) * 1e-4
    got = tadam._sqrt_(torch.from_numpy(x.copy()))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.sqrt(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.sqrt(jnp.asarray(x))))


def _nearest_f32(x):
    """The f32 nearest the rational ``x`` (one rounding, exact)."""
    from fractions import Fraction

    f = np.float32(float(x))
    near = (np.nextafter(f, np.float32(-1)), f, np.nextafter(f, np.float32(2)))
    return min(near, key=lambda v: abs(Fraction(float(v)) - x))


# counts to 4,000 where the reference's f32 power is one ulp from the
# correctly rounded one (the port's)
REFERENCE_POW_ULP_OFF = {0.9: [], 0.95: [], 0.99: [], 0.999: [2958, 3606]}


@pytest.mark.parametrize("b", sorted(REFERENCE_POW_ULP_OFF))
def test_bias_corrections_match_the_reference(b):
    """``1 - b**count`` for counts 1 to 4,000: the reference's but where the
    reference's own f32 power is one ulp off the correctly rounded value,
    which the port computes (on the card as on the CPU)."""
    from fractions import Fraction

    counts = np.arange(1, 4001, dtype=np.int32)
    got = tadam.bias_corrections(torch.from_numpy(counts), OptConfig(b1=b, b2=b))
    assert got[0].dtype == torch.float32 and torch.equal(got[0], got[1])
    want = np.asarray(jax.jit(lambda c: 1.0 - b ** c.astype(jnp.float32))(jnp.asarray(counts)))
    off = (np.nonzero(got[0].numpy() != want)[0] + 1).tolist()
    assert off == REFERENCE_POW_ULP_OFF[b]
    base = Fraction(float(np.float32(b)))
    for c in off:
        assert got[0][c - 1].item() == np.float32(1) - _nearest_f32(base ** c)
    one = tadam.bias_corrections(torch.tensor(3, dtype=torch.int32), OptConfig(b1=b, b2=b))
    assert one[0].shape == () and one[0].item() == got[0][2].item()


def _state_pair(params_np, quantized, count):
    """A state several steps in, in both packages: random moments (v >= 0)."""
    mu = {}
    for k, p in params_np.items():
        m, v = _rand(p.shape, 20 + len(k), 0.1), _rand(p.shape, 30 + len(k), 0.1) ** 2
        if quantized:
            m = jadam._q8_write(jadam._q8_zeros(p.shape), jnp.asarray(m))
            v = jadam._q8_write(jadam._q8_zeros(p.shape), jnp.asarray(v), sqrt_scale=True)
        mu[k] = {"m": m, "v": v}
    jstate = {"mu": jax.tree.map(jnp.asarray, mu), "count": jnp.int32(count)}
    tstate = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    return jstate, tstate


@pytest.mark.parametrize("quantized", [False, True])
def test_adamw_update_matches_on_identical_gradients(quantized):
    pnp = {"w": _rand((64, 48), 1), "b": _rand((48,), 2), "stack": _rand((3, 16, 8), 3)}
    gnp = {k: _rand(v.shape, 10 + i, 0.01) for i, (k, v) in enumerate(sorted(pnp.items()))}
    gnp["w"][:4] = 0.0  # zero gradients: only the decay and the momentum move them
    cfg = dict(lr=1e-2, weight_decay=0.1, quantized=quantized)
    jstate, tstate = _state_pair(pnp, quantized, count=3)
    jp, js = jadam.adamw_update({k: jnp.asarray(v) for k, v in pnp.items()},
                                {k: jnp.asarray(v) for k, v in gnp.items()}, jstate,
                                JOptConfig(**cfg))
    tp = {k: torch.from_numpy(v.copy()) for k, v in pnp.items()}
    tg = {k: torch.from_numpy(v) for k, v in gnp.items()}
    tg["stack"] = list(tg["stack"].unbind(0))  # a stack's gradient as its layer slices
    tp2, ts = adamw_update(tp, tg, tstate, OptConfig(**cfg))
    assert tp2 is tp and int(ts["count"]) == int(js["count"]) == 4
    for k in pnp:
        assert_close(tp[k], jp[k], **F32, what=k)
        if quantized:
            _q8_close(ts["mu"][k]["m"], js["mu"][k]["m"])
            _q8_close(ts["mu"][k]["v"], js["mu"][k]["v"])
        else:
            assert_close(ts["mu"][k]["m"], js["mu"][k]["m"], **F32, what=f"{k}/m")
            assert_close(ts["mu"][k]["v"], js["mu"][k]["v"], **F32, what=f"{k}/v")


def test_adamw_update_of_bf16_params_matches():
    p = _rand((32, 40), 4)
    g = _rand((32, 40), 5, 0.01)
    jstate, tstate = _state_pair({"w": p}, False, count=1)
    jp, _ = jadam.adamw_update({"w": jnp.asarray(p, jnp.bfloat16)},
                               {"w": jnp.asarray(g, jnp.bfloat16)}, jstate, JOptConfig())
    tp = {"w": torch.from_numpy(p).bfloat16()}
    adamw_update(tp, {"w": torch.from_numpy(g).bfloat16()}, tstate, OptConfig())
    assert tp["w"].dtype == torch.bfloat16
    want = np.asarray(jp["w"]).astype(np.float32)
    got = tp["w"].float().numpy()
    step = np.abs(want) * 2.0 ** -7  # one bf16 step at each value
    assert (np.abs(got - want) <= step).all()
    assert (got == want).mean() > 0.99


def test_adamw_init_matches():
    shapes = {"a": (3, 5), "b": (130,)}
    for quantized in (False, True):
        js = jadam.adamw_init({k: jnp.zeros(s) for k, s in shapes.items()},
                              JOptConfig(quantized=quantized))
        ts = adamw_init({k: torch.zeros(s) for k, s in shapes.items()},
                        OptConfig(quantized=quantized))
        assert int(ts["count"]) == 0 and ts["count"].dtype == torch.int32
        for k in shapes:
            for mv in ("m", "v"):
                j, t = js["mu"][k][mv], ts["mu"][k][mv]
                if quantized:
                    assert t.q.shape == j.q.shape and t.scale.shape == j.scale.shape
                    assert t.shape == j.shape
                else:
                    assert t.shape == j.shape and t.dtype == torch.float32


def test_quantized_adamw_tracks_fp32():
    """8-bit Adam stays close to fp32 Adam over a few steps (the reference's
    test, in the port)."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(256, 64)).astype(np.float32)
    cfg_f = OptConfig(lr=1e-2, quantized=False, weight_decay=0.0)
    cfg_q = OptConfig(lr=1e-2, quantized=True, weight_decay=0.0)
    pf, pq = {"w": torch.from_numpy(p0.copy())}, {"w": torch.from_numpy(p0.copy())}
    sf, sq = adamw_init(pf, cfg_f), adamw_init(pq, cfg_q)
    for _ in range(5):
        g = torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32)) * 0.1
        adamw_update(pf, {"w": g}, sf, cfg_f)
        adamw_update(pq, {"w": g}, sq, cfg_q)
    diff = float((pf["w"] - pq["w"]).abs().max())
    scale = float((pf["w"] - torch.from_numpy(p0)).abs().max())
    assert diff < 0.15 * scale, (diff, scale)
