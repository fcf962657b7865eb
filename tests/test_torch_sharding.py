"""The port's spec tables against the reference's: ``sanitize_spec`` on a
grid of shapes, specs and meshes, and, for every arch of the registry,
every shape cell and both production meshes ((16, 16) as ("data",
"model"), (2, 16, 16) as ("pod", "data", "model")), ``param_specs``,
``opt_state_specs`` (f32 and 8-bit moments), ``_cache_specs`` and
``input_specs`` (LM, GNN, MIND), leaf by leaf: the same partition spec,
shape, dtype and per-device shard shape (``NamedSharding.shard_shape``).
Both sides are built on abstract meshes (no devices); exact.  Also the
spec → DTensor placement rule, and DTensor layouts on a world of one.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JMesh
from jax.sharding import NamedSharding as JNamed
from jax.sharding import PartitionSpec as JP

import _torch_parity  # noqa: F401  (one torch thread per test worker)
from repro.configs import get_arch as jget
from repro.distributed import sanitize_spec as jsanitize
from repro.models import gnn as jgnn
from repro.models import recsys as jrec
from repro.models import transformer as jtf
from repro.optim import OptConfig as JOpt
from repro.optim import opt_state_specs as jopt_specs
from repro.optim.adamw import Q8State as JQ8
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_arch as tget
from repro_torch.distributed import sanitize_spec
from repro_torch.distributed.sharding import (AbstractMesh, NamedSharding, P,
                                              ShapeDtypeStruct, full, gather_layer, local_call,
                                              placements, unstack_leaf)
from repro_torch.models import gnn as tgnn
from repro_torch.models import recsys as trec
from repro_torch.models import transformer as ttf
from repro_torch.optim import OptConfig
from repro_torch.optim.adamw import Q8State, opt_state_specs

MESHES = {
    "pod": (((16, 16), ("data", "model")), ("data",)),
    "multipod": (((2, 16, 16), ("pod", "data", "model")), ("pod", "data")),
}


def _meshes(name):
    (shape, axes), dp = MESHES[name]
    return JMesh(shape, axes), AbstractMesh(shape, axes), dp


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict/tuple tree; Q8State leaves by field."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, x in enumerate(tree):
            out.update(_flat(x, f"{prefix}/{i}"))
        return out
    if isinstance(tree, (Q8State, JQ8)):
        return {f"{prefix}/.q": tree.q, f"{prefix}/.scale": tree.scale,
                f"{prefix}/.shape": tuple(tree.shape)}
    return {prefix: tree}


def _assert_same_specs(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), sorted(set(g) ^ set(w))
    assert g, "no leaves"
    for k in w:
        if k.endswith("/.shape"):
            assert g[k] == w[k], k
            continue
        a, b = g[k], w[k]
        assert isinstance(a, ShapeDtypeStruct), (k, a)
        assert a.shape == tuple(b.shape), (k, a.shape, b.shape)
        assert _dtype_name(a.dtype) == _dtype_name(b.dtype), (k, a.dtype, b.dtype)
        assert tuple(a.sharding.spec) == tuple(b.sharding.spec), (k, a.sharding.spec,
                                                                 b.sharding.spec)
        assert a.sharding.shard_shape(a.shape) == tuple(b.sharding.shard_shape(b.shape)), k


# ---------------------------------------------------------------------------
# sanitize_spec and the placement rule
# ---------------------------------------------------------------------------

SHAPES = [(16,), (49155, 64), (2708, 1433), (512, 48), (6, 10, 16), (32, 256, 7)]
ENTRIES = [None, "data", "model", "pod", ("data", "model"), ("pod", "data"),
           ("pod", "data", "model")]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sanitize_spec_matches_the_reference(mesh):
    jm, tm, _ = _meshes(mesh)
    names = set(tm.axis_names)
    n = 0
    for shape in SHAPES:
        for spec in itertools.product(ENTRIES, repeat=len(shape)):
            used = [a for e in spec if e for a in ((e,) if isinstance(e, str) else e)]
            if not set(used) <= names:
                continue
            want = jsanitize(jm, shape, spec)
            got = sanitize_spec(tm, shape, spec)
            assert isinstance(got, P)
            assert tuple(got) == tuple(want), (shape, spec, got, want)
            n += 1
    assert n >= 180


def test_spec_entries_normalise_like_the_reference():
    for entries in [(("data",), None), ((), "model"), (["data", "model"],), ("data",)]:
        assert tuple(P(*entries)) == tuple(JP(*entries)), entries


def test_placements_follow_the_spec_in_mesh_order():
    from torch.distributed.tensor import Partial, Replicate, Shard

    m = AbstractMesh((2, 4, 8), ("pod", "data", "model"))
    assert placements(m, P(("data", "model"), None)) == (Replicate(), Shard(0), Shard(0))
    assert placements(m, P(None, "model", "pod")) == (Shard(2), Replicate(), Shard(1))
    assert placements(m, P(), partial=("data",)) == (Replicate(), Partial(), Replicate())
    one = AbstractMesh((1, 4), ("data", "model"))
    assert placements(one, P("data", "model")) == (Replicate(), Shard(1))
    with pytest.raises(ValueError, match="order"):
        placements(m, P(("model", "data")))
    with pytest.raises(ValueError, match="splits two dims"):
        placements(m, P("data", "data"))
    sh = NamedSharding(m, P(("pod", "data"), "model"))
    assert sh.shard_shape((64, 16)) == (8, 2)
    assert sh.shard_shape((64, 16)) == JNamed(JMesh((2, 4, 8), ("pod", "data", "model")),
                                              JP(("pod", "data"), "model")).shard_shape((64, 16))
    with pytest.raises(ValueError):
        sh.shard_shape((12, 16))


def test_plain_tensors_run_the_body_itself():
    """Outside a mesh ``local_call`` is ``fn(*args)``, ``full`` and
    ``gather_layer`` return their input, and a stack unbinds to its views:
    the one-device step runs the sharded step's body unchanged."""
    x, w = torch.randn(4, 3), torch.randn(3, 2)
    got = local_call(lambda a, b: a @ b, (x, {"w": w}["w"]), (P("data", None), P()),
                     P("data", None), partial=("data",))
    assert torch.equal(got, x @ w)
    assert full(got) is got
    stack = torch.randn(3, 2, 2)
    layers = unstack_leaf(stack)
    assert all(gather_layer(t) is t for t in layers)
    assert all(t._base is stack for t in layers)


# ---------------------------------------------------------------------------
# Every arch × shape × production mesh
# ---------------------------------------------------------------------------


def _family(arch):
    return tget(arch).family


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_state_specs_match_the_reference(arch, mesh):
    jm, tm, _ = _meshes(mesh)
    ja, ta = jget(arch), tget(arch)
    if ta.family == "lm":
        pairs = [(jtf.param_specs(ja.model, jm), ttf.param_specs(ta.model, tm))]
    elif ta.family == "gnn":
        feats = sorted({jgnn.effective_graph(s)[2] for s in ja.shapes})
        pairs = [(jgnn.param_specs(ja.model, f, jm), tgnn.param_specs(ta.model, f, tm))
                 for f in feats]
    else:
        pairs = [(jrec.param_specs(ja.model, jm), trec.param_specs(ta.model, tm))]
    for want, got in pairs:
        _assert_same_specs(got, want)
        for quantized in (False, True):
            _assert_same_specs(opt_state_specs(got, OptConfig(quantized=quantized), tm),
                               jopt_specs(want, JOpt(quantized=quantized), jm))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_cache_specs_match_the_reference(arch, mesh):
    jm, tm, dp = _meshes(mesh)
    ja, ta = jget(arch), tget(arch)
    mods = {"lm": (jtf, ttf), "gnn": (jgnn, tgnn), "recsys": (jrec, trec)}[ta.family]
    n = 0
    for js, ts in zip(ja.shapes, ta.shapes):
        assert js.name == ts.name
        for axes in {dp, ("data",)}:
            _assert_same_specs(mods[1].input_specs(ta.model, ts, tm, axes),
                               mods[0].input_specs(ja.model, js, jm, axes))
            n += 1
            if ta.family == "lm" and ts.kind == "decode":
                _assert_same_specs(
                    ttf._cache_specs(ta.model, tm, ts.global_batch, ts.seq_len, axes),
                    jtf._cache_specs(ja.model, jm, js.global_batch, js.seq_len, axes))
    assert n >= len(ta.shapes)


def test_the_reduced_configs_specs_match_on_a_test_mesh():
    """The (2, 2) and (2, 2, 2) meshes of the sharded-step tests."""
    for shape, axes in (((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))):
        jm, tm = JMesh(shape, axes), AbstractMesh(shape, axes)
        for arch in ARCH_IDS:
            ja, ta = jget(arch), tget(arch)
            if ta.family == "lm":
                _assert_same_specs(ttf.param_specs(ta.reduced, tm),
                                   jtf.param_specs(ja.reduced, jm))
            elif ta.family == "gnn":
                _assert_same_specs(tgnn.param_specs(ta.reduced, 8, tm),
                                   jgnn.param_specs(ja.reduced, 8, jm))
            else:
                _assert_same_specs(trec.param_specs(ta.reduced, tm),
                                   jrec.param_specs(ja.reduced, jm))


def test_specs_need_no_devices():
    """A 512-position spec table is host arithmetic: no process group."""
    import torch.distributed as dist

    _, tm, _ = _meshes("multipod")
    specs = ttf.param_specs(tget("deepseek-v3-671b").model, tm)
    leaves = _flat(specs)
    per_dev = sum(np.prod(s.sharding.shard_shape(s.shape)) for s in leaves.values())
    total = sum(np.prod(s.shape) for s in leaves.values())
    assert total / per_dev > 256
    assert not dist.is_initialized() or dist.get_world_size() >= 1
    assert jnp.zeros(()).shape == ()
    assert jax.devices()
