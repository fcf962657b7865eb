"""The GNN family of ``repro_torch`` against ``repro``: every forward pass
(GraphSAGE full and sampled, GatedGCN, SchNet single and batched,
GraphCast), every cell's train step (loss, gradients, three AdamW steps),
``effective_graph``, the RBF centres and softplus, ``sample_neighbors`` and
the Steiner-sampled example, at the reduced configs and the sizes of
tests/test_models_smoke.py, on the reference's own weights (carried over by
``convert.gnn_params_from_numpy``) and the same numpy inputs from a seed.

Tolerances (elementwise ``|got - want| <= atol_frac·max|want| +
rtol·|want|``):
  * forwards: rtol 1e-5, atol 1e-5·max.  Both run in f32 and sum the
    messages of a destination row in different orders (XLA's segment sum,
    torch's ``index_add``), so they agree to f32 rounding of a few sums,
    not bit for bit;
  * losses rtol 1e-5 on one step; gradients, read as the first moment
    m = (1 - b1)·g after one step at lr 0, rtol 1e-5 with atol 2e-4·max|m|
    (the backward adds a row's gradients in each package's own order, and
    GatedGCN's bf16 edge carry turns a last-bit difference before the
    rounding into a whole bf16 step for a few elements);
  * three AdamW steps: losses rtol 1e-3 (an Adam step moves a weight with
    a near-zero gradient by ±lr on its sign), and the loss falls;
  * exact: ``effective_graph``, the RBF centres (``jnp.linspace``),
    ``sample_neighbors`` and the example's Steiner totals and subgraphs.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per test worker)
from _torch_lm_inputs import assert_close, assert_tree_close
from repro.configs import get_arch as jget_arch
from repro.configs.base import GNN_SHAPES as JGNN_SHAPES
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.data import graphs as jgraphs
from repro.models import gnn as jgnn
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch import convert
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs.base import GNN_SHAPES, ShapeSpec
from repro_torch.data import graphs as tgraphs
from repro_torch.models import gnn as tgnn
from repro_torch.optim import OptConfig, adamw_init

ROOT = Path(__file__).resolve().parents[1]
FWD = dict(rtol=1e-5, atol_frac=1e-5)
GRADS = dict(rtol=1e-5, atol_frac=2e-4)
GNN_IDS = ("graphsage-reddit", "graphcast", "schnet", "gatedgcn")
# (arch, shape kind): the cells of test_models_smoke.py's GNN smoke test
CELLS = [("graphsage-reddit", "gnn_full"), ("graphsage-reddit", "gnn_sampled"),
         ("gatedgcn", "gnn_full"), ("schnet", "gnn_full"), ("schnet", "gnn_batched"),
         ("graphcast", "gnn_full")]
SMOKE = dict(name="smoke", n_nodes=24, n_edges=80, d_feat=16, batch_nodes=8,
             fanout=(3, 2), graph_batch=4)


def _configs(arch):
    return jget_arch(arch).reduced, tget_arch(arch).reduced


@functools.lru_cache(maxsize=None)
def _ref_params_numpy(arch, d_feat, seed=0):
    jcfg, _ = _configs(arch)
    init = jax.jit(jgnn.init_params, static_argnums=(0, 1))
    return jax.tree.map(np.asarray, init(jcfg, d_feat, jax.random.PRNGKey(seed)))


def _both_params(arch, d_feat):
    tree = _ref_params_numpy(arch, d_feat)
    _, tcfg = _configs(arch)
    return (jax.tree.map(jnp.asarray, tree),
            convert.gnn_params_from_numpy(tree, tcfg, d_feat, device="cpu"))


def _batch_numpy(cfg, kind):
    """test_models_smoke.py's ``_gnn_batch`` as numpy arrays."""
    r = np.random.default_rng(0)
    N, E, F = SMOKE["n_nodes"], SMOKE["n_edges"], SMOKE["d_feat"]
    f32 = np.float32
    edges = r.integers(0, N, (E, 2)).astype(np.int32)
    if cfg.kind == "sage" and kind == "gnn_sampled":
        B = SMOKE["batch_nodes"]
        f1, f2 = SMOKE["fanout"]
        return {"feats": (r.normal(size=(B, F)).astype(f32),
                          r.normal(size=(B * f1, F)).astype(f32),
                          r.normal(size=(B * f1 * f2, F)).astype(f32)),
                "labels": r.integers(0, cfg.n_classes, B).astype(np.int32)}
    if cfg.kind == "sage":
        return {"x": r.normal(size=(N, F)).astype(f32), "edges": edges,
                "labels": r.integers(0, cfg.n_classes, N).astype(np.int32)}
    if cfg.kind == "gatedgcn":
        return {"x": r.normal(size=(N, F)).astype(f32), "edges": edges,
                "ew": r.uniform(size=(E,)).astype(f32),
                "labels": r.integers(0, cfg.n_classes, N).astype(np.int32)}
    if cfg.kind == "schnet":
        if kind == "gnn_batched":
            G = SMOKE["graph_batch"]
            return {"z": r.normal(size=(G, N, F)).astype(f32),
                    "pos": r.normal(size=(G, N, 3)).astype(f32), "edges_t": edges,
                    "energy": r.normal(size=(G,)).astype(f32)}
        return {"x": r.normal(size=(N, F)).astype(f32), "pos": r.normal(size=(N, 3)).astype(f32),
                "edges": edges, "energy_sum": np.float32(1.0)}
    nm = N // 4 + 1
    em = min(E, 8 * nm)
    return {"x": r.normal(size=(N, F)).astype(f32),
            "g2m": np.stack([r.integers(0, N, E), r.integers(0, nm, E)], 1).astype(np.int32),
            "mesh_e": r.integers(0, nm, (em, 2)).astype(np.int32),
            "m2g": np.stack([r.integers(0, nm, E), r.integers(0, N, E)], 1).astype(np.int32),
            "target": r.normal(size=(N, cfg.n_vars)).astype(f32)}


def _both_batches(cfg, kind):
    b = _batch_numpy(cfg, kind)

    def conv(fn):
        return {k: tuple(fn(a) for a in v) if isinstance(v, tuple) else fn(v)
                for k, v in b.items()}

    return conv(jnp.asarray), conv(lambda a: torch.from_numpy(np.array(a)))


def _shapes(kind):
    return JShapeSpec(kind=kind, **SMOKE), ShapeSpec(kind=kind, **SMOKE)


# ---------------------------------------------------------------------------
# parameters, configs and small pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", GNN_IDS)
def test_param_table_and_init_match_the_reference(arch):
    jcfg, tcfg = _configs(arch)
    jdefs, tdefs = jgnn.param_defs(jcfg, 16), tgnn.param_defs(tcfg, 16)
    assert sorted(jdefs) == sorted(tdefs)
    assert all(jdefs[k][0] == tdefs[k][0] for k in jdefs)
    params = tgnn.init_params(tcfg, 16, torch.Generator().manual_seed(0))
    ref = _ref_params_numpy(arch, 16)
    assert jax.tree.structure(ref) == jax.tree.structure(
        jax.tree.map(lambda t: 0, params, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    for name, (shape, _) in tdefs.items():
        leaf = functools.reduce(lambda d, k: d[k], name.split("."), params)
        assert tuple(leaf.shape) == shape and leaf.dtype == torch.float32
        if name.endswith(("ln_n", "ln_e")):
            assert bool((leaf == 1).all())
        else:  # normal / sqrt(fan_in), as the reference draws them
            assert abs(float(leaf.std()) * shape[0] ** 0.5 - 1) < 0.6
    back = convert.gnn_params_to_numpy(convert.gnn_params_from_numpy(ref, tcfg, 16,
                                                                     device="cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="the config wants"):
        convert.gnn_params_from_numpy(ref, dataclasses.replace(tcfg, d_hidden=8), 16,
                                      device="cpu")


@pytest.mark.parametrize("shape", list(GNN_SHAPES) + [ShapeSpec(kind=k, **SMOKE) for k in
                                                      ("gnn_full", "gnn_sampled",
                                                       "gnn_batched")],
                         ids=lambda s: f"{s.name}-{s.kind}")
def test_effective_graph_matches(shape):
    jshape = JShapeSpec(**dataclasses.asdict(shape))
    assert tgnn.effective_graph(shape) == jgnn.effective_graph(jshape)


def test_effective_graph_of_the_cells():
    got = {s.name: tgnn.effective_graph(s) for s in GNN_SHAPES}
    assert got == {"full_graph_sm": (3072, 10752, 1433),
                   "minibatch_lg": (169984, 168960, 602),
                   "ogb_products": (2449408, 61859328, 100),
                   "molecule": (4096, 8192, 16)}
    assert [s.name for s in JGNN_SHAPES] == list(got)


@pytest.mark.parametrize("arch", ["schnet"])
@pytest.mark.parametrize("which", ["model", "reduced"])
def test_rbf_centres_equal_jnp_linspace(arch, which):
    cfg = getattr(tget_arch(arch), which)
    want = np.asarray(jnp.linspace(0.0, cfg.cutoff, cfg.rbf, dtype=jnp.float32))
    np.testing.assert_array_equal(tgnn.rbf_centers(cfg).numpy(), want)


def test_softplus_and_layer_norm_match():
    x = np.concatenate([np.linspace(-40, 40, 161), [0.0, 1e-8, 19.9, 20.1, 88.0]])
    x = x.astype(np.float32)
    assert_close(tgnn.softplus(torch.from_numpy(x)), jax.nn.softplus(jnp.asarray(x)),
                 rtol=1e-6, atol_frac=0.0)
    # its gradient is the sigmoid, as jax.nn.softplus's (logaddexp's custom JVP)
    tx = torch.from_numpy(x).requires_grad_()
    tgnn.softplus(tx).sum().backward()
    assert_close(tx.grad, jax.grad(lambda v: jnp.sum(jax.nn.softplus(v)))(jnp.asarray(x)),
                 rtol=1e-6, atol_frac=1e-7)
    a = (np.random.default_rng(3).normal(size=(7, 70)) * 5 + 2).astype(np.float32)
    s = np.random.default_rng(4).normal(size=(70,)).astype(np.float32)
    assert_close(tgnn._ln(torch.from_numpy(a), torch.from_numpy(s)),
                 jgnn._ln(jnp.asarray(a), jnp.asarray(s)), **FWD)


def test_seg_mean_matches():
    r = np.random.default_rng(5)
    msg = r.normal(size=(50, 6)).astype(np.float32)
    dst = r.integers(0, 9, 50).astype(np.int32)
    dst[dst == 4] = 5  # an empty segment: its mean is 0
    want = jgnn.seg_mean(jnp.asarray(msg), jnp.asarray(dst), 12)
    got = tgnn.seg_mean(torch.from_numpy(msg), torch.from_numpy(dst), 12)
    assert_close(got, want, **FWD)
    assert float(got[4].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _forwards(arch, kind):
    jcfg, tcfg = _configs(arch)
    jp, tp = _both_params(arch, SMOKE["d_feat"])
    jb, tb = _both_batches(tcfg, kind)
    if tcfg.kind == "sage" and kind == "gnn_sampled":
        return (jgnn.sage_forward_sampled(jcfg, jp, jb["feats"]),
                tgnn.sage_forward_sampled(tcfg, tp, tb["feats"]))
    if tcfg.kind == "sage":
        return (jgnn.sage_forward_full(jcfg, jp, jb["x"], jb["edges"]),
                tgnn.sage_forward_full(tcfg, tp, tb["x"], tb["edges"]))
    if tcfg.kind == "gatedgcn":
        return (jgnn.gatedgcn_forward(jcfg, jp, jb["x"], jb["edges"], jb["ew"]),
                tgnn.gatedgcn_forward(tcfg, tp, tb["x"], tb["edges"], tb["ew"]))
    if tcfg.kind == "schnet" and kind == "gnn_batched":
        want = jax.vmap(lambda z, p: jgnn.schnet_forward(jcfg, jp, z, p, jb["edges_t"]))(
            jb["z"], jb["pos"])
        return want, tgnn.schnet_forward(tcfg, tp, tb["z"], tb["pos"], tb["edges_t"])
    if tcfg.kind == "schnet":
        return (jgnn.schnet_forward(jcfg, jp, jb["x"], jb["pos"], jb["edges"]),
                tgnn.schnet_forward(tcfg, tp, tb["x"], tb["pos"], tb["edges"]))
    nm = SMOKE["n_nodes"] // 4 + 1
    return (jgnn.graphcast_forward(jcfg, jp, jb["x"], jb["g2m"], jb["mesh_e"], jb["m2g"], nm),
            tgnn.graphcast_forward(tcfg, tp, tb["x"], tb["g2m"], tb["mesh_e"], tb["m2g"], nm))


@pytest.mark.parametrize("arch,kind", CELLS)
def test_forward_matches(arch, kind):
    want, got = _forwards(arch, kind)
    assert tuple(got.shape) == tuple(want.shape)
    assert bool(torch.isfinite(got).all())
    assert_close(got, want, **FWD, what=f"{arch} {kind}")


def test_gatedgcn_edge_carry_is_rounded_to_bf16():
    """The layer's edge state leaves it as bf16 values held in f32, and its
    gradient passes through the same rounding."""
    _, tcfg = _configs("gatedgcn")
    _, tp = _both_params("gatedgcn", SMOKE["d_feat"])
    _, tb = _both_batches(tcfg, "gnn_full")
    seen = []
    orig = tgnn._ln

    def spy(x, scale, eps=1e-5):
        if scale is tp["l1"]["ln_e"]:
            seen.append(x)
        return orig(x, scale, eps)

    tgnn._ln = spy
    try:
        with torch.no_grad():
            tgnn.gatedgcn_forward(tcfg, tp, tb["x"], tb["edges"], tb["ew"])
    finally:
        tgnn._ln = orig
    assert seen  # layer 1's edge input came from layer 0's rounded carry
    e = torch.ones(3, 4, requires_grad=True)
    y = e.to(torch.bfloat16).to(torch.float32)
    (y * torch.tensor(1.0 + 2.0 ** -12)).sum().backward()
    assert bool((e.grad == 1.0).all())  # the f32 cotangent rounded to bf16, as in JAX


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


def _ref_step(jcfg, kind, lr):
    jshape, _ = _shapes(kind)
    opt = JOptConfig(lr=lr)
    return jax.jit(jgnn.make_train_step(jcfg, jshape, opt)), opt


@pytest.mark.parametrize("arch,kind", CELLS)
def test_train_step_loss_and_gradients_match(arch, kind):
    """One step at lr 0: the loss, and the gradients as m = 0.1·g."""
    jcfg, tcfg = _configs(arch)
    jp, tp = _both_params(arch, SMOKE["d_feat"])
    jb, tb = _both_batches(tcfg, kind)
    jstep, jopt = _ref_step(jcfg, kind, 0.0)
    _, jstate, jloss = jstep(jp, jadamw_init(jp, jopt), jb)
    opt = OptConfig(lr=0.0)
    _, tshape = _shapes(kind)
    _, tstate, tloss = tgnn.make_train_step(tcfg, tshape, opt)(tp, adamw_init(tp, opt), tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = jax.tree.map(np.asarray, jstate["mu"])
    assert_tree_close({k: v for k, v in _moments(tstate["mu"], "m").items()},
                      _moments(want, "m"), **GRADS)


def _moments(tree, which):
    if isinstance(tree, dict) and "m" in tree and "v" in tree:
        return tree[which]
    return {k: _moments(v, which) for k, v in tree.items()}


@pytest.mark.parametrize("arch,kind", CELLS)
def test_three_adamw_steps_track_the_reference(arch, kind):
    jcfg, tcfg = _configs(arch)
    jp, tp = _both_params(arch, SMOKE["d_feat"])
    jb, tb = _both_batches(tcfg, kind)
    jstep, jopt = _ref_step(jcfg, kind, 1e-3)
    jstate = jadamw_init(jp, jopt)
    opt = OptConfig(lr=1e-3)
    _, tshape = _shapes(kind)
    tstep, tstate = tgnn.make_train_step(tcfg, tshape, opt), adamw_init(tp, opt)
    jl, tl = [], []
    for _ in range(3):
        jp, jstate, loss = jstep(jp, jstate, jb)
        jl.append(float(loss))
        tp, tstate, loss = tstep(tp, tstate, tb)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]
    assert int(tstate["count"]) == 3


def test_loss_and_grads_leave_params_untouched():
    _, tcfg = _configs("graphsage-reddit")
    _, tp = _both_params("graphsage-reddit", SMOKE["d_feat"])
    _, tb = _both_batches(tcfg, "gnn_full")
    before = {k: v.clone() for k, v in tp["l0"].items()}
    _, tshape = _shapes("gnn_full")
    loss, grads = tgnn.loss_and_grads(tcfg, tshape, tp, tb)
    assert not loss.requires_grad and sorted(grads) == sorted(tp)
    assert all(torch.equal(before[k], tp["l0"][k]) for k in before)
    assert not any(t.requires_grad for t in tp["l0"].values())


# ---------------------------------------------------------------------------
# neighbour sampling and the Steiner-sampled example
# ---------------------------------------------------------------------------


def _csr_with_isolated(seed, iso):
    """An RMAT graph with every edge of the vertices ``iso`` dropped, as
    both packages' CSR (which must be equal)."""
    src, dst, _, n = jgraphs.rmat_edges(7, 4, seed=seed)
    keep = ~np.isin(src, iso) & ~np.isin(dst, iso)
    src, dst = src[keep], dst[keep]
    jptr, jidx = jgraphs.build_csr(n, src, dst)
    tptr, tidx = tgraphs.build_csr(n, src, dst)
    np.testing.assert_array_equal(tptr, jptr)
    np.testing.assert_array_equal(tidx, jidx)
    return n, jptr, jidx


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_neighbors_bit_for_bit(seed):
    """Three fanouts in a row under one generator state, with zero-degree
    vertices sampling themselves: the port's (F, fanout) draw against the
    reference called on each frontier vertex in turn (the reference's
    bound broadcasts only for one-vertex frontiers; see the port's
    docstring)."""
    iso = np.array([3, 40, 77])
    n, indptr, indices = _csr_with_isolated(seed, iso)
    frontier = np.concatenate([np.arange(0, n, 7), iso]).astype(np.int32)
    jr, tr = np.random.default_rng(seed + 10), np.random.default_rng(seed + 10)
    for fanout in (5, 3, 1):
        want = np.concatenate([jgraphs.sample_neighbors(indptr, indices, frontier[i:i + 1],
                                                        fanout, jr)
                               for i in range(len(frontier))])
        got = tgraphs.sample_neighbors(indptr, indices, frontier, fanout, tr)
        assert got.dtype == want.dtype == np.int32 and got.shape == (len(frontier), fanout)
        np.testing.assert_array_equal(got, want)
        is_iso = np.isin(frontier, iso)
        np.testing.assert_array_equal(got[is_iso], np.repeat(frontier[is_iso, None], fanout, 1))
        for v, row in zip(frontier[~is_iso], got[~is_iso]):  # real neighbours
            assert set(row) <= set(indices[indptr[v]:indptr[v + 1]])
        frontier = got[:, 0]
    assert jr.integers(1 << 30) == tr.integers(1 << 30)  # the same draws consumed


def test_sample_neighbors_isolated_last_vertex_and_empty_graph():
    n, indptr, indices = _csr_with_isolated(2, np.array([127]))
    assert indptr[127] == indptr[128] == len(indices)
    got = tgraphs.sample_neighbors(indptr, indices, np.array([127, 0], np.int32), 4,
                                   np.random.default_rng(0))
    assert got[0].tolist() == [127] * 4
    empty = tgraphs.sample_neighbors(np.zeros(5, np.int64), np.zeros(0, np.int32),
                                     np.array([1, 3], np.int32), 2, np.random.default_rng(0))
    assert empty.tolist() == [[1, 1], [3, 3]]


def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_gnn_steiner_sampling", ROOT / "examples" / "torch_gnn_steiner_sampling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_example_loop(steps):
    """examples/gnn_steiner_sampling.py's loop, kept as records."""
    spec = importlib.util.spec_from_file_location(
        "gnn_steiner_sampling", ROOT / "examples" / "gnn_steiner_sampling.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    from repro.core import from_edges

    rng = np.random.default_rng(0)
    src, dst, w, n = jgraphs.rmat_edges(11, 8, max_weight=50, seed=3)
    g = from_edges(src, dst, w, n, pad_to=64)
    feats = rng.normal(size=(n, 16)).astype(np.float32)
    labels = (np.arange(n) * 2654435761 % 5).astype(np.int32)
    cfg = jget_arch("graphsage-reddit").reduced
    params = jax.tree.map(jnp.asarray, _ref_params_numpy("graphsage-reddit", 16))
    opt_cfg = JOptConfig(lr=1e-2)
    opt_state = jadamw_init(params, opt_cfg)
    out = []
    for _ in range(steps):
        seeds = rng.choice(n, size=12, replace=False).astype(np.int32)
        verts, sub_edges, D = ref.steiner_subgraph(g, src, dst, seeds, n)
        shape = JShapeSpec(name="steiner_batch", kind="gnn_full", n_nodes=len(verts),
                           n_edges=len(sub_edges), d_feat=16)
        train = jax.jit(jgnn.make_train_step(cfg, shape, opt_cfg))
        batch = {"x": jnp.asarray(feats[verts]), "edges": jnp.asarray(sub_edges),
                 "labels": jnp.asarray(labels[verts])}
        params, opt_state, loss = train(params, opt_state, batch)
        out.append((verts, sub_edges, D, float(loss)))
    return out


def test_steiner_sampled_example_matches_the_reference():
    """The example's 8 steps on the CPU from the reference's weights: the
    Steiner totals and subgraphs bit for bit, the losses within rtol 1e-3,
    and the loss falls."""
    mod = _example()
    from repro_torch.core.graph import from_edges

    rng = np.random.default_rng(0)
    src, dst, w, n = tgraphs.rmat_edges(11, 8, max_weight=50, seed=3)
    g = from_edges(src, dst, w, n, pad_to=64, device="cpu")
    feats = torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32))
    labels = torch.from_numpy((np.arange(n) * 2654435761 % 5).astype(np.int32))
    cfg = tget_arch("graphsage-reddit").reduced
    _, params = _both_params("graphsage-reddit", 16)
    got = mod.train_on_steiner_subgraphs(
        g, torch.from_numpy(src), torch.from_numpy(dst), n, feats, labels, cfg, params,
        OptConfig(lr=1e-2), rng, steps=8, log=lambda *_: None)
    want = _reference_example_loop(8)
    for step, (r, (verts, sub_edges, D, loss)) in enumerate(zip(got, want)):
        assert r["D"] == D, step
        np.testing.assert_array_equal(r["verts"].numpy(), verts)
        np.testing.assert_array_equal(r["edges"].numpy(), sub_edges)
        assert r["edges"].dtype == torch.int32
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-3, err_msg=f"step {step}")
    assert got[-1]["loss"] < got[0]["loss"]


def test_scatter_sum_keeps_only_its_index_for_the_backward():
    """The messages are not saved for the backward (a 31.7 GB tensor at
    ogb_products' size); its gradient is the gather of the incoming one,
    batched over leading axes as SchNet's molecules are."""
    r = np.random.default_rng(6)
    dst = torch.from_numpy(r.integers(0, 9, 40).astype(np.int32))
    saved = []
    msg = torch.from_numpy(r.normal(size=(3, 40, 5))).requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        out = tgnn.scatter_sum(msg, dst, 9)
    assert [tuple(t.shape) for t in saved] == [(40,)]
    want = jax.ops.segment_sum(jnp.asarray(msg.detach().numpy()[1]), jnp.asarray(dst.numpy()), 9)
    assert_close(out[1], want, **FWD)
    assert torch.autograd.gradcheck(lambda m: tgnn.scatter_sum(m, dst, 9), (msg,))
