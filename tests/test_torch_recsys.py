"""The MIND recommender of ``repro_torch`` against ``repro``: the behaviour
stream, the embedding bag, the capsule routing, the training loss and its
gradients, the serving and retrieval scores and a three-step train curve,
at the reduced config on the reference's own weights (carried over by
``convert.recsys_params_from_numpy``) and batches of the stream.

Tolerances (elementwise ``|got - want| <= atol_frac·max|want| +
rtol·|want|``):
  * exact: ``BehaviorStream.batch_at`` (the same numpy draws);
  * forwards (bag, capsules, scores): rtol 1e-5, atol 1e-5·max: f32 in
    both, with each package's own summation order in the einsums;
  * the loss rtol 1e-5; gradients rtol 1e-5 with atol 2e-4 of the largest
    gradient of any parameter, the routing logits carrying the gradient
    through every iteration in both.  ``label_att``'s gradient is ~1e-5 of
    the others' at these weights (a near-uniform attention over the
    interests: its terms cancel), and each package alone sits ~0.9 % of
    its own max from an f64 run, so it is held at the tree's scale;
  * three AdamW steps: losses rtol 1e-3 (an Adam step moves a weight with
    a near-zero gradient by ±lr on its sign), and the loss falls.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per test worker)
from _torch_lm_inputs import assert_close
from repro.configs import get_arch as jget_arch
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.data.recsys import BehaviorStream as JBehaviorStream
from repro.models import recsys as jrec
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch import convert
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.recsys import BehaviorStream
from repro_torch.models import recsys as trec
from repro_torch.optim import OptConfig, adamw_init

FWD = dict(rtol=1e-5, atol_frac=1e-5)
GRADS = dict(rtol=1e-5, atol_frac=2e-4)
B = 16  # test_models_smoke.py's batch


def _cfgs():
    return jget_arch("mind").reduced, tget_arch("mind").reduced


@functools.lru_cache(maxsize=None)
def _ref_params_numpy(seed=0):
    jcfg, _ = _cfgs()
    init = jax.jit(jrec.init_params, static_argnums=0)
    return {k: np.asarray(v) for k, v in init(jcfg, jax.random.PRNGKey(seed)).items()}


def _both_params():
    tree = _ref_params_numpy()
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            convert.recsys_params_from_numpy(tree, _cfgs()[1], device="cpu"))


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})


def _stream_batch(step=0, batch=B):
    cfg = _cfgs()[1]
    return BehaviorStream(cfg.n_items, cfg.hist_len, batch, seed=0).batch_at(step)


def _serve_batch(n_cand=32, batch=4):
    b = _stream_batch(batch=batch)
    r = np.random.default_rng(7)
    return {"hist_ids": b["hist_ids"], "hist_mask": b["hist_mask"],
            "cand_ids": r.integers(0, _cfgs()[1].n_items, (batch, n_cand)).astype(np.int32)}


@pytest.mark.parametrize("n_items,hist_len,batch,seed", [(1024, 8, 16, 0), (1 << 21, 50, 5, 3),
                                                         (100, 4, 9, 11)])
def test_behavior_stream_bit_for_bit(n_items, hist_len, batch, seed):
    want_s = JBehaviorStream(n_items, hist_len, batch, seed=seed)
    got_s = BehaviorStream(n_items, hist_len, batch, seed=seed)
    for step in (0, 1, 7, 1000, 1):  # seekable: any order, a step twice
        want, got = want_s.batch_at(step), got_s.batch_at(step)
        assert sorted(got) == sorted(want) == ["hist_ids", "hist_mask", "target_id"]
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        assert got["hist_ids"].min() >= 0 and got["hist_ids"].max() < n_items


def test_param_table_init_and_converters():
    jcfg, tcfg = _cfgs()
    jdefs, tdefs = jrec.param_defs(jcfg), trec.param_defs(tcfg)
    assert sorted(jdefs) == sorted(tdefs) and all(jdefs[k][0] == tdefs[k][0] for k in jdefs)
    params = trec.init_params(tcfg, torch.Generator().manual_seed(0))
    for k, (shape, dt) in tdefs.items():
        assert tuple(params[k].shape) == shape and params[k].dtype == dt
    ref = _ref_params_numpy()
    back = convert.recsys_params_to_numpy(convert.recsys_params_from_numpy(ref, tcfg,
                                                                           device="cpu"))
    assert sorted(back) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k])


def test_embedding_bag_matches():
    jp, tp = _both_params()
    b = _stream_batch()
    want = jrec.embedding_bag(jp["item_table"], jnp.asarray(b["hist_ids"]),
                              jnp.asarray(b["hist_mask"]))
    got = trec.embedding_bag(tp["item_table"], torch.from_numpy(b["hist_ids"]),
                             torch.from_numpy(b["hist_mask"]))
    assert_close(got, want, **FWD)


def test_interests_match():
    jcfg, tcfg = _cfgs()
    jp, tp = _both_params()
    jb, tb = _both(_stream_batch(step=2))
    want = jrec.interests(jcfg, jp, jb["hist_ids"], jb["hist_mask"])
    got = trec.interests(tcfg, tp, tb["hist_ids"], tb["hist_mask"])
    assert tuple(got.shape) == (B, tcfg.n_interests, tcfg.embed_dim)
    assert_close(got, want, **FWD)


def test_train_loss_and_gradients_match():
    """The loss and the gradient of every parameter, the routing's
    bilinear map included (its gradient flows through every iteration's
    routing logits)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _both_params()
    jb, tb = _both(_stream_batch())
    jl, jg = jax.value_and_grad(lambda p: jrec.train_loss(jcfg, p, jb))(jp)
    tl, tg = trec.loss_and_grads(tcfg, tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert sorted(tg) == sorted(jg)
    scale = max(float(jnp.abs(g).max()) for g in jg.values())
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=GRADS["rtol"],
                                   atol=GRADS["atol_frac"] * scale, err_msg=k)


def test_gradients_flow_through_the_routing_logits(monkeypatch):
    """With the routing map scaled up (x10), the routing logits' updates
    move the gradients: the port still equals the reference, and a copy
    whose logits are detached at every iteration differs from both by
    more than the tolerance."""
    jcfg, tcfg = _cfgs()
    jp, tp = _both_params()
    jp = dict(jp, bilinear=jp["bilinear"] * 10)
    tp = dict(tp, bilinear=tp["bilinear"] * 10)
    jb, tb = _both(_stream_batch())
    _, jg = jax.value_and_grad(lambda p: jrec.train_loss(jcfg, p, jb))(jp)
    _, tg = trec.loss_and_grads(tcfg, tp, tb)
    scale = max(float(jnp.abs(g).max()) for g in jg.values())
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=GRADS["rtol"],
                                   atol=GRADS["atol_frac"] * scale, err_msg=k)
    einsum = torch.einsum

    def detached_update(eq, *ops):  # b + stop_gradient(caps · u)
        out = einsum(eq, *ops)
        return out.detach() if eq == "bkd,bld->blk" else out

    monkeypatch.setattr(torch, "einsum", detached_update)
    _, g_detached = trec.loss_and_grads(tcfg, tp, tb)
    off = float((g_detached["item_table"] - tg["item_table"]).abs().max())
    assert off > 4 * GRADS["atol_frac"] * scale


def test_serve_and_retrieval_scores_match():
    jcfg, tcfg = _cfgs()
    jp, tp = _both_params()
    jb, tb = _both(_serve_batch())
    sshape = ShapeSpec(name="s", kind="recsys_serve", batch=4)
    want = jrec.make_step(jcfg, JShapeSpec(name="s", kind="recsys_serve", batch=4))(jp, jb)
    got = trec.make_step(tcfg, sshape)(tp, tb)
    assert tuple(got.shape) == (4, 32) and not got.requires_grad
    assert_close(got, want, **FWD)
    r = np.random.default_rng(8)
    rb = {"hist_ids": _serve_batch()["hist_ids"][:1], "hist_mask": _serve_batch()["hist_mask"][:1],
          "cand_ids": r.integers(0, tcfg.n_items, (100,)).astype(np.int32)}
    jr, tr = _both(rb)
    rshape = dict(name="r", kind="recsys_retrieval", batch=1, n_candidates=100)
    want = jrec.make_step(jcfg, JShapeSpec(**rshape))(jp, jr)
    got = trec.make_step(tcfg, ShapeSpec(**rshape))(tp, tr)
    assert tuple(got.shape) == (100,)
    assert_close(got, want, **FWD)
    assert_close(trec.retrieval_scores(tcfg, tp, tr), jrec.retrieval_scores(jcfg, jp, jr), **FWD)
    assert_close(trec.serve_scores(tcfg, tp, tb), jrec.serve_scores(jcfg, jp, jb), **FWD)


def test_three_train_steps_track_the_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _both_params()
    jb, tb = _both(_stream_batch())
    tshape = dict(name="t", kind="recsys_train", batch=B)
    jopt, opt = JOptConfig(lr=1e-2), OptConfig(lr=1e-2)
    jstep = jax.jit(jrec.make_step(jcfg, JShapeSpec(**tshape), jopt))
    tstep = trec.make_step(tcfg, ShapeSpec(**tshape), opt)
    js, ts = jadamw_init(jp, jopt), adamw_init(tp, opt)
    jl, tl = [], []
    for _ in range(3):
        jp, js, loss = jstep(jp, js, jb)
        jl.append(float(loss))
        tp, ts, loss = tstep(tp, ts, tb)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("bad", [-1, 1024, 5000])
def test_out_of_range_ids_raise(bad):
    """The reference's ``jnp.take`` fills an out-of-range id; the port raises."""
    _, tcfg = _cfgs()
    _, tp = _both_params()
    b = _serve_batch()
    b["cand_ids"][1, 3] = bad
    with pytest.raises(IndexError, match=f"item id {bad} outside"):
        trec.serve_scores(tcfg, tp, _both(b)[1])
    tb = _both(_stream_batch())[1]
    tb["hist_ids"][0, 0] = bad
    with pytest.raises(IndexError):
        trec.loss_and_grads(tcfg, tp, tb)
    with pytest.raises(IndexError):
        trec.embedding_bag(tp["item_table"], torch.tensor([[0, bad]]), torch.ones(1, 2))
