"""``repro_torch.checkpoint`` and ``repro_torch.launch.train`` against the
reference: a checkpoint written by either package restores in the other
bit for bit (LM parameters in bf16, fp32 and 8-bit optimizer state, a bf16
scalar, the int32 step count), the rolling manager keeps the newest and
skips a torn manifest, and the port's ``train()`` resumes after an injected
crash to the uninterrupted run's final loss, as the reference's
``test_crash_restart_resumes_to_same_loss``.

Tolerance: exact everywhere (bf16 compared as its bits), but the resumed
loss, held at the reference test's rtol 1e-4 (it is equal on the CPU).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401
from _torch_lm_inputs import configs, ref_params_numpy
from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import load_pytree as jload
from repro.checkpoint import save_pytree as jsave
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.models import transformer as ttf
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.optim.adamw import Q8State


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes (bf16 as its 16 bits), for exact comparison."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().copy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.kind == "V" else a


def _assert_same_state(t, j, path=""):
    """A port tree (tensors, Q8States) equal to a reference tree, bit for bit."""
    if isinstance(j, dict):
        assert sorted(t) == sorted(j), path
        for k in j:
            _assert_same_state(t[k], j[k], f"{path}/{k}")
    elif hasattr(j, "scale"):
        assert isinstance(t, Q8State) and t.shape == tuple(j.shape), path
        _assert_same_state(t.q, j.q, f"{path}/.q")
        _assert_same_state(t.scale, j.scale, f"{path}/.scale")
    else:
        a, b = _bits(t), _bits(j)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


def _reference_state(quantized):
    """The reference's state of a reduced starcoder2 (bf16) one step in, and
    the port's template of the same structure."""
    arch = "starcoder2-3b"
    jcfg, tcfg = configs(arch, "bfloat16")
    params = jax.tree.map(jnp.asarray, ref_params_numpy(arch, "bfloat16"))
    opt = JOptConfig(quantized=quantized)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, opt_state = jadamw_update(params, grads, jadamw_init(params, opt), opt)
    jtree = {"params": params, "opt": opt_state, "scalar": jnp.bfloat16(2.5)}
    tparams = ttf.init_params(tcfg, torch.Generator().manual_seed(0))
    template = {"params": tparams, "opt": adamw_init(tparams, OptConfig(quantized=quantized)),
                "scalar": torch.zeros((), dtype=torch.bfloat16)}
    return jtree, template


@pytest.mark.parametrize("quantized", [False, True])
def test_reference_checkpoint_restores_in_the_port(tmp_path, quantized):
    jtree, template = _reference_state(quantized)
    jsave(jtree, tmp_path / "ref.npz")
    back = load_pytree(template, tmp_path / "ref.npz")
    _assert_same_state(back, jtree)
    assert back["params"]["dense"]["attn"]["wq"].dtype == torch.bfloat16
    assert int(back["opt"]["count"]) == 1


@pytest.mark.parametrize("quantized", [False, True])
def test_port_checkpoint_restores_in_the_reference(tmp_path, quantized):
    jtree, template = _reference_state(quantized)
    jsave(jtree, tmp_path / "ref.npz")
    port = load_pytree(template, tmp_path / "ref.npz")
    save_pytree(port, tmp_path / "port.npz")
    with np.load(tmp_path / "ref.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)  # the same keys, e.g. .../m/.q
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = jload(jtree, tmp_path / "port.npz")
    _assert_same_state(port, back)


def test_managers_restore_each_others_latest_step(tmp_path):
    jmgr = JManager(tmp_path / "j", keep=2)
    for s in (3, 5):
        jmgr.save(s, {"w": jnp.full((4,), s, jnp.bfloat16), "n": jnp.int32(s)}, blocking=True)
    step, st = CheckpointManager(tmp_path / "j").restore(
        {"w": torch.zeros(4, dtype=torch.bfloat16), "n": torch.zeros((), dtype=torch.int32)})
    assert step == 5 and float(st["w"][0]) == 5.0 and int(st["n"]) == 5
    CheckpointManager(tmp_path / "t").save(7, st, blocking=True)
    step, back = JManager(tmp_path / "t").restore({"w": jnp.zeros((4,), jnp.bfloat16),
                                                   "n": jnp.int32(0)})
    assert step == 7 and float(back["w"][0]) == 5.0 and back["w"].dtype == jnp.bfloat16


def test_manager_rolling_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (10, 20, 30):
        mgr.save(s, {"w": torch.full((4,), float(s))}, blocking=True)
    assert mgr.latest_step() == 30
    assert sorted(mgr.steps()) == [20, 30]  # rolled
    step, st = mgr.restore({"w": torch.zeros(4)})
    assert step == 30 and float(st["w"][0]) == 30


def test_save_snapshots_before_the_next_in_place_update(tmp_path):
    mgr = CheckpointManager(tmp_path)
    w = torch.zeros(1000)
    mgr.save(1, {"w": w})
    w.add_(1.0)  # the next step's in-place update, while the writer may run
    mgr.wait()
    _, st = mgr.restore({"w": torch.empty(1000)})
    assert float(st["w"].abs().max()) == 0.0


def test_torn_manifest_is_skipped(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.ones(3)}, blocking=True)
    mgr.save(2, {"w": torch.full((3,), 2.0)}, blocking=True)
    (tmp_path / "step_0000000002" / "manifest.json").write_text('{"step": 2, "comp')
    assert mgr.steps() == [1] and mgr.latest_step() == 1
    (tmp_path / "step_0000000002" / "manifest.json").write_text(json.dumps({"step": 2}))
    assert mgr.latest_step() == 1  # not marked complete
    step, st = mgr.restore({"w": torch.zeros(3)})
    assert step == 1 and float(st["w"][0]) == 1.0


def test_restore_onto_a_device_and_dtype_of_the_template(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.tensor(1.5, dtype=torch.bfloat16)}
    save_pytree(tree, tmp_path / "x.npz")
    back = load_pytree(tree, tmp_path / "x.npz", device="cpu")
    assert torch.equal(back["a"], tree["a"]) and back["b"].dtype == torch.bfloat16
    assert back["b"].shape == () and float(back["b"]) == 1.5
    with np.load(tmp_path / "x.npz") as z:
        assert z["b"].dtype == np.uint8 and z["b"].shape == (2,)


def test_crash_restart_resumes_to_same_loss(tmp_path):
    """The port's train() at the reduced starcoder2 on the CPU: a job killed
    at step 17 and relaunched ends on the uninterrupted run's loss."""
    from repro_torch.launch.train import TrainConfig, train

    base = dict(arch="starcoder2-3b", steps=24, batch=2, seq_len=32, ckpt_every=8,
                lr=1e-3, device="cpu")
    _, _, losses_ref = train(TrainConfig(ckpt_dir=str(tmp_path / "ref"), **base),
                             log=lambda *_: None)
    cfg_crash = TrainConfig(ckpt_dir=str(tmp_path / "crash"), failure_at_step=17, **base)
    with pytest.raises(RuntimeError, match="injected failure"):
        train(cfg_crash, log=lambda *_: None)
    assert CheckpointManager(tmp_path / "crash").latest_step() == 15
    logs = []
    _, _, losses_resumed = train(TrainConfig(ckpt_dir=str(tmp_path / "crash"), **base),
                                 log=logs.append)
    assert "[train] resumed from checkpoint at step 15" in logs
    assert len(losses_resumed) == 8  # steps 16..23
    np.testing.assert_allclose(losses_resumed[-1], losses_ref[-1], rtol=1e-4)
    assert losses_ref[-1] < losses_ref[0]


def test_convert_round_trips_the_reference_trees():
    arch = "deepseek-v3-671b"
    _, tcfg = configs(arch, "bfloat16")
    tree = ref_params_numpy(arch, "bfloat16")
    tp = convert.lm_params_from_numpy(tree, tcfg, device="cpu")
    back = convert.lm_params_to_numpy(tp)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf).astype(np.float32))
    with pytest.raises(ValueError, match="the config wants"):
        convert.lm_params_from_numpy(tree, configs(arch, "float32")[1], device="cpu")


def test_train_cli_runs_and_resumes(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.launch.train`` on the CPU, run twice on one
    checkpoint directory: the second run resumes past the first's steps."""
    from repro_torch.launch import train as train_mod

    argv = ["train", "--device", "cpu", "--batch", "2", "--seq-len", "16",
            "--ckpt-dir", str(tmp_path)]
    monkeypatch.setattr("sys.argv", argv + ["--steps", "3"])
    train_mod.main()
    assert "final loss" in capsys.readouterr().out
    assert CheckpointManager(tmp_path).latest_step() == 2
    monkeypatch.setattr("sys.argv", argv + ["--steps", "5"])
    train_mod.main()
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 2" in out and "final loss" in out
    assert CheckpointManager(tmp_path).latest_step() == 4


# ---------------------------------------------------------------------------
# Elastic restore onto a mesh of gloo ranks
# ---------------------------------------------------------------------------


def test_elastic_restore_round_trips_on_gloo_ranks(tmp_path):
    """Save unsharded (the port) and from the reference; restore both onto
    (4,) and (2, 2) meshes of 4 gloo ranks (tests/_torch_ckpt_ranks_prog.py:
    each rank holds exactly its block, the gathered arrays equal the file
    bit for bit); the DTensors saved back restore in the reference equal to
    the original."""
    import os
    import subprocess
    import sys

    from _torch_ckpt_ranks_prog import template

    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.abspath(os.path.join(here, "..", "src"))
    _, tree = template()
    save_pytree(tree, tmp_path / "plain.npz")
    jtree = jax.tree.map(lambda t: jnp.asarray(
        convert.tensor_to_numpy(t), jnp.bfloat16 if t.dtype == torch.bfloat16 else None), tree)
    jsave(jtree, tmp_path / "ref.npz")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([src, here, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "_torch_ckpt_ranks_prog.py"),
                               str(r), "4", str(tmp_path / "store"), str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    try:
        for p in procs:
            p.wait(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = "\n".join(p.stdout.read()[-3000:] for p in procs if p.returncode != 0)
    assert all(p.returncode == 0 for p in procs), logs
    for n in (1, 2):
        back = jload(jtree, tmp_path / f"from_ranks{n}.npz")
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_restore_with_shardings_on_a_world_of_one(tmp_path):
    """``CheckpointManager.restore(..., shardings=)`` on a (1, 1) mesh equals
    the unsharded restore (the layout of ``chip_smoke.py``'s phase 13d)."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.launch.mesh import make_test_mesh

    created = not dist.is_initialized()  # else this worker's world of one
    _, tcfg = configs("starcoder2-3b", "bfloat16")
    params = ttf.init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, {"params": params}, blocking=True)
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"), device="cpu")
        step, back = mgr.restore({"params": params},
                                 shardings={"params": ttf.param_specs(tcfg, mesh)})
        _, plain = mgr.restore({"params": params})
        assert step == 3
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(plain)):
            assert is_dtensor(a)
            np.testing.assert_array_equal(_bits(a.full_tensor()), _bits(b))
    finally:
        if created:
            dist.destroy_process_group()
