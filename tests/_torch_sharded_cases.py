"""Cases of the sharded train steps (tests/test_torch_sharded_steps.py):
each family's reduced config, its weights and batch made with numpy from a
seed, and the meshes.  Imports neither JAX nor the JAX package, so the
gloo ranks start quickly; the reference's program builds its own objects
from the same numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# name: (mesh dims, axis names, dp axes)
MESHES = {
    "2x2": ((2, 2), ("data", "model"), ("data",)),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model"), ("pod", "data")),
}
LM_FAMILIES = ("starcoder2", "starcoder2_split", "granite_moe")
FAMILIES = (*LM_FAMILIES, "sage_full", "gatedgcn", "mind")
# held against the reference's sharded step too; ``starcoder2_split`` (an
# FFN 32 times as wide) only against the port's one-device step: there the
# reference's own (2, 2) and (2, 2, 2) steps already differ by 1.1e-4·max
# in a first moment, and the one-device port and the reference by 2.4e-4·max
REF_FAMILIES = tuple(f for f in FAMILIES if f != "starcoder2_split")
STEPS = 2
LR = 1e-3
N_NODES, N_EDGES, D_FEAT = 64, 256, 8


def config(family: str, pkg):
    """The family's config from ``pkg``'s registry (``repro`` or
    ``repro_torch``): LMs reduced in f32 (``starcoder2_split`` with 4 layers
    and an FFN of 4096, so that its FFN stacks reach ``_fsdp``'s 2^20
    elements and the ZeRO axes split their layer dim); GatedGCN at a hidden
    width of 18 (not a multiple of 16: the replicated-node fallback of
    ``make_specs``)."""
    get = pkg.get_arch
    if family == "starcoder2":
        return dataclasses.replace(get("starcoder2-3b").reduced, dtype="float32")
    if family == "starcoder2_split":
        return dataclasses.replace(get("starcoder2-3b").reduced, dtype="float32", n_layers=4,
                                   d_ff=4096)
    if family == "granite_moe":
        return dataclasses.replace(get("granite-moe-1b-a400m").reduced, dtype="float32")
    if family == "sage_full":
        return get("graphsage-reddit").reduced
    if family == "gatedgcn":
        return dataclasses.replace(get("gatedgcn").reduced, d_hidden=18)
    if family == "mind":
        return get("mind").reduced
    raise KeyError(family)


def shape(family: str, pkg_base):
    """The cell: ``pkg_base`` is the package's ``configs.base`` module."""
    S = pkg_base.ShapeSpec
    if family in LM_FAMILIES:
        return S(name="t", kind="train", seq_len=16, global_batch=8)
    if family in ("sage_full", "gatedgcn"):
        return S(name="g", kind="gnn_full", n_nodes=N_NODES, n_edges=N_EDGES, d_feat=D_FEAT)
    return S(name="r", kind="recsys_train", batch=16)


def params_numpy(family: str, table: dict, seed: int = 0) -> dict:
    """Flat {dotted path: array} for ``table`` ({path: (shape, ...)}):
    norms one, biases zero, every other weight normal / sqrt(fan_in)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(table):
        shp = tuple(table[name][0])
        if name.endswith(("ln1", "ln2", "final_norm", "q_norm", "kv_norm", "ln_n", "ln_e")):
            out[name] = np.ones(shp, np.float32)
        elif name.endswith(("bq", "bk", "bv")):
            out[name] = np.zeros(shp, np.float32)
        else:
            fan_in = shp[-2] if len(shp) >= 2 else shp[-1]
            out[name] = (rng.normal(size=shp) * fan_in ** -0.5).astype(np.float32)
    return out


def batch_numpy(family: str, cfg, seed: int = 1) -> dict:
    r = np.random.default_rng(seed)
    if family in LM_FAMILIES:
        return {"tokens": r.integers(0, cfg.vocab, (8, 16)).astype(np.int32)}
    if family in ("sage_full", "gatedgcn"):
        b = {"x": r.normal(size=(N_NODES, D_FEAT)).astype(np.float32),
             "edges": r.integers(0, N_NODES, (N_EDGES, 2)).astype(np.int32),
             "labels": r.integers(0, cfg.n_classes, N_NODES).astype(np.int32)}
        if family == "gatedgcn":
            b["ew"] = r.uniform(0.5, 2.0, N_EDGES).astype(np.float32)
        return b
    B, L = 16, cfg.hist_len
    mask = (r.uniform(size=(B, L)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0
    return {"hist_ids": r.integers(0, cfg.n_items, (B, L)).astype(np.int32),
            "hist_mask": mask,
            "target_id": r.integers(0, cfg.n_items, B).astype(np.int32)}


def nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        parts = k.split(".")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


def port_run(family: str, mesh=None, dp_axes=(), device="cpu"):
    """The port's steps: one device (``mesh=None``, plain tensors on
    ``device``) or
    SPMD on ``mesh`` (params by ``param_specs``, moments by
    ``opt_state_specs``, inputs by ``input_specs``).  Returns {"loss<i>",
    "m.<path>" (the first moment after step 1, (1 - b1)·g), "p1.<path>" (the
    parameters after step 1), "p.<path>" (after the last step)} as numpy."""
    import torch

    import repro_torch.configs as tc
    from repro_torch.configs import base as tbase
    from repro_torch.distributed.sharding import distribute_tree
    from repro_torch.models import gnn, recsys, transformer
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.optim.adamw import opt_state_from_specs, opt_state_specs

    cfg, shp = config(family, tc), shape(family, tbase)
    opt = OptConfig(lr=LR)
    if family in LM_FAMILIES:
        mod, table = transformer, transformer.param_table(cfg)
        step = transformer.make_train_step(
            cfg, opt, dp_axes, kv_chunk=8,
            param_shardings=None if mesh is None else transformer.param_specs(cfg, mesh))
        specs = None if mesh is None else transformer.param_specs(cfg, mesh)
        ispecs = None if mesh is None else transformer.input_specs(cfg, shp, mesh, dp_axes)
    elif family == "mind":
        mod, table = recsys, recsys.param_table(cfg)
        step = recsys.make_step(cfg, shp, opt)
        specs = None if mesh is None else recsys.param_specs(cfg, mesh)
        ispecs = None if mesh is None else recsys.input_specs(cfg, shp, mesh, dp_axes)
    else:
        mod, table = gnn, gnn.param_table(cfg, D_FEAT)
        step = gnn.make_train_step(cfg, shp, opt, dp_axes=dp_axes)
        specs = None if mesh is None else gnn.param_specs(cfg, D_FEAT, mesh)
        ispecs = None if mesh is None else gnn.input_specs(cfg, shp, mesh, dp_axes)
    flat = params_numpy(family, table)
    nest_fn = dict if family == "mind" else nest
    params = nest_fn({k: torch.from_numpy(v).to(device) for k, v in flat.items()})
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch_numpy(family, cfg).items()}
    if mesh is None:
        state = adamw_init(params, opt)
    else:
        params = distribute_tree(params, specs)
        state = opt_state_from_specs(opt_state_specs(specs, opt, mesh))
        if family in LM_FAMILIES:
            batch = {"tokens": ispecs["tokens"].sharding.distribute(batch["tokens"])}
        else:
            batch = {k: ispecs[k].sharding.distribute(v) for k, v in batch.items()}
    out = {}
    for i in range(STEPS):
        if family in LM_FAMILIES:
            params, state, loss = step(params, state, batch["tokens"])
        else:
            params, state, loss = step(params, state, batch)
        out[f"loss{i}"] = _np(loss)
        if i == 0:
            for k, mv in flatten(state["mu"]).items():
                if k.endswith(".m"):
                    out[f"m.{k[:-2]}"] = _np(mv)
            for k, v in flatten(params).items():
                out[f"p1.{k}"] = _np(v)
    for k, v in flatten(params).items():
        out[f"p.{k}"] = _np(v)
    return out


def _np(t):
    from repro_torch.distributed.sharding import is_dtensor

    if is_dtensor(t):
        t = t.full_tensor()
    return t.detach().cpu().float().numpy().copy()


def check_records(got, want, family):
    """Two records of ``port_run``'s layout within the tolerances stated in
    tests/test_torch_sharded_steps.py."""
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    lm = family in LM_FAMILIES
    np.testing.assert_allclose(got["loss0"], want["loss0"], rtol=1e-6 if lm else 1e-5)
    np.testing.assert_allclose(got["loss1"], want["loss1"], rtol=1e-3)
    moments = [k for k in want if k.startswith("m.")]
    tree_max = max(float(np.abs(want[k]).max()) for k in moments)
    for k in moments:
        scale = tree_max if family == "mind" else float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=2e-4 * scale, err_msg=k)
    for prefix, steps, frac in (("p1.", 1, 0.001), ("p.", STEPS, 0.05)):
        off, total = 0, 0
        for k in (k for k in want if k.startswith(prefix)):
            a, b = got[k], want[k]
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=2 * LR * steps, err_msg=k)
            off += int((np.abs(a - b) > 1e-5 * np.abs(b).max() + 1e-5 * np.abs(b)).sum())
            total += b.size
        assert off <= frac * total, (prefix, off, total)
