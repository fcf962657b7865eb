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
LM_FAMILIES = ("starcoder2", "starcoder2_split", "starcoder2_h3", "granite_moe", "granite_accum",
               "deepseek_q8")
GNN_FAMILIES = ("sage_full", "gatedgcn", "schnet_mol", "schnet_graph", "graphcast")
FAMILIES = (*LM_FAMILIES, *GNN_FAMILIES, "mind")
# the train step's options: microbatches (the reference's global rows) and
# the 8-bit AdamW moments
GRAD_ACCUM = {"granite_accum": 2}
QUANTIZED = ("deepseek_q8",)
# held against the reference's sharded step too; ``starcoder2_split`` (an
# FFN 32 times as wide) only against the port's one-device step: there the
# reference's own (2, 2) and (2, 2, 2) steps already differ by 1.1e-4·max
# in a first moment, and the one-device port and the reference by 2.4e-4·max
REF_FAMILIES = tuple(f for f in FAMILIES if f != "starcoder2_split")
STEPS = 2
LR = 1e-3
N_NODES, N_EDGES, D_FEAT = 64, 256, 8
# GraphCast's mesh: N // 4 + 1 = 17 nodes (split over no dp axis), 68 mesh
# edges (split over every axis of (2, 2), over "pod" alone of (2, 2, 2))
N_MESH, N_MESH_EDGES = N_NODES // 4 + 1, 68
# SchNet's molecule batch: 8 molecules of 6 atoms sharing 10 edges
N_MOL, MOL_ATOMS, MOL_EDGES = 8, 6, 10


def config(family: str, pkg):
    """The family's config from ``pkg``'s registry (``repro`` or
    ``repro_torch``): LMs reduced in f32 (``starcoder2_split`` with 4 layers
    and an FFN of 4096, so that its FFN stacks reach ``_fsdp``'s 2^20
    elements and the ZeRO axes split their layer dim; ``starcoder2_h3`` with 3
    query heads and one KV head, so head_dim splits over "model" instead and
    each rank attends from its block of the query positions); GatedGCN at a hidden
    width of 18 (not a multiple of 16: the replicated-node fallback of
    ``make_specs``); deepseek-v3's reduced MLA + MoE in f32."""
    get = pkg.get_arch
    if family == "starcoder2":
        return dataclasses.replace(get("starcoder2-3b").reduced, dtype="float32")
    if family == "starcoder2_h3":
        return dataclasses.replace(get("starcoder2-3b").reduced, dtype="float32", n_heads=3,
                                   n_kv_heads=1, head_dim=16)
    if family == "starcoder2_split":
        return dataclasses.replace(get("starcoder2-3b").reduced, dtype="float32", n_layers=4,
                                   d_ff=4096)
    if family in ("granite_moe", "granite_accum"):
        return dataclasses.replace(get("granite-moe-1b-a400m").reduced, dtype="float32")
    if family == "deepseek_q8":
        return dataclasses.replace(get("deepseek-v3-671b").reduced, dtype="float32")
    if family in ("schnet_mol", "schnet_graph"):
        return get("schnet").reduced
    if family == "graphcast":
        return get("graphcast").reduced
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
    if family == "schnet_mol":
        return S(name="m", kind="gnn_batched", n_nodes=MOL_ATOMS, n_edges=MOL_EDGES,
                 d_feat=D_FEAT, graph_batch=N_MOL)
    if family in GNN_FAMILIES:
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
    if family == "schnet_mol":
        return {"z": r.normal(size=(N_MOL, MOL_ATOMS, D_FEAT)).astype(np.float32),
                "pos": r.uniform(0, 3, (N_MOL, MOL_ATOMS, 3)).astype(np.float32),
                "edges_t": r.integers(0, MOL_ATOMS, (MOL_EDGES, 2)).astype(np.int32),
                "energy": r.normal(size=N_MOL).astype(np.float32)}
    if family == "schnet_graph":
        return {"x": r.normal(size=(N_NODES, D_FEAT)).astype(np.float32),
                "pos": r.uniform(0, 4, (N_NODES, 3)).astype(np.float32),
                "edges": r.integers(0, N_NODES, (N_EDGES, 2)).astype(np.int32),
                "energy_sum": np.asarray(r.normal() * 10, np.float32)}
    if family == "graphcast":
        def pairs(n, a, b):
            return np.stack([r.integers(0, a, n), r.integers(0, b, n)], 1).astype(np.int32)

        return {"x": r.normal(size=(N_NODES, D_FEAT)).astype(np.float32),
                "g2m": pairs(N_EDGES, N_NODES, N_MESH),
                "mesh_e": pairs(N_MESH_EDGES, N_MESH, N_MESH),
                "m2g": pairs(N_EDGES, N_MESH, N_NODES),
                "target": r.normal(size=(N_NODES, cfg.n_vars)).astype(np.float32)}
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
    from repro_torch.distributed.sharding import distribute_tree, zeros_from_specs
    from repro_torch.models import gnn, recsys, transformer
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.optim.adamw import opt_state_specs

    cfg, shp = config(family, tc), shape(family, tbase)
    opt = OptConfig(lr=LR, quantized=family in QUANTIZED)
    if family in LM_FAMILIES:
        mod, table = transformer, transformer.param_table(cfg)
        step = transformer.make_train_step(
            cfg, opt, dp_axes, kv_chunk=8, grad_accum=GRAD_ACCUM.get(family, 1),
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
        state = zeros_from_specs(opt_state_specs(specs, opt, mesh))
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
                    out[f"m.{k[:-2]}"] = _np_moment(mv)
            for k, v in flatten(params).items():
                out[f"p1.{k}"] = _np(v)
    for k, v in flatten(params).items():
        out[f"p.{k}"] = _np(v)
    return out


def _np_moment(mv):
    """A first moment as numpy: an 8-bit one read back to f32."""
    from repro_torch.optim.adamw import Q8State, _q8_read

    if isinstance(mv, Q8State):
        mv = _q8_read(Q8State(_whole(mv.q), _whole(mv.scale), mv.shape))
    return _np(mv)


def _whole(t):
    from repro_torch.distributed.sharding import is_dtensor

    return t.full_tensor() if is_dtensor(t) else t


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
    # an 8-bit moment is its block's absmax / 127 times an int8: a gradient
    # a hair from a rounding tie may land one step away (1/127 of the max)
    frac_m = 1e-2 if family in QUANTIZED else 2e-4
    for k in moments:
        scale = tree_max if family == "mind" else float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=frac_m * scale, err_msg=k)
    for prefix, steps, frac in (("p1.", 1, 0.001), ("p.", STEPS, 0.05)):
        off, total = 0, 0
        for k in (k for k in want if k.startswith(prefix)):
            a, b = got[k], want[k]
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=2 * LR * steps, err_msg=k)
            off += int((np.abs(a - b) > 1e-5 * np.abs(b).max() + 1e-5 * np.abs(b)).sum())
            total += b.size
        assert off <= frac * total, (prefix, off, total)


# ---- serving steps (tests/test_torch_sharded_serve.py) -----------------------

# prefill in two chunks of the reference's global rows; decode against
# caches of each layout: KV heads split over "model" (f32, bf16, int8), one
# KV head so head_dim splits instead (f32; int8, whose scales then split over
# the sequence), and MLA's latent split over its columns; MIND's serving
# and retrieval
SERVE_CASES = ("prefill_granite", "decode_starcoder2", "decode_starcoder2_bf16", "decode_kv1",
               "decode_qwen_int8", "decode_qwen_int8_kv1", "decode_deepseek", "mind_serve",
               "mind_retrieval")
DEC_B, SMAX, DEC_STEPS, N_CAND = 8, 16, 4, 64


def serve_config(case: str, pkg):
    """The case's config from ``pkg``'s registry (f32 but for the bf16 case)."""
    import dataclasses as dc

    get = pkg.get_arch
    f32 = {"dtype": "float32"}
    return {
        "prefill_granite": lambda: dc.replace(get("granite-moe-1b-a400m").reduced, **f32),
        "decode_starcoder2": lambda: dc.replace(get("starcoder2-3b").reduced, **f32),
        "decode_starcoder2_bf16": lambda: get("starcoder2-3b").reduced,
        "decode_kv1": lambda: dc.replace(get("starcoder2-3b").reduced, n_kv_heads=1, **f32),
        "decode_qwen_int8": lambda: dc.replace(get("qwen1.5-32b").reduced, **f32),
        "decode_qwen_int8_kv1": lambda: dc.replace(get("qwen1.5-32b").reduced, n_kv_heads=1,
                                                   **f32),
        "decode_deepseek": lambda: dc.replace(get("deepseek-v3-671b").reduced, **f32),
        "mind_serve": lambda: get("mind").reduced,
        "mind_retrieval": lambda: get("mind").reduced,
    }[case]()


def serve_shape(case: str, pkg_base):
    S = pkg_base.ShapeSpec
    if case.startswith("prefill"):
        return S(name="p", kind="prefill", seq_len=16, global_batch=8)
    if case.startswith("decode"):
        return S(name="d", kind="decode", seq_len=SMAX, global_batch=DEC_B)
    if case == "mind_serve":
        return S(name="s", kind="recsys_serve", batch=16)
    return S(name="c", kind="recsys_retrieval", batch=1, n_candidates=N_CAND)


def serve_batch_numpy(case: str, cfg, seed: int = 2) -> dict:
    r = np.random.default_rng(seed)
    if case.startswith("prefill"):
        return {"tokens": r.integers(0, cfg.vocab, (8, 16)).astype(np.int32)}
    if case.startswith("decode"):
        return {"tokens": r.integers(0, cfg.vocab, (DEC_STEPS, DEC_B)).astype(np.int32)}
    B = 16 if case == "mind_serve" else 1
    mask = (r.uniform(size=(B, cfg.hist_len)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0
    out = {"hist_ids": r.integers(0, cfg.n_items, (B, cfg.hist_len)).astype(np.int32),
           "hist_mask": mask}
    shp = (16, 12) if case == "mind_serve" else (N_CAND,)
    out["cand_ids"] = r.integers(0, cfg.n_items, shp).astype(np.int32)
    return out


def port_serve(case: str, mesh=None, dp_axes=(), device="cpu") -> dict:
    """The port's serving step on one device (``mesh=None``) or SPMD on
    ``mesh``: {"out" (prefill logits, MIND scores)} or {"lg<i>" (each decode
    step's logits), "c.<stack>.<i>" (the caches after the last)} as numpy."""
    import torch

    import repro_torch.configs as tc
    from repro_torch.configs import base as tbase
    from repro_torch.distributed.sharding import distribute_tree
    from repro_torch.models import recsys, transformer

    cfg, shp = serve_config(case, tc), serve_shape(case, tbase)
    mind = case.startswith("mind")
    mod = recsys if mind else transformer
    table = mod.param_table(cfg)
    flat = params_numpy(case, table)
    params = (dict if mind else nest)({k: torch.from_numpy(v).to(device).to(table[k][1])
                                       for k, v in flat.items()})
    batch = {k: torch.from_numpy(v).to(device) for k, v in serve_batch_numpy(case, cfg).items()}
    ispecs = None
    if mesh is not None:
        params = distribute_tree(params, mod.param_specs(cfg, mesh))
        ispecs = mod.input_specs(cfg, shp, mesh, dp_axes)

    def place(k, t):
        return t if ispecs is None else ispecs[k].sharding.distribute(t)

    if mind:
        step = recsys.make_step(cfg, shp)
        return {"out": _np(step(params, {k: place(k, v) for k, v in batch.items()}))}
    if case.startswith("prefill"):
        step = transformer.make_prefill_step(cfg, dp_axes, kv_chunk=8, batch_chunks=2)
        return {"out": _np(step(params, place("tokens", batch["tokens"])))}
    step = transformer.make_decode_step(cfg, dp_axes)
    if mesh is None:
        caches = transformer.init_caches(cfg, DEC_B, SMAX, device=device)
    else:
        caches = transformer.caches_from_specs(ispecs["caches"])
    out = {}
    for i in range(DEC_STEPS):
        clen = place("cache_len", torch.tensor(i, dtype=torch.int32, device=device))
        lg, caches = step(params, caches, place("tokens", batch["tokens"][i]), clen)
        out[f"lg{i}"] = _np(lg)
    for name, c in caches.items():
        for j, t in enumerate(c if isinstance(c, tuple) else (c,)):
            out[f"c.{name}.{j}"] = _np(t)
    return out


def check_serve(got, want, case):
    """Two records of ``port_serve``'s layout within the tolerances stated
    in tests/test_torch_sharded_serve.py."""
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    bf16 = case.endswith("bf16")
    for k in sorted(want):
        a, b = got[k], want[k]
        scale = float(np.abs(b).max()) or 1.0
        if k.startswith("c.") and case.startswith("decode_qwen") and k.endswith((".0", ".2")):
            # int8 payloads: equal but for rounding ties of a hair-apart key
            off = np.abs(a - b)
            assert off.max() <= 1 and (off > 0).mean() <= 1e-3, (k, off.max(), (off > 0).mean())
        elif k.startswith("c.") and case.startswith("decode_qwen"):
            # bf16 scales: within one bf16 step
            np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=0, err_msg=k)
        elif case.startswith("mind"):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale, err_msg=k)
        elif bf16:
            np.testing.assert_allclose(a, b, rtol=2e-2, atol=2e-2 * scale, err_msg=k)
        else:
            # f32 logits and caches: test_torch_lm.py's LOGITS; logits that
            # read int8 keys: one key a step apart moves them by ~1e-3·max
            frac = 5e-3 if case.startswith("decode_qwen") else 5e-5
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=frac * scale, err_msg=k)
