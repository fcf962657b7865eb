"""Multi-pod dry-run: one step of every (arch × shape × mesh) cell, traced
on fake tensors of a fake world, with its roofline and its fit on a card.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell for 256 and 512 forced host devices.  Here rank 0 of a fake process
group of 256 ranks (the single-pod mesh (data=16, model=16)) or 512 (the
multi-pod (pod=2, data=16, model=16)) runs one step of each cell at full
width under ``FakeTensorMode``: no tensor holds data and no collective
moves any, but every op and every collective of that rank's program runs,
with this rank's shard shapes.  Dispatch modes count what it does
(``launch/roofline.py``): matmul FLOPs, HBM bytes, collective bytes by kind
and by process group, and the peak of ``MemTracker``, this rank's own
program's memory.  Each cell gets a per-card prediction: the three
roofline times on an H100's data-sheet rates and ``fits_80gb`` against the
card's memory.  These are host arithmetic, not measurements.

"On the card" (``--device cuda``, the default) means fake CUDA tensors, so
the CUDA build of PyTorch traces its own dispatch; ``--device cpu`` traces
fake CPU tensors (what the tests run).  Without a CUDA device the CLI
raises unless ``--device cpu`` is given.  A world is made once per process,
so each mesh runs in a process of its own.  Records are one JSON file per
cell under ``dryrun_out/`` (git-ignored).

The reference's functions map here one to one, but for its cell builders:
what they compute from shapes alone (model FLOPs, chunking, state, the
analytic memory model) is :func:`cell_arithmetic`, and what they lower is
``_lm_calibrated_cost``, ``_gnn_cell``, ``_recsys_cell`` and
``_steiner_cell``, each one traced step (LM cells: two or three).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-32b \\
      --shape decode_32k --mesh single
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import ALL_IDS, get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed.sharding import (NamedSharding, ShapeDtypeStruct, entry_axes,
                                              mesh_shape, zeros_from_specs)
from repro_torch.launch import roofline as rl
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as rec_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.optim import OptConfig
from repro_torch.optim.adamw import Q8State, opt_state_specs
from repro_torch.tree import tree_map

RESULTS_DIR = Path(__file__).resolve().parents[3] / "dryrun_out"


# ----------------------------------------------------------------------------
# Per-device state from the specs
# ----------------------------------------------------------------------------


def _leaves(x):
    """The tensors or specs of a tree: dicts, the tuples inside it (a KV
    cache stack, a GNN batch's hops) and 8-bit states (payload, scales)."""
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k])
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _leaves(v)
    elif isinstance(x, Q8State):
        yield from _leaves((x.q, x.scale))
    elif hasattr(x, "shape"):
        yield x


def _specs_bytes(*trees) -> int:
    """Exact per-device bytes of ShapeDtypeStructs (shard shapes)."""
    total = 0
    for leaf in _leaves(trees):
        shard = leaf.shape
        sh = getattr(leaf, "sharding", None)
        if sh is not None:
            shard = sh.shard_shape(leaf.shape)
        total += math.prod(shard) * torch.empty((), dtype=leaf.dtype).element_size()
    return total


def _specs_gb(*trees) -> float:
    """:func:`_specs_bytes` in GiB, as the reference's ``_specs_gb``."""
    return _specs_bytes(*trees) / 2**30


def _dp_size(mesh, dp_axes) -> int:
    return math.prod(mesh_shape(mesh)[ax] for ax in dp_axes)


def _grad_accum(shape: ShapeSpec, dsz: int) -> int:
    """Train microbatches: tokens/device of a microbatch ≈ 16K (activation
    memory), a power of two."""
    tok_dev = shape.global_batch * shape.seq_len // max(dsz, 1)
    accum = max(1, min(shape.global_batch // dsz, tok_dev // 16384))
    return 1 << (accum.bit_length() - 1)


def _batch_chunks(shape: ShapeSpec, dsz: int) -> int:
    """Prefill batch chunks: tokens in flight/device ≈ 8K, a power of two."""
    tok_dev = shape.global_batch * shape.seq_len // max(dsz, 1)
    bc = max(1, min(shape.global_batch // dsz, tok_dev // 8192))
    return 1 << (bc.bit_length() - 1)


def _lm_analytic_gb(cfg, shape, mesh, dp_axes, accum, state_gb) -> dict:
    """The reference's per-device TPU memory model for LM cells, kept for
    parity (GiB): exact sharded state + an activation working-set model.
    The port's own verdict comes from its ``MemTracker`` peak."""
    msz = mesh_shape(mesh)["model"]
    dsz = _dp_size(mesh, dp_axes)
    d, L = cfg.d_model, cfg.n_layers
    Vp = cfg.vocab_padded
    work = 0.0
    if shape.kind in ("train", "prefill"):
        chunks = max(accum, 1)  # grad-accum (train) or batch chunking (prefill)
        tokm = shape.global_batch * shape.seq_len // dsz // chunks
        ff_shard = max(cfg.d_ff, cfg.n_shared * cfg.moe_d_ff if cfg.moe else 0)
        ff_shard = max(ff_shard // msz, d)
        # remat boundaries persist only when there is a backward pass
        stack = (L * tokm * d * 2 / msz) if shape.kind == "train" else 0.0
        live = 10 * tokm * max(d, ff_shard) * 2  # working set
        if cfg.moe:
            # dispatched slots: experts are model-sharded, so each device
            # holds cap/msz slots of width d
            cap = 1.25 * tokm * cfg.top_k / msz
            live += 6 * cap * max(d, cfg.moe_d_ff) * 2
        logits = tokm * (Vp // msz) * 4 * (3 if shape.kind == "train" else 0)
        if shape.kind == "prefill":
            logits = (shape.global_batch // dsz) * (Vp // msz) * 4
        work = (stack + live + logits) / 2**30
        if shape.kind == "train":
            # transient grads of one layer during update (rest is in state)
            work += 2 * state_gb / max(L, 1)
    else:  # decode: per-chunk attention buffers only
        bd = max(shape.global_batch // dsz, 1)
        work = (bd * cfg.n_heads * 4096 * 8.0) / 2**30 + 0.25
    return {"analytic_state_gb": state_gb, "analytic_work_gb": work,
            "analytic_peak_gb": state_gb + work}


# ----------------------------------------------------------------------------
# Counting one traced step
# ----------------------------------------------------------------------------


def _state_tensors(*trees):
    return [getattr(t, "_local_tensor", t) for t in _leaves(trees) if isinstance(t, torch.Tensor)]


def _count(run, *state, warm: bool = False):
    """Runs ``run()`` under the counters → (flops, HBM bytes, wire bytes by
    kind, wire bytes by group, peak bytes) and the groups' ranks and links.
    ``state`` (trees of tensors made before ``run``) counts toward the
    peak.  ``warm`` runs it once uncounted first: the first call of a
    DTensor step's shapes in a process peaks far above later ones
    (starcoder2-3b x prefill_32k at 2 layers: 9.70 against 1.36 GB), from
    one-time work that later calls find cached; FLOPs and bytes do not
    change."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    if warm:
        run()
    mt = MemTracker()
    mt.track_external(*_state_tensors(*state))
    sc = rl.StepCounter()
    with FlopCounterMode(display=False) as fc, mt, sc:
        run()
    peak = max(v["Total"] for v in mt.get_tracker_snapshot("peak").values())
    groups = {k: {"ranks": g["ranks"], "link": g["link"]} for k, g in sc.groups.items()}
    cost = (float(fc.get_total_flops()), float(sc.bytes_hbm), dict(sc.coll),
            {k: g["bytes"] for k, g in sc.groups.items()}, float(peak))
    return cost, groups


def tuple_sub(a, b):
    """a − b for (flops, bytes, coll-by-kind, coll-by-group, peak) terms."""
    return (
        a[0] - b[0],
        a[1] - b[1],
        {k: a[2].get(k, 0.0) - b[2].get(k, 0.0) for k in a[2]},
        {k: a[3].get(k, 0.0) - b[3].get(k, 0.0) for k in set(a[3]) | set(b[3])},
        a[4] - b[4],
    )


def _times(t, k: float):
    """k × (flops, bytes, coll-by-kind, coll-by-group, peak) terms."""
    return (k * t[0], k * t[1], {n: k * v for n, v in t[2].items()},
            {n: k * v for n, v in t[3].items()}, k * t[4])


def _combine(consts, layer_terms):
    """const + Σ L_i × layer_i of (flops, bytes, coll-by-kind, coll-by-group,
    peak) terms, each term clamped at 0."""
    f, b, c, g, p = consts
    f, b, p = max(f, 0.0), max(b, 0.0), max(p, 0.0)
    c = {k: max(v, 0.0) for k, v in c.items()}
    g = {k: max(v, 0.0) for k, v in g.items()}
    for mult, (lf, lb, lc, lg, lp) in layer_terms:
        f += mult * max(lf, 0.0)
        b += mult * max(lb, 0.0)
        p += mult * max(lp, 0.0)
        for k in c:
            c[k] += mult * max(lc.get(k, 0.0), 0.0)
        for k, v in lg.items():
            g[k] = g.get(k, 0.0) + mult * max(v, 0.0)
    return f, b, c, g, p


# ----------------------------------------------------------------------------
# What a cell's shapes give: model FLOPs, chunking, per-device state
# ----------------------------------------------------------------------------


def _lm_model_flops(cfg, shape) -> float:
    act = cfg.active_params_count()
    if shape.kind == "train":
        return 6.0 * act * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * act * shape.global_batch * shape.seq_len
    return 2.0 * act * shape.global_batch


def _gnn_model_flops(cfg, shape) -> float:
    n, e, f = gnn_mod.effective_graph(shape)
    h = cfg.d_hidden
    if cfg.kind == "sage":
        fwd = 2 * n * (f * h + h * h) * cfg.n_layers + 2 * e * h
    elif cfg.kind == "gatedgcn":
        fwd = 2 * n * f * h + cfg.n_layers * (6 * 2 * max(n, e) * h * h + 4 * e * h)
    elif cfg.kind == "schnet":
        fwd = 2 * n * f * h + cfg.n_interactions * (
            2 * e * (cfg.rbf * h + h * h) + 4 * n * h * h
        )
    else:  # graphcast
        nm = n // 4 + 1
        fwd = (
            2 * n * f * h
            + cfg.n_layers * (2 * 8 * nm * (3 * h * h + 2 * h * h))
            + 2 * e * (3 * h * h + 2 * h * h) * 2
            + 2 * n * h * cfg.n_vars
        )
    return 3.0 * fwd  # fwd + bwd ≈ 3×


def _recsys_model_flops(cfg, shape) -> float:
    d, K, Lh = cfg.embed_dim, cfg.n_interests, cfg.hist_len
    route = cfg.capsule_iters * 2 * shape.batch * Lh * K * d * 2
    if shape.kind == "recsys_train":
        return 3.0 * (route + 2 * shape.batch * shape.batch * d)
    ncand = shape.n_candidates or 256 * shape.batch
    return route + 2.0 * max(1, shape.batch) * ncand * K * d


def _steiner_dims(shape: ShapeSpec, mesh, dp_axes):
    """(n, nb, eb, S): the reference's shard geometry of a Steiner cell."""
    n_blocks = mesh_shape(mesh)["model"]
    n_rep = _dp_size(mesh, dp_axes)
    n, e, S = shape.n_nodes, shape.n_edges, shape.batch
    nb = -(-(-(-n // n_blocks)) // 8) * 8
    eb = -(-e // (n_rep * n_blocks) // 8 + 1) * 8
    return n, nb, eb, S


def _lm_opt(cfg) -> OptConfig:
    """An LM's optimizer: 8-bit moments above 1e11 parameters."""
    return OptConfig(quantized=cfg.params_count() > 1e11)


def _family_specs(arch, shape: ShapeSpec, mesh, dp_axes):
    """(parameter, optimizer state or None, input) specs of a model cell."""
    cfg = arch.model
    if arch.family == "lm":
        pspecs = tf_mod.param_specs(cfg, mesh)
        ispecs = tf_mod.input_specs(cfg, shape, mesh, dp_axes)
        ocfg = _lm_opt(cfg)
    elif arch.family == "gnn":
        pspecs = gnn_mod.param_specs(cfg, gnn_mod.effective_graph(shape)[2], mesh)
        ispecs = gnn_mod.input_specs(cfg, shape, mesh, dp_axes)
        ocfg = OptConfig()
    else:
        pspecs = rec_mod.param_specs(cfg, mesh)
        ispecs = rec_mod.input_specs(cfg, shape, mesh, dp_axes)
        ocfg = OptConfig()
    trains = shape.kind in ("train", "recsys_train") or arch.family == "gnn"
    return pspecs, (opt_state_specs(pspecs, ocfg, mesh) if trains else None), ispecs


def cell_arithmetic(arch_id: str, shape: ShapeSpec, mesh, multi_pod: bool) -> dict:
    """What a cell's record holds beside its traced terms, from shapes
    alone (``mesh`` a ``DeviceMesh`` or an ``AbstractMesh``): the model
    FLOPs of the whole step (the reference's formulas), the chunking
    (``grad_accum`` / ``batch_chunks``), the per-device state in bytes
    (parameters, optimizer state, inputs and caches; a Steiner rank's edge
    shard and seeds), the compute dtype, and for LM cells the reference's
    ``analytic_*`` memory model (GiB)."""
    arch = get_arch(arch_id)
    cfg = arch.model
    dp_axes = ("pod", "data") if multi_pod else ("data",)
    if arch.family == "steiner":
        n, nb, eb, S = _steiner_dims(shape, mesh, dp_axes)
        # "useful" work per relaxation round: one add + compare chain per edge
        return {"model_flops": 5.0 * shape.n_edges, "state_bytes": 3 * eb * 4 + S * 4,
                "dtype": "f32", "nb": nb, "eb": eb}
    pspecs, ospecs, ispecs = _family_specs(arch, shape, mesh, dp_axes)
    trees = (pspecs, ispecs) if ospecs is None else (pspecs, ospecs, ispecs)
    out = {"state_bytes": _specs_bytes(*trees), "dtype": "f32"}
    if arch.family == "gnn":
        out["model_flops"] = _gnn_model_flops(cfg, shape)
    elif arch.family == "recsys":
        out["model_flops"] = _recsys_model_flops(cfg, shape)
    else:
        out["model_flops"] = _lm_model_flops(cfg, shape)
        dsz = _dp_size(mesh, dp_axes)
        chunks = 1
        if shape.kind == "train":
            chunks = out["grad_accum"] = _grad_accum(shape, dsz)
        elif shape.kind == "prefill":
            chunks = out["batch_chunks"] = _batch_chunks(shape, dsz)
        state_gb = _specs_gb(pspecs, ispecs)  # summed in the reference's order
        if shape.kind == "train":
            state_gb += _specs_gb(ospecs)
            state_gb += _specs_gb(pspecs)  # the reference's accumulated-gradient buffer
        out.update(_lm_analytic_gb(cfg, shape, mesh, dp_axes, chunks, state_gb))
        out["dtype"] = "bf16" if cfg.torch_dtype in (torch.bfloat16, torch.float16) else "f32"
    return out


# ----------------------------------------------------------------------------
# Cell builders: one traced step → (cost, groups)
# ----------------------------------------------------------------------------


def _lm_variant(cfg, ld: int, lm: int):
    if cfg.moe:
        return dataclasses.replace(cfg, n_layers=ld + lm, first_dense_layers=ld)
    return dataclasses.replace(cfg, n_layers=ld)


def _layer_split(stack, mesh) -> int:
    """The ranks a stack's layer dim is split over in its parameter specs
    (1: every rank holds a block of every layer)."""
    sizes = mesh_shape(mesh)
    return max((math.prod(sizes[a] for a in entry_axes(s.sharding.spec[0]))
                for s in _leaves(stack)), default=1)


def _variant_param_specs(cfg, full, mesh):
    """The parameter specs of ``cfg``, a shallower variant of ``full``,
    sharded as ``full``'s are: the ZeRO axes (across pods above 1e11
    parameters) and the dim that each leaf splits over them depend on the
    depth, and a variant is to trace the full-depth program's layout."""
    return tree_map(lambda s, f: ShapeDtypeStruct(s.shape, s.dtype,
                                                  NamedSharding(mesh, f.sharding.spec)),
                    tf_mod.param_specs(cfg, mesh), tf_mod.param_specs(full, mesh))


def _lm_cost(cfg, shape, mesh, dp_axes, chunks: int, warm: bool = False, full=None):
    """One traced step of ``cfg`` at the production chunking, kv_chunk
    1024 and sequence-sharded boundaries, with the parameter specs and the
    optimizer of ``full`` (by default ``cfg``) when ``cfg`` is a shallower
    variant of it (``warm``: see :func:`_count`)."""
    full = cfg if full is None else full
    pspecs = _variant_param_specs(cfg, full, mesh)
    params = zeros_from_specs(pspecs)
    ins = zeros_from_specs(tf_mod.input_specs(cfg, shape, mesh, dp_axes))
    if shape.kind == "train":
        ocfg = _lm_opt(full)
        state = zeros_from_specs(opt_state_specs(pspecs, ocfg, mesh))
        step = tf_mod.make_train_step(cfg, ocfg, dp_axes, kv_chunk=1024, grad_accum=chunks,
                                      seq_shard=True, param_shardings=pspecs)
        return _count(lambda: step(params, state, ins["tokens"]), params, state, ins,
                      warm=warm)
    if shape.kind == "prefill":
        step = tf_mod.make_prefill_step(cfg, dp_axes, kv_chunk=1024, seq_shard=True,
                                        batch_chunks=chunks)
        return _count(lambda: step(params, ins["tokens"]), params, ins, warm=warm)
    if shape.kind == "decode":
        step = tf_mod.make_decode_step(cfg, dp_axes)
        return _count(lambda: step(params, ins["caches"], ins["tokens"], ins["cache_len"]),
                      params, ins, warm=warm)
    raise ValueError(shape.kind)


def _lm_calibrated_cost(cfg, shape, mesh, dp_axes, chunks: int):
    """Layer-count-calibrated cost and peak.

    Tracing all 61 layers of deepseek-v3 eagerly is slow, so each cell runs
    at full width and two or three layers, and the terms are combined
    linearly in layers:

        total = const + Ld·(dense layer) + Lm·(moe layer)

    from (dense, MoE) depths (1, 2), (2, 2) and (1, 3) of a model with
    both types, else from depths 2 and 3: a shallower model peaks at
    another op than a deeper one.  Every variant takes the full-depth
    model's parameter specs and optimizer (:func:`_lm_cost`), so it runs
    the full-depth program's layout.  FLOPs, bytes and collective bytes of
    an eager step are sums over its ops, so they are exact in layers; the
    ``MemTracker`` peak is extrapolated the same way.

    A stack whose layer dim is split over u ranks at full depth
    (qwen1.5-32b's 64 layers over "data": each rank holds whole layers and
    gathers one at a time) is traced at full depth instead, once a model
    of u layers in each such stack has warmed the process (:func:`_count`):
    its train step's peak is not linear in layers, so no pair of shallow
    variants extrapolates it.  Its per-layer terms are then empty.
    """
    Ld, Lm = tf_mod.layer_counts(cfg)
    specs = tf_mod.param_specs(cfg, mesh)
    ud, um = (_layer_split(specs.get(k, {}), mesh) for k in ("dense", "moe"))
    if ud > 1 or um > 1:
        _lm_cost(_lm_variant(cfg, min(Ld, ud), min(Lm, um)), shape, mesh, dp_axes, chunks,
                 full=cfg)
        cost, groups = _lm_cost(cfg, shape, mesh, dp_axes, chunks)
        return cost, groups, {}
    groups = {}

    def costs(ld, lm, warm=False):
        cost, g = _lm_cost(_lm_variant(cfg, ld, lm), shape, mesh, dp_axes, chunks, warm,
                           full=cfg)
        groups.update(g)
        return cost

    if cfg.moe and Ld > 0:
        c12 = costs(1, 2, warm=True)
        dense_l = tuple_sub(costs(2, 2), c12)
        moe_l = tuple_sub(costs(1, 3), c12)
        const = tuple_sub(tuple_sub(c12, dense_l), _times(moe_l, 2))
    else:
        c2 = costs(0, 2, warm=True) if cfg.moe else costs(2, 0, warm=True)
        layer = tuple_sub(costs(0, 3) if cfg.moe else costs(3, 0), c2)
        dense_l, moe_l = (None, layer) if cfg.moe else (layer, None)
        const = tuple_sub(c2, _times(layer, 2))
    layers = {name: t for name, t in (("dense", dense_l), ("moe", moe_l)) if t is not None}
    terms = [(Ld if name == "dense" else Lm, t) for name, t in layers.items()]
    return _combine(const, terms), groups, layers


def _layer_row(t) -> dict:
    """One layer's calibrated terms, for the record."""
    return {"flops": t[0], "bytes_hbm": t[1], "bytes_wire": sum(t[2].values()), "peak": t[4]}


def _traced_step(step, pspecs, ospecs, ispecs):
    params, batch = zeros_from_specs(pspecs), zeros_from_specs(ispecs)
    if ospecs is None:
        return _count(lambda: step(params, batch), params, batch, warm=True)
    state = zeros_from_specs(ospecs)
    return _count(lambda: step(params, state, batch), params, state, batch, warm=True)


def _gnn_cell(arch, shape: ShapeSpec, mesh, dp_axes):
    """One traced train step of a GNN cell at full depth."""
    pspecs, ospecs, ispecs = _family_specs(arch, shape, mesh, dp_axes)
    step = gnn_mod.make_train_step(arch.model, shape, OptConfig(), dp_axes=dp_axes)
    return _traced_step(step, pspecs, ospecs, ispecs)


def _recsys_cell(arch, shape: ShapeSpec, mesh, dp_axes):
    """One traced MIND step: train (AdamW), serving or retrieval."""
    pspecs, ospecs, ispecs = _family_specs(arch, shape, mesh, dp_axes)
    step = rec_mod.make_step(arch.model, shape, None if ospecs is None else OptConfig())
    return _traced_step(step, pspecs, ospecs, ispecs)


def _steiner_cell(shape: ShapeSpec, mesh, dp_axes, device):
    """Init and one relaxation round of the distributed pipeline
    (``core/dist_steiner.make_dist_rounds``) on this rank's fake edge
    shard: the terms are per round, as the reference's (whose HLO counts a
    while body once)."""
    from repro_torch.configs.steiner import solver_preset
    from repro_torch.core.dist_steiner import DistSteinerConfig, make_dist_rounds
    from repro_torch.core.mesh import device_mesh

    # canonical per-workload SolverConfig preset — knobs come from ONE
    # place (configs.steiner.SOLVER_PRESETS); only the mesh is ours
    scfg = solver_preset(shape.name)
    n, nb, eb, S = _steiner_dims(shape, mesh, dp_axes)
    cfg = DistSteinerConfig(
        n=n,
        nb=nb,
        num_seeds=S,
        mode=scfg.mode,
        mst_algo=scfg.mst_algo,
        local_steps=scfg.local_steps,
        pair_chunks=scfg.pair_chunks,
        fuse_gather=scfg.fuse_gather,
        lab_i16=scfg.lab_i16,
        max_iters=scfg.max_iters,
    )
    sizes = mesh_shape(mesh)
    rounds = make_dist_rounds(device_mesh(tuple(sizes.values()), tuple(sizes)), cfg,
                              replica_axes=dp_axes)
    src = torch.zeros(eb, dtype=torch.int32, device=device)
    dst = torch.zeros(eb, dtype=torch.int32, device=device)
    w = torch.zeros(eb, dtype=torch.float32, device=device)
    seeds = torch.zeros(S, dtype=torch.int32, device=device)
    return _count(lambda: rounds.round(rounds.init(src, dst, w, seeds), 0), [src, dst, w, seeds])


def build_cell(arch_id: str, shape: ShapeSpec, mesh, multi_pod: bool, device="cuda"):
    """Traces one cell on ``mesh`` (a ``DeviceMesh`` of the fake world)
    under the fake tensor mode the caller holds → (cost, groups, per-layer
    terms, :func:`cell_arithmetic`).  ``cost`` is (matmul FLOPs, HBM bytes,
    wire bytes by kind, wire bytes by group, peak bytes); LM cells'
    per-layer terms come from the calibration, the others' are empty."""
    arch = get_arch(arch_id)
    dp_axes = ("pod", "data") if multi_pod else ("data",)
    arith = cell_arithmetic(arch_id, shape, mesh, multi_pod)
    layers = {}
    if arch.family == "lm":
        chunks = arith.get("grad_accum", arith.get("batch_chunks", 1))
        cost, groups, layers = _lm_calibrated_cost(arch.model, shape, mesh, dp_axes, chunks)
    elif arch.family == "steiner":
        cost, groups = _steiner_cell(shape, mesh, dp_axes, device)
    elif arch.family == "gnn":
        cost, groups = _gnn_cell(arch, shape, mesh, dp_axes)
    elif arch.family == "recsys":
        cost, groups = _recsys_cell(arch, shape, mesh, dp_axes)
    else:
        raise ValueError(arch.family)
    return cost, groups, {k: _layer_row(t) for k, t in layers.items()}, arith


# ----------------------------------------------------------------------------
# The fake world
# ----------------------------------------------------------------------------

_MESH = {}


def _fake_init(size: int, device: str) -> str:
    """Makes this process's fake world of ``size`` ranks (rank 0), or
    checks the one it holds; returns the device type."""
    dev = torch.device(device).type
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to trace fake "
                           "CPU tensors")
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    if dist.get_world_size() != size:
        raise RuntimeError(f"this process's world has {dist.get_world_size()} ranks, the mesh "
                           f"needs {size} (one world a process: run each mesh in its own)")
    return dev


def fake_world(multi_pod: bool, device: str = "cuda"):
    """The production ``DeviceMesh`` (``launch/mesh.py``) on rank 0 of a
    fake world of 256 or 512 ranks, made on first use (its rank table is
    real: build it before entering ``FakeTensorMode``)."""
    from repro_torch.launch.mesh import make_production_mesh

    dev = _fake_init(512 if multi_pod else 256, device)
    key = (multi_pod, dev)
    if key not in _MESH:
        _MESH[key] = make_production_mesh(multi_pod=multi_pod, device=dev)
    return _MESH[key]


def fake_mesh(dims, device: str = "cuda"):
    """A ("data", "model") ``DeviceMesh`` of ``dims`` on a fake world of
    ``prod(dims)`` ranks, as :func:`fake_world`."""
    from repro_torch.launch.mesh import make_test_mesh

    dev = _fake_init(math.prod(dims), device)
    key = (tuple(dims), dev)
    if key not in _MESH:
        _MESH[key] = make_test_mesh(tuple(dims), ("data", "model"), device=dev)
    return _MESH[key]


def predict_lm_step(arch_id: str, shape: ShapeSpec, device: str = "cuda") -> dict:
    """The dry-run's prediction for one LM train step of ``arch_id`` at
    full width and depth, without microbatches, on the (1, 1) ("data",
    "model") mesh of a fake world of one rank: matmul FLOPs, HBM and wire
    bytes and the peak (calibrated in layers), and the bytes of the
    parameters and optimizer state, for holding against a real step of the
    same cell on one card."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_arch(arch_id).model
    mesh = fake_mesh((1, 1), device)
    with FakeTensorMode(allow_non_fake_inputs=True):
        cost, _, layers = _lm_calibrated_cost(cfg, shape, mesh, ("data",), 1)
    pspecs = tf_mod.param_specs(cfg, mesh)
    ospecs = opt_state_specs(pspecs, _lm_opt(cfg), mesh)
    return {"arch": arch_id, "mesh": [1, 1], "flops": cost[0], "bytes_hbm": cost[1],
            "bytes_wire": sum(cost[2].values()), "peak_bytes": cost[4],
            "params_bytes": _specs_bytes(pspecs), "opt_bytes": _specs_bytes(ospecs),
            "layer_terms": {k: _layer_row(t) for k, t in layers.items()}}


def run_cell(arch_id: str, shape: ShapeSpec, multi_pod: bool, out_dir: Path,
             force: bool = False, device: str = "cuda") -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    out = Path(out_dir) / f"{arch_id}__{shape.name}__{mesh_name}.json"
    if out.exists() and not force:
        return json.loads(out.read_text())
    rec = {
        "arch": arch_id,
        "shape": shape.name,
        "mesh": mesh_name,
        "kind": shape.kind,
    }
    if not shape.applicable:
        rec.update(status="skipped", note=shape.note)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=1))
        return rec
    t0 = time.time()
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode

        mesh = fake_world(multi_pod, device)  # a real rank table, built before the fake mode
        n_chips = 512 if multi_pod else 256
        with FakeTensorMode(allow_non_fake_inputs=True):
            cost, groups, layers, arith = build_cell(arch_id, shape, mesh, multi_pod, device)
        t_trace = time.time() - t0
        flops, bts, coll, by_group, peak = cost
        groups = {g: {**groups[g], "bytes": b} for g, b in by_group.items()}
        roof = rl.analyze_terms(flops, bts, coll, model_flops_total=arith["model_flops"],
                                n_chips=n_chips, by_link=rl.wire_by_link(groups),
                                dtype=arith["dtype"])
        mem = rl.memory_report(peak, arith["state_bytes"])
        mem.update({k: v for k, v in arith.items() if k.startswith("analytic_")})
        rec.update(
            status="ok",
            device=torch.device(device).type,
            trace_s=round(t_trace, 1),
            peak_bytes=peak,
            **{k: v for k, v in arith.items() if not k.startswith("analytic_")},
            memory=mem,
            roofline=roof.row(),
            collective_groups=groups,
        )
        if layers:
            rec["layer_terms"] = layers
    except Exception as exc:  # record the failure — these are bugs to fix
        rec.update(
            status="error",
            error=f"{type(exc).__name__}: {exc}",
            trace=traceback.format_exc()[-4000:],
        )
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    return rec


def _line(rec: dict) -> str:
    st = rec["status"]
    msg = f"[{st:7s}] {rec['arch']:22s} {rec['shape']:14s} {rec['mesh']}"
    if st == "ok":
        r = rec["roofline"]
        m = rec["memory"]
        msg += (
            f" dominant={r['dominant']:10s}"
            f" t=(c {r['t_compute_s']:.2e}, m {r['t_memory_s']:.2e},"
            f" x {r['t_collective_s']:.2e})s"
            f" peak={m['peak_gb']:.1f}GB"
            f" fits={m['fits_80gb']}"
        )
    elif st == "error":
        msg += " " + rec["error"][:120]
    return msg


def _sweep(args, multi_pod: bool):
    archs = list(ALL_IDS) if args.arch == "all" else [args.arch]
    n = {"ok": 0, "skipped": 0, "error": 0}
    for arch_id in archs:
        spec = get_arch(arch_id)
        for shape in spec.shapes:
            if args.shape != "all" and shape.name != args.shape:
                continue
            rec = run_cell(arch_id, shape, multi_pod, Path(args.out), force=args.force,
                           device=args.device)
            n[rec["status"]] += 1
            print(_line(rec), flush=True)
    return n


def _child(args, mesh: str):
    """Runs one mesh in a process of its own; returns its counts."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", args.arch,
           "--shape", args.shape, "--mesh", mesh, "--device", args.device, "--out", args.out]
    if args.force:
        cmd.append("--force")
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(p for p in (src, env.get("PYTHONPATH")) if p)
    n = None
    with subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, text=True) as proc:
        for line in proc.stdout:
            if line.startswith("done: "):
                parts = line[6:].replace(",", "").split()
                n = {"ok": int(parts[0]), "skipped": int(parts[2]), "error": int(parts[4])}
            else:
                print(line, end="", flush=True)
    if n is None or proc.returncode not in (0, 1):  # 1: the child's own errors, counted
        n = n or {"ok": 0, "skipped": 0, "error": 0}
        n["error"] += 1
    return n


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device (cuda needs a card)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to trace fake CPU "
                         "tensors")
    if args.mesh == "both":
        counts = [_child(args, "single"), _child(args, "multi")]
        n = {k: sum(c[k] for c in counts) for k in counts[0]}
    else:
        torch.set_num_threads(1)
        n = _sweep(args, args.mesh == "multi")
    print(f"done: {n['ok']} ok, {n['skipped']} skipped, {n['error']} errors", flush=True)
    if n["error"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
