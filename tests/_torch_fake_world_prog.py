"""Every family's step on rank 0 of a fake world (tests/test_torch_fake_world.py).

    python tests/_torch_fake_world_prog.py steps WORLD
    python tests/_torch_fake_world_prog.py flops WORLD ARCH

``steps``: a fake process group of WORLD ranks (256: the single-pod mesh
(data=16, model=16); 512: the multi-pod mesh (pod=2, data=16, model=16)),
every tensor a fake tensor (``FakeTensorMode``), and one step of each cell
at full width and a depth of 2 layers: the LM train step (grad_accum 4 on
one pod, 2 on two, as the reference's dry-run lowers ``train_4k``; the
8-bit update for deepseek-v3), prefill (batch_chunks 2 on one pod) and
decode with caches laid out by ``_cache_specs``; the GNN train steps; MIND's
train step, serving and retrieval.  Prints one JSON line: each cell's
output shapes and seconds.

``flops``: the LM train step of ARCH on a fake (1, WORLD) mesh, its matmul
FLOPs counted by ``FlopCounterMode`` on the local tensors that each
``local_call`` piece computes with (every matmul of the step runs inside
one).  Prints one JSON line.

Imports neither JAX nor the JAX package.
"""

import dataclasses
import json
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import zeros_from_specs

LM_ARCHS = ("starcoder2-3b", "qwen1.5-32b", "deepseek-v3-671b", "granite-moe-1b-a400m")
GNN_CELLS = (("graphsage-reddit", "ogb_products"), ("gatedgcn", "full_graph_sm"),
             ("schnet", "molecule"), ("graphcast", "full_graph_sm"))
MIND_CELLS = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")


def depth2(cfg):
    """Full width, two layers (MoE archs: one dense layer, one MoE)."""
    if cfg.moe:
        return dataclasses.replace(cfg, n_layers=2,
                                   first_dense_layers=min(cfg.first_dense_layers, 1))
    return dataclasses.replace(cfg, n_layers=2)


def shapes(tree):
    from repro_torch.tree import tree_leaves

    return [list(t.shape) for t in tree_leaves(tree if isinstance(tree, dict) else {"x": tree})]


def lm_cells(mesh, dp, multi):
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import opt_state_specs

    out = {}
    for arch in LM_ARCHS:
        spec = get_arch(arch)
        cfg = depth2(spec.model)
        pspecs = tf.param_specs(cfg, mesh)
        for shp in spec.shapes:
            if not shp.applicable:
                continue
            t0 = time.perf_counter()
            params = zeros_from_specs(pspecs)
            ins = zeros_from_specs(tf.input_specs(cfg, shp, mesh, dp))
            if shp.kind == "train":
                opt = OptConfig(quantized=arch == "deepseek-v3-671b")
                state = zeros_from_specs(opt_state_specs(pspecs, opt, mesh))
                step = tf.make_train_step(cfg, opt, dp, grad_accum=2 if multi else 4,
                                          param_shardings=pspecs)
                params, state, loss = step(params, state, ins["tokens"])
                res = shapes(loss)
            elif shp.kind == "prefill":
                step = tf.make_prefill_step(cfg, dp, batch_chunks=1 if multi else 2)
                res = shapes(step(params, ins["tokens"]))
            else:
                step = tf.make_decode_step(cfg, dp)
                lg, _ = step(params, ins["caches"], ins["tokens"], ins["cache_len"])
                res = shapes(lg)
            out[f"{arch} x {shp.name}"] = {"out": res, "s": time.perf_counter() - t0}
    return out


def gnn_cells(mesh, dp):
    from repro_torch.configs import get_arch
    from repro_torch.models import gnn
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import opt_state_specs

    out = {}
    for arch, cell in GNN_CELLS:
        spec = get_arch(arch)
        cfg = spec.model
        shp = next(s for s in spec.shapes if s.name == cell)
        t0 = time.perf_counter()
        pspecs = gnn.param_specs(cfg, shp.d_feat, mesh)
        params = zeros_from_specs(pspecs)
        opt = OptConfig()
        state = zeros_from_specs(opt_state_specs(pspecs, opt, mesh))
        batch = zeros_from_specs(gnn.input_specs(cfg, shp, mesh, dp))
        step = gnn.make_train_step(cfg, shp, opt, dp_axes=dp)
        params, state, loss = step(params, state, batch)
        out[f"{arch} x {cell}"] = {"out": shapes(loss), "s": time.perf_counter() - t0}
    return out


def mind_cells(mesh, dp):
    from repro_torch.configs import get_arch
    from repro_torch.models import recsys
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import opt_state_specs

    spec = get_arch("mind")
    cfg = spec.model
    pspecs = recsys.param_specs(cfg, mesh)
    out = {}
    for cell in MIND_CELLS:
        shp = next(s for s in spec.shapes if s.name == cell)
        t0 = time.perf_counter()
        params = zeros_from_specs(pspecs)
        batch = zeros_from_specs(recsys.input_specs(cfg, shp, mesh, dp))
        if shp.kind == "recsys_train":
            opt = OptConfig()
            state = zeros_from_specs(opt_state_specs(pspecs, opt, mesh))
            params, state, res = recsys.make_step(cfg, shp, opt)(params, state, batch)
        else:
            res = recsys.make_step(cfg, shp)(params, batch)
        out[f"mind x {cell}"] = {"out": shapes(res), "s": time.perf_counter() - t0}
    return out


def steps(mesh) -> dict:
    multi = mesh.ndim == 3
    dp = ("pod", "data") if multi else ("data",)
    out = {}
    out.update(lm_cells(mesh, dp, multi))
    out.update(gnn_cells(mesh, dp))
    out.update(mind_cells(mesh, dp))
    return {"mesh": list(mesh.mesh.shape), "cells": out}


def flops(mesh, arch: str) -> dict:
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import opt_state_specs

    spec = get_arch(arch)
    cfg = depth2(spec.model)
    shp = next(s for s in spec.shapes if s.kind == "train")
    pspecs = tf.param_specs(cfg, mesh)
    params = zeros_from_specs(pspecs)
    opt = OptConfig()
    state = zeros_from_specs(opt_state_specs(pspecs, opt, mesh))
    tokens = zeros_from_specs(tf.input_specs(cfg, shp, mesh, ("data",)))["tokens"]
    step = tf.make_train_step(cfg, opt, ("data",), param_shardings=pspecs)
    with FlopCounterMode(display=False) as fc:
        step(params, state, tokens)
    return {"arch": arch, "mesh": list(mesh.mesh.shape), "flops": fc.get_total_flops()}


def main() -> None:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

    mode, world = sys.argv[1], int(sys.argv[2])
    torch.set_num_threads(1)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    if mode == "steps":  # the mesh's rank table is real, every tensor after it fake
        mesh = make_production_mesh(multi_pod=world == 512, device="cpu")
    else:
        mesh = make_test_mesh((1, world), ("data", "model"), device="cpu")
    # the mesh holds a real rank table, which its methods read
    with FakeTensorMode(allow_non_fake_inputs=True):
        res = steps(mesh) if mode == "steps" else flops(mesh, sys.argv[3])
    print(json.dumps(res), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
