"""The dry-run's counters and cells on fake worlds, one world a process
(tests/test_torch_roofline.py, tests/test_torch_dryrun.py).

    python tests/_torch_dryrun_prog.py coll
    python tests/_torch_dryrun_prog.py cells OUT_DIR
    python tests/_torch_dryrun_prog.py calib [wide]

``coll``: a fake world of 16 ranks; under ``StepCounter`` the collectives
of the reference's parser test (bf16[16,1024] all-gather, f32[256]
all-reduce, f32[64] reduce-scatter, u8[128] all-to-all) as functional ops
over ranks 0-3 (one node: NVLink) with their waits, and an in-place
``dist.all_reduce`` and ``all_gather_into_tensor`` over ranks {0, 8} (two
nodes: InfiniBand); also the HBM bytes of an add, a view and a matmul.

``cells``: ``run_cell`` on the single-pod mesh of a fake world of 256 ranks,
``--device cpu``: steiner x lvj_1k, graphsage-reddit x full_graph_sm and
mind x serve_p99.

``calib``: on a fake (2, 2) world, the layer-calibrated cost and peak of
reduced starcoder2-3b (dense) at 4 layers and deepseek-v3-671b (one dense,
then MoE layers) at 5, train, prefill (2 batch chunks) and decode, beside
a direct count at that depth.  ``calib wide``: the same for configs
widened until ZeRO shards their stacks (``CALIB_WIDE``): qwen1.5-32b at 4
layers and deepseek-v3-671b at 2 dense and 4 MoE, whose layer dims "data"
splits, and qwen1.5-32b at 5, whose layer dim it does not split where 2
layers' would be.

Each prints one JSON line.  Imports neither JAX nor the JAX package.
"""

import dataclasses
import json
import sys

import torch
import torch.distributed as dist


def coll() -> dict:
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.roofline import StepCounter, wire_by_link

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    node = dist.new_group([0, 1, 2, 3])
    cross = dist.new_group([0, 8])
    with FakeTensorMode(allow_non_fake_inputs=True):
        with StepCounter() as sc:
            for t in (
                funcol.all_gather_tensor(torch.zeros(4, 1024, dtype=torch.bfloat16), 0, node),
                funcol.all_reduce(torch.zeros(256), "sum", node),
                funcol.reduce_scatter_tensor(torch.zeros(256), "sum", 0, node),
                funcol.all_to_all_single(torch.zeros(128, dtype=torch.uint8), None, None, node),
            ):
                funcol.wait_tensor(t)
        functional = {"coll": sc.coll, "groups": sc.groups, "by_link": wire_by_link(sc.groups)}
        with StepCounter() as sc:
            x = torch.zeros(256)
            dist.all_reduce(x, group=cross)
            out = torch.empty(512)
            gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
            gather(out, x, group=cross)
        inplace = {"coll": sc.coll, "groups": sc.groups, "by_link": wire_by_link(sc.groups)}
        a, b = torch.zeros(256), torch.zeros(256)
        m, n = torch.zeros(8, 16), torch.zeros(16, 4)
        with StepCounter() as sc:
            a + b
        add = sc.bytes_hbm
        with StepCounter() as sc:
            a.view(16, 16)
        view = sc.bytes_hbm
        with StepCounter() as sc:
            m @ n
        mm = sc.bytes_hbm
    return {"functional": functional, "inplace": inplace,
            "hbm": {"add": add, "view": view, "matmul": mm}}


def cells(out_dir: str) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import run_cell

    out = {}
    for arch, shape in (("steiner", "lvj_1k"), ("graphsage-reddit", "full_graph_sm"),
                        ("mind", "serve_p99")):
        spec = next(s for s in get_arch(arch).shapes if s.name == shape)
        out[f"{arch} x {shape}"] = run_cell(arch, spec, False, out_dir, force=True,
                                            device="cpu")
    return out


# (name, arch, widths, layers after the dense ones, kinds): each stack's
# leaves at 2^20 elements or more, so that ZeRO shards them at their first
# dim that "data" divides
CALIB_WIDE = (
    ("qwen1.5-32b wide", "qwen1.5-32b", {"d_ff": 4096}, 4, ("train", "prefill", "decode")),
    ("qwen1.5-32b wide odd", "qwen1.5-32b", {"d_ff": 4096}, 5, ("train",)),
    ("deepseek-v3-671b wide", "deepseek-v3-671b",
     {"first_dense_layers": 2, "d_ff": 8192, "moe_d_ff": 512}, 4, ("train",)),
)


def calib(wide: bool) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as dr
    from repro_torch.models import transformer as tf

    mesh = dr.fake_mesh((2, 2), device="cpu")
    shapes = ((ShapeSpec("t", "train", seq_len=64, global_batch=8), 1),
              (ShapeSpec("p", "prefill", seq_len=64, global_batch=8), 2),
              (ShapeSpec("d", "decode", seq_len=64, global_batch=8), 1))
    kinds = ("train", "prefill", "decode")
    cases = CALIB_WIDE if wide else [(a, a, {}, 4, kinds)
                                     for a in ("starcoder2-3b", "deepseek-v3-671b")]
    out = {}
    for name, arch, widths, depth, run in cases:
        cfg = dataclasses.replace(get_arch(arch).reduced, **widths)
        cfg = dataclasses.replace(cfg, n_layers=depth + cfg.first_dense_layers)
        specs = tf.param_specs(cfg, mesh)
        split = [dr._layer_split(specs.get(k, {}), mesh) for k in ("dense", "moe")]
        for shape, chunks in shapes:
            if shape.kind not in run:
                continue
            with FakeTensorMode(allow_non_fake_inputs=True):
                cal, _, layers = dr._lm_calibrated_cost(cfg, shape, mesh, ("data",), chunks)
                direct, _ = dr._lm_cost(cfg, shape, mesh, ("data",), chunks)
            out[f"{name} x {shape.kind}"] = {
                "calibrated": cal, "direct": direct, "layers": sorted(layers), "split": split,
                "depth": [cfg.n_layers, cfg.first_dense_layers]}
    return out


def main() -> None:
    torch.set_num_threads(1)
    mode = sys.argv[1]
    if mode == "coll":
        res = coll()
    elif mode == "cells":
        res = cells(sys.argv[2])
    else:
        res = calib(sys.argv[2:] == ["wide"])
    print(json.dumps(res), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
