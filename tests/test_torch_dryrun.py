"""``repro_torch.launch.dryrun``: the dry-run of every registry cell on fake
256- and 512-rank worlds.

* Parity with the reference's own arithmetic for every applicable cell on
  both production meshes (tests/_torch_dryrun_ref_prog.py, a process of 512
  forced host devices that builds specs and lowers nothing): model FLOPs,
  ``grad_accum`` / ``batch_chunks``, the per-device state and the LM
  cells' ``analytic_*`` fields, exactly.
* ``run_cell`` on fake worlds with ``--device cpu``: starcoder2-3b x
  decode_32k on both meshes (the reference's own test cell, through the
  CLI, one process a mesh), steiner x lvj_1k, a GNN and a MIND cell.
* The layer calibration: calibrated FLOPs, bytes, collective bytes and peak
  equal a direct count at full depth on reduced configs at 4 layers (a
  dense arch) and 5 (a dense layer, then MoE layers), and on configs wide
  enough for ZeRO: stacks split over their layer dim (traced at full
  depth), and a 5-layer stack whose 2-layer variant alone would split;
  the variants of a full-size model take its parameter specs.

Each fake world is a process of its own; the processes start together.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import ALL_IDS, get_arch
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.launch.dryrun import cell_arithmetic, run_cell

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.abspath(os.path.join(_DIR, "..", "src"))
LIMIT_S = 600
MESHES = {"pod16x16": (False, (16, 16), ("data", "model")),
          "pod2x16x16": (True, (2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, s.name, m) for m in MESHES for a in ALL_IDS for s in get_arch(a).shapes
         if s.applicable]
CALIB = [(a, k) for a in ("starcoder2-3b", "deepseek-v3-671b", "qwen1.5-32b wide")
         for k in ("train", "prefill", "decode")]
CALIB += [("qwen1.5-32b wide odd", "train"), ("deepseek-v3-671b wide", "train")]
# the ranks each stack's layer dim is split over, (dense, MoE)
CALIB_SPLIT = {"starcoder2-3b": [1, 1], "deepseek-v3-671b": [1, 1], "qwen1.5-32b wide": [2, 1],
               "qwen1.5-32b wide odd": [1, 1], "deepseek-v3-671b wide": [2, 2]}


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env["PYTHONPATH"] = os.pathsep.join([_SRC, _DIR, env.get("PYTHONPATH", "")])
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every process of this file, started together: the reference's
    arithmetic, the CLI on both meshes, three more cells, the calibration
    (reduced configs, and configs wide enough for ZeRO)."""
    out = tmp_path_factory.mktemp("dryrun")
    prog = os.path.join(_DIR, "_torch_dryrun_prog.py")
    cmds = {
        "ref": ([sys.executable, os.path.join(_DIR, "_torch_dryrun_ref_prog.py")],
                _env(JAX_PLATFORMS="cpu")),
        "cli": ([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "starcoder2-3b",
                 "--shape", "decode_32k", "--mesh", "both", "--device", "cpu", "--out",
                 str(out)], _env()),
        "cells": ([sys.executable, prog, "cells", str(out)], _env()),
        "calib": ([sys.executable, prog, "calib"], _env()),
        "calib wide": ([sys.executable, prog, "calib", "wide"], _env()),
    }
    procs = {k: subprocess.Popen(c, env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True) for k, (c, e) in cmds.items()}
    res = {"out": out}
    for k, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=LIMIT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, stderr = p.communicate()
        lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
        if k == "cli":
            res[k] = (p.returncode, stdout, stderr[-4000:])
        else:
            res[k] = json.loads(lines[-1]) if p.returncode == 0 and lines else stderr[-4000:]
    return res


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_cell_arithmetic_matches_the_reference(runs, arch, shape, mesh):
    ref = runs["ref"]
    assert isinstance(ref, dict), ref
    want = ref[f"{arch} x {shape} x {mesh}"]
    multi, dims, axes = MESHES[mesh]
    spec = next(s for s in get_arch(arch).shapes if s.name == shape)
    got = cell_arithmetic(arch, spec, AbstractMesh(dims, axes), multi)
    if arch == "steiner":
        got["total_e"] = got["eb"] * (512 if multi else 256)
    assert {k: got.get(k) for k in want} == want
    lm = get_arch(arch).family == "lm"
    assert ("grad_accum" in got) == (lm and spec.kind == "train")
    assert ("batch_chunks" in got) == (lm and spec.kind == "prefill")


def _ok(rec):
    assert rec["status"] == "ok", rec.get("trace", rec)
    r = rec["roofline"]
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["t_compute_s"] >= 0 and r["t_memory_s"] > 0 and r["t_collective_s"] > 0
    assert rec["memory"]["fits_80gb"] and rec["device"] == "cpu"
    assert rec["peak_bytes"] >= rec["state_bytes"] > 0
    assert sum(g["bytes"] for g in rec["collective_groups"].values()) == r["bytes_wire"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cli_traces_the_reference_cell_on_both_meshes(runs, mesh):
    rc, stdout, stderr = runs["cli"]
    assert rc == 0, stderr
    assert stdout.splitlines()[-1] == "done: 2 ok, 0 skipped, 0 errors"
    path = runs["out"] / f"starcoder2-3b__decode_32k__{mesh}.json"
    rec = json.loads(path.read_text())
    _ok(rec)
    assert f"[ok     ] starcoder2-3b          decode_32k     {mesh} dominant=" in stdout
    # full width, 30 layers: one layer's matmul FLOPs on a card of (16, 16)
    dense = rec["layer_terms"]["dense"]
    if mesh == "pod16x16":
        assert dense["flops"] == 500_170_752
    assert rec["roofline"]["flops"] > 30 * dense["flops"]
    assert rec["roofline"]["compute_dtype"] == "bf16"


@pytest.mark.parametrize("cell", ["steiner x lvj_1k", "graphsage-reddit x full_graph_sm",
                                  "mind x serve_p99"])
def test_run_cell_on_a_fake_world(runs, cell):
    recs = runs["cells"]
    assert isinstance(recs, dict), recs
    rec = recs[cell]
    _ok(rec)
    assert rec["roofline"]["compute_dtype"] == "f32"
    assert json.loads((runs["out"] / f"{cell.replace(' x ', '__')}__pod16x16.json")
                      .read_text()) == rec
    if cell.startswith("steiner"):
        # per round: the fused (dist, lab) gather over "model" and the
        # replica MIN passes; no matmul
        assert rec["roofline"]["flops"] == 0
        assert rec["roofline"]["coll_all-gather"] == 2 * 4 * rec["nb"] * 16
        assert rec["roofline"]["model_flops_per_chip"] == 5.0 * (1 << 27) / 256


@pytest.mark.parametrize("arch,kind", CALIB)
def test_calibrated_terms_equal_a_direct_count(runs, arch, kind):
    res = runs["calib wide" if " wide" in arch else "calib"]
    assert isinstance(res, dict), res
    r = res[f"{arch} x {kind}"]
    assert r["calibrated"] == r["direct"]
    want = ["dense", "moe"] if arch.startswith("deepseek") else ["dense"]
    split = CALIB_SPLIT[arch] != [1, 1]
    assert r["layers"] == ([] if split else want)
    assert r["split"] == CALIB_SPLIT[arch]


@pytest.mark.parametrize("arch,dims,depth", [("qwen1.5-32b", (16, 16), (16, 0)),
                                             ("deepseek-v3-671b", (2, 16, 16), (1, 2))])
def test_variants_take_the_full_depth_layout(arch, dims, depth):
    """A shallow model's own specs lay it out otherwise than the full-depth
    model: qwen1.5-32b's 64 layers split over "data", 2 do not;
    deepseek-v3-671b's 671B parameters take ZeRO across pods, 3 of its
    layers do not.  The calibration's variants take the full model's specs
    and its optimizer (8-bit moments above 1e11 parameters)."""
    from repro_torch.launch import dryrun as dr
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves

    def specs(tree):
        return [s.sharding.spec for s in tree_leaves(tree)]

    full = get_arch(arch).model
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    mesh = AbstractMesh(dims, axes)
    want = specs(tf.param_specs(full, mesh))
    assert specs(dr._variant_param_specs(dr._lm_variant(full, *depth), full, mesh)) == want
    shallow = dr._lm_variant(full, *((1, 2) if full.moe else (2, 0)))
    assert specs(tf.param_specs(shallow, mesh)) != want
    assert dr._lm_opt(full).quantized == full.moe


def test_inapplicable_cell_is_skipped(tmp_path):
    shape = next(s for s in get_arch("starcoder2-3b").shapes if s.name == "long_500k")
    rec = run_cell("starcoder2-3b", shape, False, tmp_path, device="cpu")
    assert rec["status"] == "skipped" and rec["note"] == shape.note
    assert json.loads((tmp_path / "starcoder2-3b__long_500k__pod16x16.json").read_text()) == rec


def test_cli_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda traces fake CUDA tensors there")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mind",
                           "--shape", "serve_p99", "--mesh", "single"], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "done:" not in proc.stdout
