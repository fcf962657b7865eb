"""The reference's dry-run arithmetic for every registry cell, with no
lowering (tests/test_torch_dryrun.py).

    python tests/_torch_dryrun_ref_prog.py

Importing ``repro.launch.dryrun`` forces 512 host devices, so this runs in a
process of its own.  For each applicable (arch × shape) on the single-pod
(16, 16) and multi-pod (2, 16, 16) meshes it calls the reference's own
``build_cell`` with ``jax.jit`` (in the dry-run module) and
``make_dist_steiner`` replaced by stubs whose ``lower`` records its
arguments and returns None, and the calibrated cost skipped: what remains
is the reference's arithmetic.  Prints one JSON line: per cell the model
FLOPs, ``grad_accum`` / ``batch_chunks`` (the arguments its step factories
were given), the per-device state bytes (``_specs_gb`` of the parameter,
optimizer state and input specs, × 2**30), the ``analytic_*`` fields of LM
cells, and a Steiner cell's vertex block and edge total.
"""

import json

from repro.launch import dryrun as d  # noqa: I001  (sets XLA_FLAGS before jax starts)

import jax

import repro.core.dist_steiner as ds
from repro import compat
from repro.configs import ALL_IDS, get_arch
from repro.launch.mesh import make_production_mesh
from repro.models import gnn as gnn_mod
from repro.models import recsys as rec_mod
from repro.models import transformer as tf_mod
from repro.optim import OptConfig, opt_state_specs

SEEN = {}


class _NoLower:
    def lower(self, *args, **kwargs):
        SEEN["lower_args"] = args


class _JaxWithoutJit:
    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kwargs):
        return _NoLower()


def _recording(factory, key):
    def make(*args, **kwargs):
        SEEN[key] = kwargs.get(key, 1)
        return factory(*args, **kwargs)

    return make


def _dist_steiner(mesh, cfg, replica_axes=()):
    SEEN["nb"] = cfg.nb
    return _NoLower()


d.jax = _JaxWithoutJit()
d._lm_calibrated_cost = lambda *args, **kwargs: None
tf_mod.make_train_step = _recording(tf_mod.make_train_step, "grad_accum")
tf_mod.make_prefill_step = _recording(tf_mod.make_prefill_step, "batch_chunks")
ds.make_dist_steiner = _dist_steiner


def _state_bytes(arch, shape, mesh, dp_axes):
    cfg = arch.model
    if arch.family == "lm":
        p = tf_mod.param_specs(cfg, mesh)
        i = tf_mod.input_specs(cfg, shape, mesh, dp_axes)
        ocfg = OptConfig(quantized=cfg.params_count() > 1e11)
    elif arch.family == "gnn":
        p = gnn_mod.param_specs(cfg, gnn_mod.effective_graph(shape)[2], mesh)
        i = gnn_mod.input_specs(cfg, shape, mesh, dp_axes)
        ocfg = OptConfig()
    else:
        p = rec_mod.param_specs(cfg, mesh)
        i = rec_mod.input_specs(cfg, shape, mesh, dp_axes)
        ocfg = OptConfig()
    trees = [p, i]
    if shape.kind in ("train", "recsys_train") or arch.family == "gnn":
        trees.append(opt_state_specs(p, ocfg, mesh))
    return d._specs_gb(*trees) * 2**30


def main() -> None:
    out = {}
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        dp_axes = ("pod", "data") if mp else ("data",)
        mesh_name = "pod2x16x16" if mp else "pod16x16"
        with compat.set_mesh(mesh):
            for arch_id in ALL_IDS:
                arch = get_arch(arch_id)
                for shape in arch.shapes:
                    if not shape.applicable:
                        continue
                    SEEN.clear()
                    _, mf, _, analytic = d.build_cell(arch_id, shape, mesh, mp)
                    rec = {"model_flops": mf}
                    if arch.family == "steiner":
                        rec["nb"] = SEEN["nb"]
                        rec["total_e"] = SEEN["lower_args"][0].shape[0]
                    else:
                        rec["state_bytes"] = _state_bytes(arch, shape, mesh, dp_axes)
                    for k in ("grad_accum", "batch_chunks"):
                        if arch.family == "lm" and k in SEEN:
                            rec[k] = SEEN[k]
                    if analytic is not None:
                        rec.update(analytic)
                    out[f"{arch_id} x {shape.name} x {mesh_name}"] = rec
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
