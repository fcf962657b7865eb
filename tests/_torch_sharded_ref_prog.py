"""The reference's sharded train steps on the cases of
_torch_sharded_cases.py, on 8 forced host devices
(tests/test_torch_sharded_steps.py runs it with
XLA_FLAGS=--xla_force_host_platform_device_count=8).

    python tests/_torch_sharded_ref_prog.py OUT_DIR [MESH [lm | models | serve]]

Params placed by ``param_specs``, AdamW state by ``opt_state_specs``, the
batch by ``input_specs``, and ``jax.jit(make_train_step(..., dp_axes,
param_shardings=...))`` under the mesh; writes
``OUT_DIR/<family>.<mesh>.ref.npz`` in the port's record layout (``lm``:
the LM families only, ``models``: the others).  With ``serve``: the
serving cases (prefill, decode with caches placed by
``_cache_specs``, MIND's scores) in ``port_serve``'s layout.
"""

import math
import sys

import numpy as np

from _torch_sharded_cases import (D_FEAT, DEC_STEPS, GRAD_ACCUM, LM_FAMILIES, LR, MESHES,
                                  QUANTIZED, REF_FAMILIES, SERVE_CASES, STEPS,
                                  batch_numpy, config, flatten, nest, params_numpy,
                                  serve_batch_numpy, serve_config, serve_shape, shape)


def run(family, mesh, dp_axes):
    import jax
    import jax.numpy as jnp

    import repro.configs as jc
    from repro import compat
    from repro.configs import base as jbase
    from repro.models import gnn, recsys, transformer
    from repro.optim import OptConfig, adamw_init, opt_state_specs
    from repro.optim.adamw import Q8State, _q8_read

    cfg, shp = config(family, jc), shape(family, jbase)
    opt = OptConfig(lr=LR, quantized=family in QUANTIZED)
    if family in LM_FAMILIES:
        table = transformer.param_defs(cfg, 1, 1)
        pspecs = transformer.param_specs(cfg, mesh)
        psh = jax.tree.map(lambda s: s.sharding, pspecs)
        ispecs = transformer.input_specs(cfg, shp, mesh, dp_axes)
        step = transformer.make_train_step(cfg, opt, dp_axes, kv_chunk=8,
                                           grad_accum=GRAD_ACCUM.get(family, 1),
                                           param_shardings=psh)
    elif family == "mind":
        table = recsys.param_defs(cfg)
        pspecs = recsys.param_specs(cfg, mesh)
        ispecs = recsys.input_specs(cfg, shp, mesh, dp_axes)
        step = recsys.make_step(cfg, shp, opt)
    else:
        table = gnn.param_defs(cfg, D_FEAT)
        pspecs = gnn.param_specs(cfg, D_FEAT, mesh)
        ispecs = gnn.input_specs(cfg, shp, mesh, dp_axes)
        step = gnn.make_train_step(cfg, shp, opt, dp_axes=dp_axes)
    sh = lambda t: jax.tree.map(lambda s: s.sharding, t)  # noqa: E731
    flat = {k: jnp.asarray(v) for k, v in params_numpy(family, table).items()}
    params = jax.device_put(dict(flat) if family == "mind" else nest(flat), sh(pspecs))
    state = jax.device_put(adamw_init(params, opt), sh(opt_state_specs(pspecs, opt, mesh)))
    batch = batch_numpy(family, cfg)
    if family in LM_FAMILIES:
        batch = jax.device_put(jnp.asarray(batch["tokens"]), ispecs["tokens"].sharding)
    else:
        batch = {k: jax.device_put(jnp.asarray(v), ispecs[k].sharding) for k, v in batch.items()}
    out = {}
    with compat.set_mesh(mesh):
        jstep = jax.jit(step)
        for i in range(STEPS):
            params, state, loss = jstep(params, state, batch)
            out[f"loss{i}"] = np.asarray(loss, np.float32)
            if i == 0:
                for k, mv in flatten(state["mu"]).items():
                    if k.endswith(".m"):
                        mv = _q8_read(mv) if isinstance(mv, Q8State) else mv
                        out[f"m.{k[:-2]}"] = np.asarray(mv, np.float32)
                for k, v in flatten(params).items():
                    out[f"p1.{k}"] = np.asarray(v, np.float32)
    for k, v in flatten(params).items():
        out[f"p.{k}"] = np.asarray(v, np.float32)
    return out


def serve(case, mesh, dp_axes):
    import jax
    import jax.numpy as jnp

    import repro.configs as jc
    from repro import compat
    from repro.configs import base as jbase
    from repro.models import recsys, transformer

    cfg, shp = serve_config(case, jc), serve_shape(case, jbase)
    mind = case.startswith("mind")
    mod = recsys if mind else transformer
    table = mod.param_defs(cfg) if mind else transformer.param_defs(cfg, 1, 1)
    sh = lambda t: jax.tree.map(lambda s: s.sharding, t)  # noqa: E731
    flat = {k: jnp.asarray(v, table[k][1]) for k, v in params_numpy(case, table).items()}
    params = jax.device_put(dict(flat) if mind else nest(flat), sh(mod.param_specs(cfg, mesh)))
    ispecs = mod.input_specs(cfg, shp, mesh, dp_axes)
    batch = serve_batch_numpy(case, cfg)

    def place(k, v):
        return jax.device_put(jnp.asarray(v), ispecs[k].sharding)

    with compat.set_mesh(mesh):
        if mind:
            step = jax.jit(recsys.make_step(cfg, shp))
            return {"out": np.asarray(step(params, {k: place(k, v) for k, v in batch.items()}),
                                      np.float32)}
        if case.startswith("prefill"):
            step = jax.jit(transformer.make_prefill_step(cfg, dp_axes, kv_chunk=8,
                                                         batch_chunks=2))
            return {"out": np.asarray(step(params, place("tokens", batch["tokens"])),
                                      np.float32)}
        step = jax.jit(transformer.make_decode_step(cfg, dp_axes))
        caches = jax.tree.map(lambda s: jax.device_put(jnp.zeros(s.shape, s.dtype), s.sharding),
                              ispecs["caches"])
        out = {}
        for i in range(DEC_STEPS):
            lg, caches = step(params, caches, place("tokens", batch["tokens"][i]),
                              place("cache_len", np.int32(i)))
            out[f"lg{i}"] = np.asarray(lg, np.float32)
    for name, c in caches.items():
        for j, t in enumerate(c if isinstance(c, tuple) else (c,)):
            out[f"c.{name}.{j}"] = np.asarray(t, np.float32)
    return out


def main() -> None:
    import jax

    from repro import compat

    out_dir = sys.argv[1]
    only = sys.argv[2] if len(sys.argv) > 2 else None
    group = sys.argv[3] if len(sys.argv) > 3 else None
    serving = group == "serve"
    families = [f for f in REF_FAMILIES
                if group is None or (group == "lm") == (f in LM_FAMILIES)]
    assert len(jax.devices()) == 8, jax.devices()
    for mname, (dims, axes, dp) in MESHES.items():
        if only and mname != only:
            continue
        mesh = compat.make_mesh_from_devices(jax.devices()[:math.prod(dims)], dims, axes)
        for fam in SERVE_CASES if serving else families:
            np.savez(f"{out_dir}/{fam}.{mname}.ref.npz",
                     **(serve if serving else run)(fam, mesh, dp))
            print("OK", fam, mname, flush=True)


if __name__ == "__main__":
    main()
