"""``compressed_psum`` across processes (tests/test_torch_compression.py).

    python tests/_torch_compress_prog.py port RANK WORLD STORE_FILE OUT_DIR
    python tests/_torch_compress_prog.py ref OUT_DIR

``port``: one gloo rank (a FileStore rendezvous) reduces its own gradients
with the port's ``compressed_psum`` and writes
``OUT_DIR/psum<WORLD>.rank<RANK>.npz``.  ``ref``: the reference's
``compressed_psum`` under ``shard_map`` over 2 and 4 of 8 forced host
devices, on the same per-rank inputs; writes ``OUT_DIR/psum<W>.ref.npz``.
"""

import sys
from datetime import timedelta

import numpy as np

SHAPES = {"a": (300,), "b": (17, 33), "c": (512,)}


def rank_inputs(rank: int):
    """(grads, err) of one rank, from a seed."""
    r = np.random.default_rng(100 + rank)
    grads = {k: (r.normal(size=s) * (1 + rank)).astype(np.float32) for k, s in SHAPES.items()}
    err = {k: (r.normal(size=s) * 1e-3).astype(np.float32) for k, s in SHAPES.items()}
    return grads, err


def port(rank: int, world: int, store_file: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.compression import compressed_psum

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    g, e = rank_inputs(rank)
    red, new_err = compressed_psum({k: torch.from_numpy(v) for k, v in g.items()},
                                   {k: torch.from_numpy(v) for k, v in e.items()})
    np.savez(f"{out_dir}/psum{world}.rank{rank}.npz",
             **{f"red.{k}": v.numpy() for k, v in red.items()},
             **{f"err.{k}": v.numpy() for k, v in new_err.items()})
    dist.barrier()
    dist.destroy_process_group()


def ref(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.distributed.compression import compressed_psum

    assert len(jax.devices()) == 8, jax.devices()
    for world in (2, 4):
        mesh = compat.make_mesh_from_devices(jax.devices()[:world], (world,), ("pod",))
        ins = [rank_inputs(r) for r in range(world)]
        g = {k: jnp.stack([i[0][k] for i in ins]) for k in SHAPES}
        e = {k: jnp.stack([i[1][k] for i in ins]) for k in SHAPES}

        def body(g, e):
            g = {k: v[0] for k, v in g.items()}
            e = {k: v[0] for k, v in e.items()}
            red, ne = compressed_psum(g, e, "pod")
            return ({k: v[None] for k, v in red.items()}, {k: v[None] for k, v in ne.items()})

        f = compat.shard_map(body, mesh=mesh, in_specs=(P("pod"), P("pod")),
                             out_specs=(P("pod"), P("pod")))
        with jax.disable_jit():  # op by op, as the reference writes it (no FMA contraction)
            red, ne = f(g, e)
        np.savez(f"{out_dir}/psum{world}.ref.npz",
                 **{f"red.{k}": np.asarray(v) for k, v in red.items()},
                 **{f"err.{k}": np.asarray(v) for k, v in ne.items()})


if __name__ == "__main__":
    if sys.argv[1] == "port":
        port(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        ref(sys.argv[2])
