"""Elastic restore on gloo ranks (tests/test_torch_checkpoint.py).

    python tests/_torch_ckpt_ranks_prog.py RANK WORLD STORE_FILE DIR

Rendezvous through a FileStore, then on a (4,) mesh ("data") and a (2, 2)
mesh ("data", "model"): restore ``DIR/plain.npz`` (written unsharded by the
port) and ``DIR/ref.npz`` (written by the reference) onto the mesh with
``load_pytree(..., shardings=)``, check that each rank holds exactly its
own block and that the gathered arrays equal the file's bit for bit, then
save the DTensors back to ``DIR/from_ranks.npz`` (rank 0 writes), and
save them with a ``CheckpointManager`` that every rank restores as soon as
its ``save`` returns.  Exits non-zero on any mismatch.  Imports neither JAX nor the JAX package.
"""

import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist


def template():
    """The tree both packages write: an LM's parameters (the reduced
    starcoder2, bf16) and plain leaves of each dtype."""
    import repro_torch.configs as tc
    from repro_torch.models import transformer

    cfg = tc.get_arch("starcoder2-3b").reduced
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, {"params": params,
                 "extra": {"w": torch.arange(64, dtype=torch.float32).reshape(16, 4),
                           "n": torch.arange(12, dtype=torch.int32),
                           "s": torch.tensor(3.5, dtype=torch.bfloat16)}}


def shardings(cfg, mesh):
    from repro_torch.distributed.sharding import NamedSharding, P, named_sharding
    from repro_torch.models import transformer

    if "model" in mesh.mesh_dim_names:
        ps = transformer.param_specs(cfg, mesh)
    else:
        from repro_torch.tree import tree_map

        _, tree = template()
        ps = tree_map(lambda t: named_sharding(mesh, t.shape, "data"), tree["params"])
    return {"params": ps,
            "extra": {"w": named_sharding(mesh, (16, 4), "data", None),
                      "n": named_sharding(mesh, (12,), "data"),
                      "s": NamedSharding(mesh, P())}}


def main() -> None:
    rank, world, store_file, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
    from repro_torch.checkpoint.ckpt import _flatten_with_paths
    from repro_torch.launch.mesh import make_test_mesh

    cfg, tmpl = template()
    for dims, axes in (((4,), ("data",)), ((2, 2), ("data", "model"))):
        mesh = make_test_mesh(dims, axes, device="cpu")
        sh = shardings(cfg, mesh)
        flat_sh = _flatten_with_paths(sh)
        for name in ("plain", "ref"):
            back = load_pytree(tmpl, f"{d}/{name}.npz", shardings=sh)
            with np.load(f"{d}/{name}.npz") as z:
                for key, t in _flatten_with_paths(back).items():
                    s = getattr(flat_sh[key], "sharding", flat_sh[key])
                    assert tuple(t.placements) == s.placements, (key, t.placements)
                    assert tuple(t.to_local().shape) == s.shard_shape(t.shape), key
                    full = t.full_tensor()
                    if full.dtype == torch.bfloat16:
                        got = full.view(torch.int16).numpy().view(np.uint8).reshape(
                            *full.shape, 2) if full.ndim else full.reshape(1).view(
                            torch.int16).numpy().view(np.uint8)
                    else:
                        got = full.numpy()
                    np.testing.assert_array_equal(got, z[key], err_msg=f"{dims} {name} {key}")
        save_pytree(back, f"{d}/from_ranks{len(dims)}.npz")
        # the manager returns on every rank once rank 0 has written: each
        # rank restores the checkpoint at once
        mgr = CheckpointManager(f"{d}/mgr{len(dims)}", keep=1)
        mgr.save(1, back)
        step, again = mgr.restore(tmpl, shardings=sh)
        assert step == 1, step
        flat_back = _flatten_with_paths(back)
        for key, t in _flatten_with_paths(again).items():
            assert torch.equal(t.full_tensor(), flat_back[key].full_tensor()), key
        dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
