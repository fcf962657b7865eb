"""One gloo rank of the sharded train steps (tests/test_torch_sharded_steps.py).

    python tests/_torch_sharded_prog.py RANK WORLD STORE_FILE OUT_DIR [serve]

Rendezvous through a FileStore, then every family of
_torch_sharded_cases.py on each mesh of WORLD ranks (with ``serve``, every
serving case: tests/test_torch_sharded_serve.py); rank 0 writes
``OUT_DIR/<family or case>.<mesh>.port.npz``.  Imports neither JAX nor the
JAX package.
"""

import math
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from _torch_sharded_cases import FAMILIES, MESHES, SERVE_CASES, port_run, port_serve


def main() -> None:
    rank, world, store_file, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    serve = sys.argv[5:] == ["serve"]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    from repro_torch.launch.mesh import make_test_mesh

    for mname, (dims, axes, dp) in MESHES.items():
        if math.prod(dims) != world:
            continue
        mesh = make_test_mesh(dims, axes, device="cpu")
        for fam in SERVE_CASES if serve else FAMILIES:
            res = (port_serve if serve else port_run)(fam, mesh, dp)
            if rank == 0:
                np.savez(f"{out_dir}/{fam}.{mname}.port.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
