#!/usr/bin/env python3
"""Runs one cell of ``BENCHMARK.json`` once on this machine's GPU.

    python3 bench/run.py --workload lvj1k-single-s1024 --seed 7 --seconds 30 --trace 0

Prints the run's result as one JSON object, the last line of standard
output, and the numbers the comparison with the plain reference checked,
each beside its limit, as the last lines of standard error.  Exits with a
code other than 0, and prints no result, where there is no CUDA device or
fewer than the cell asks for, or where JAX or the JAX package ``repro``
was loaded.  Every build and kernel cache stays inside the checkout.

A cell on one chip runs in this process.  A cell on more runs one rank a
card, each rank this script again with ``--rank-spec``: this process
launches them (``perfkit.ranks``), waits for them within its limit and
prints rank 0's result once every rank has exited 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank-spec", help=argparse.SUPPRESS)  # a rank of a launched world
    args = p.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]

    from perfkit import manifest

    if args.rank_spec:
        from perfkit.harness import rank_main

        return rank_main(json.loads(args.rank_spec), forbidden_modules)
    man = manifest.load_manifest(ROOT)
    cell = manifest.workload(man, args.workload)
    chips = int(cell["chips"])
    if chips > 1:
        # the launcher imports no torch: each rank looks for its card
        from perfkit import ranks

        size = ranks.mesh_size(manifest.config(man, cell["config"]))
        if size != chips:
            print(f"no result: {cell['name']} asks for {chips} chips, its mesh_shape "
                  f"for {size} ranks", file=sys.stderr)
            return 2
        run = ranks.launch(cell["name"], args.seed, args.seconds, bool(args.trace), chips,
                           t_start=T_START)
        if run.rc != 0:
            print(f"no result: {run.why}", file=sys.stderr)
            return run.rc
        result, lines = run.result, run.lines
    else:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"no result: {cell['name']} needs {chips} CUDA device(s), this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2

        from perfkit.harness import run_cell

        result, lines = run_cell(man, cell, args.seed, args.seconds, bool(args.trace),
                                 device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"no result: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
