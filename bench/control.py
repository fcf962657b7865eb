#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference computed in
bfloat16, the precision below the configurations' float32, put in the
program's place.  A sound comparison has to find it not correct.

    python3 bench/control.py --workload lvj1k-single-s1024 --seconds 30 --seeds 11 12 13

Prints one JSON line a seed: its numbers, each beside its limit, and
``correct``.  The benchmark's own runs do not run it.
"""

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]

    import torch

    from perfkit import manifest
    from perfkit.harness import run_control

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    man = manifest.load_manifest(ROOT)
    cell = manifest.workload(man, args.workload)
    lim = manifest.limits(manifest.config(man, cell["config"]))
    for seed in args.seeds:
        numbers, ok, _ = run_control(man, cell, seed, args.seconds, "cuda")
        print(json.dumps({"workload": cell["name"], "seed": seed, "precision": "bfloat16",
                          "correct": ok, "compared": numbers.get("compared"),
                          "checks": {k: {"value": numbers.get(k), "limit": v}
                                     for k, v in lim.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
