"""No JAX on the benchmark's path: a run loads no module whose top-level
name is jax, jaxlib or the JAX package ``repro`` (``repro_torch`` is not
``repro``), opens nothing under ``benchmarks/`` and no ``BENCH_*.json``,
and gives no result where it cannot run."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# every cell once, on the CPU at a small size, under an audit hook that
# records each file the process opens
PROGRAM = r"""
import json, sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" else None)
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import importlib.util
spec = importlib.util.spec_from_file_location("bench_run", sys.argv[1] + "/run.py")
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
import torch
torch.set_num_threads(1)
from perfkit import manifest
from perfkit.harness import run_cell, run_control
man = manifest.load_manifest()
small = {"config": {"graph": {"scale": 8}},
         "traffic": {"rate_qps": 50.0, "pool": 32, "check": {"sample": 1, "pool": 2}}}
for w in man["workloads"]:
    if w["chips"] > 1:  # one rank a card: test_bench_ranks.py runs it through the launcher
        continue
    o = dict(small)
    if manifest.traffic(w["traffic"])["kind"] == "closed":
        o["traffic"] = {**small["traffic"], "sizes": {"dist": "fixed", "value": 16}}
    for trace in (False, True):
        res, _ = run_cell(man, w, 3000000001, 0.05, trace, device="cpu", overrides=o)
        assert res["correct"], (w["name"], res)
    run_control(man, w, 3000000001, 0.05, device="cpu", overrides=o)
print(json.dumps({"modules": sorted({m.split(".")[0] for m in sys.modules}),
                  "forbidden": run.forbidden_modules(), "opened": sorted(set(opened))}))
"""


def test_a_run_loads_no_jax_and_reads_no_old_benchmark():
    out = subprocess.run([sys.executable, "-c", PROGRAM, str(BENCH), str(ROOT / "src")],
                         capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch" in rec["modules"] and "perfkit" in rec["modules"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(rec["modules"])
    assert rec["forbidden"] == []
    old = [p for p in rec["opened"]
           if "/benchmarks/" in p or os.path.basename(p).startswith("BENCH_")]
    assert old == []


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    args = ["--workload", "lvj1k-single-s8", "--seed", "1", "--seconds", "1", "--trace", "0"]
    if not _has_cuda():
        # this machine has no CUDA device: no result, a code other than 0
        out = subprocess.run([sys.executable, "bench/run.py", *args], capture_output=True,
                             text=True, timeout=120, cwd=ROOT, env=env)
        assert out.returncode != 0 and out.stdout.strip() == ""
    # a checkout of only BENCHMARK.json and bench/: the program is missing
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = [sys.argv[1] + '/bench', sys.argv[1] + '/src']\n"
            "from perfkit import manifest\nfrom perfkit.harness import run_cell\n"
            "man = manifest.load_manifest(); w = man['workloads'][0]\n"
            "print(run_cell(man, w, 1, 0.05, False, device='cpu'))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "repro_torch" in out.stderr


def _has_cuda():
    import torch

    return torch.cuda.is_available()
