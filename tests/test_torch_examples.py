"""The port's quickstart, serving and store examples on the CPU, each beside
the reference's example of the same program: the same tree distances, edge
counts, rounds, messages, cache hits and store sizes.

Every example runs as a process of its own (the port's with ``--device
cpu``, the reference's on JAX's CPU backend), all started together; each
asserts its own checks (the Mehlhorn oracle, served lanes against single
solves, disk against RAM).  Timings and paths are dropped before the
outputs are compared."""

import os
import re
import subprocess
import sys

import pytest

_DIR = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.abspath(os.path.join(_DIR, ".."))
LIMIT_S = 300
EXAMPLES = ("quickstart", "serve_queries", "build_store")

_TIMING = [
    (re.compile(r", [0-9.]+ ms\)"), ")"),  # a served query's latency
    (re.compile(r"QPS=[0-9.]+, p50=[0-9.]+ms, p99=[0-9.]+ms, "), ""),
    (re.compile(r", p50 [0-9.]+ms"), ""),
    (re.compile(r" in [0-9.]+s \([0-9,]+ edges/s\)"), ""),
]


def _facts(stdout: str):
    """The example's printed results without timings, paths or the lines
    that name the package's machinery (warm-up, the store's path)."""
    out = []
    for line in stdout.splitlines():
        if line.startswith(("warmed", "built ")):
            continue
        for pat, rep in _TIMING:
            line = pat.sub(rep, line)
        out.append(line.replace("(warm handle)", "(warm executable)"))
    return out


@pytest.fixture(scope="module")
def outputs():
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(_ROOT, "src"), env.get("PYTHONPATH", "")])
    procs = {}
    for name in EXAMPLES:
        procs[(name, "torch")] = [os.path.join(_ROOT, "examples", f"torch_{name}.py"),
                                  "--device", "cpu"]
        procs[(name, "jax")] = [os.path.join(_ROOT, "examples", f"{name}.py")]
    procs = {k: subprocess.Popen([sys.executable, *c], env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in procs.items()}
    res = {}
    for k, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=LIMIT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, stderr = p.communicate()
        res[k] = (p.returncode, stdout, stderr[-4000:])
    return res


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_and_prints_the_reference_results(outputs, name):
    rc, stdout, stderr = outputs[(name, "torch")]
    assert rc == 0, stderr
    jrc, jstdout, jstderr = outputs[(name, "jax")]
    assert jrc == 0, jstderr
    assert _facts(stdout) == _facts(jstdout)
    assert len(_facts(stdout)) >= 6


def test_quickstart_checks_the_oracle(outputs):
    _, stdout, _ = outputs[("quickstart", "torch")]
    assert "matches sequential Mehlhorn reference exactly (D = 1010)" in stdout
    assert "tree validity: OK" in stdout


def test_store_example_leaves_no_store_behind(outputs):
    _, stdout, _ = outputs[("build_store", "torch")]
    path = next(ln.split()[1] for ln in stdout.splitlines() if ln.startswith("built "))
    assert not os.path.exists(path)
