"""The port's quickstart, serving, store and knowledge-graph examples on the
CPU, each beside the reference's example of the same program: the same tree
distances, edge counts, rounds, messages, cache hits and store sizes.

Every example runs as a process of its own (the port's with ``--device
cpu``, the reference's on JAX's CPU backend), all started together; each
asserts its own checks (the Mehlhorn oracle, served lanes against single
solves, disk against RAM, no rebuild on a repeated query).  Timings and
paths are dropped before the outputs are compared.  The knowledge-graph
workflow also runs on a (2, 2) mesh: 4 gloo ranks of the port's example
meeting through a FileStore, beside the reference on 4 forced host
devices."""

import os
import re
import subprocess
import sys

import pytest

_DIR = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.abspath(os.path.join(_DIR, ".."))
LIMIT_S = 300
EXAMPLES = ("quickstart", "serve_queries", "build_store", "steiner_knowledge_graph")
KG, KG_RANKS = "steiner_knowledge_graph", 4
# the knowledge-graph workflow's answers (D, |E_S|, rounds, messages) a
# query, as the reference prints them: the tree does not depend on the
# mesh, the rounds and messages do
KG_ANSWERS = {
    "(1, 1)": [(1517, 29, 21, 5408989), (13188, 194, 18, 4544356), (47705, 621, 16, 4018460)],
    "(2, 2)": [(1517, 29, 28, 7354193), (13188, 194, 24, 6212870), (47705, 621, 21, 5426880)],
}
KG_REPEAT_D = 10051

_TIMING = [
    (re.compile(r", [0-9.]+ ms\)"), ")"),  # a served query's latency
    (re.compile(r"QPS=[0-9.]+, p50=[0-9.]+ms, p99=[0-9.]+ms, "), ""),
    (re.compile(r", p50 [0-9.]+ms"), ""),
    (re.compile(r" in [0-9.]+s \([0-9,]+ edges/s\)"), ""),
    # the knowledge-graph workflow: a query's seconds, the repeat's seconds
    # and executables (the port: rebuilds), prepare's seconds and steps, the
    # mesh's devices (the port: ranks)
    (re.compile(r" \[ *[0-9.]+s( incl\. compile)?\]$"), ""),
    (re.compile(r" \[[0-9.]+s; [0-9]+ (cached executables|rebuilds)\]$"), ""),
    (re.compile(r"^prepared in [0-9.]+s \(\(.*\); "), "prepared ("),
    (re.compile(r" on ([0-9]+) (devices|ranks \(cpu\))$"), r" on \1"),
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
def outputs(tmp_path_factory):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(_ROOT, "src"), env.get("PYTHONPATH", "")])
    cmds = {}
    for name in EXAMPLES:
        cmds[(name, "torch")] = ([os.path.join(_ROOT, "examples", f"torch_{name}.py"),
                                  "--device", "cpu"], {})
        cmds[(name, "jax")] = ([os.path.join(_ROOT, "examples", f"{name}.py")], {})
    # the (2, 2) mesh: the port's ranks (rank 0 prints), the reference's devices
    store = tmp_path_factory.mktemp("kg_ranks") / "store"
    for r in range(KG_RANKS):
        cmds[(f"{KG} (2, 2)", "torch" if r == 0 else f"rank {r}")] = (
            [os.path.join(_ROOT, "examples", f"torch_{KG}.py"), "--device", "cpu",
             "--init-method", f"file://{store}"],
            dict(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(KG_RANKS)))
    cmds[(f"{KG} (2, 2)", "jax")] = (
        [os.path.join(_ROOT, "examples", f"{KG}.py")],
        dict(XLA_FLAGS=f"--xla_force_host_platform_device_count={KG_RANKS}"))
    procs = {k: subprocess.Popen([sys.executable, *c], env=dict(env, **extra),
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for k, (c, extra) in cmds.items()}
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


def _kg_answers(stdout):
    """(D, |E_S|, rounds, messages) of each query, and the repeat's D."""
    rows = [tuple(int(x) for x in m.groups()) for m in re.finditer(
        r"D= *([0-9]+) \|E_S\|= *([0-9]+) rounds= *([0-9]+) msgs= *([0-9]+)", stdout)]
    repeat = int(re.search(r"repeat \|S\|=64 \(warm [a-z]+\): D=([0-9]+)", stdout).group(1))
    return rows, repeat


def test_knowledge_graph_on_a_2x2_mesh_prints_the_reference_results(outputs):
    """4 gloo ranks of the port's example against the reference on 4 forced
    host devices; every rank exits 0, rank 0 prints the reference's lines."""
    name = f"{KG} (2, 2)"
    for key, (rc, _, stderr) in outputs.items():
        if key[0] == name:
            assert rc == 0, (key, stderr)
    _, stdout, _ = outputs[(name, "torch")]
    _, jstdout, _ = outputs[(name, "jax")]
    assert _facts(stdout) == _facts(jstdout)
    assert _facts(stdout)[0] == "mesh: {'data': 2, 'model': 2} on 4"
    assert stdout.count("verified against sequential Mehlhorn") == 2


@pytest.mark.parametrize("mesh", list(KG_ANSWERS))
def test_knowledge_graph_answers(outputs, mesh):
    """The printed D, |E_S|, rounds and messages of both packages are the
    fixed answers, and the repeated query rebuilt nothing."""
    name = KG if mesh == "(1, 1)" else f"{KG} (2, 2)"
    for pkg in ("torch", "jax"):
        rows, repeat = _kg_answers(outputs[(name, pkg)][1])
        assert rows == KG_ANSWERS[mesh], (pkg, rows)
        assert repeat == KG_REPEAT_D, pkg
    assert "; 0 rebuilds]" in outputs[(name, "torch")][1]
