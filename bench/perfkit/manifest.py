"""``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the one its ``configs`` entry gives; a traffic
mix ``<t>`` is ``bench/traffic/<t>.json``; a metric ``<m>`` (end to end or
per layer) is read by ``bench/metrics/<m>.py``, whose ``read(rec)`` returns
the value or None where the run has nothing to read.  Adding a cell, a
configuration or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}; known: {[e['name'] for e in entries]}")


def workload(manifest: dict, name: str) -> dict:
    return _by_name(manifest["workloads"], name, "workload")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration file of the ``configs`` entry ``name``."""
    entry = _by_name(manifest["configs"], name, "configuration")
    with open(root / entry["file"]) as f:
        cfg = json.load(f)
    if cfg.get("name") != name:
        raise ValueError(f"{entry['file']} names itself {cfg.get('name')!r}, not {name!r}")
    return cfg


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / "traffic" / f"{name}.json") as f:
        spec = json.load(f)
    if spec.get("name") != name:
        raise ValueError(f"traffic/{name}.json names itself {spec.get('name')!r}")
    return spec


def load_module(path: Path, name: str):
    """Imports one file of ``bench/`` by path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"perfkit_file_{abs(hash(str(path)))}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {name} from {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """``read(rec)`` of ``bench/metrics/<name>.py``."""
    return load_module(bench_dir / "metrics" / f"{name}.py", name).read


def reference(cfg: dict, bench_dir: Path = BENCH_DIR):
    """The plain reference module a configuration names (``reference``, a
    path under ``bench/``)."""
    return load_module(bench_dir / cfg["reference"], cfg["reference"])


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(manifest: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``.

    A metric with a ``workloads`` key is reported in the cells it lists; an
    end-to-end metric without one in every cell; a per-layer metric without
    one in every cell that reports the end-to-end metric it ``moves``.
    """
    e2e = [m for m in manifest["end_to_end"] if _reports(m, cell)]
    if not trace:
        return e2e
    e2e_names = {m["name"] for m in e2e}
    out = []
    for m in manifest["per_layer"]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e_names:
            out.append(m)
    return out


def limits(cfg: dict) -> Dict[str, float]:
    """The limit of each number the comparison reports (the config's)."""
    return dict(cfg["limits"])
