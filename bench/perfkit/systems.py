"""The system under test: ``repro_torch``'s solver and server, built from a
configuration's file.

A configuration's ``system`` names one of :data:`SYSTEMS`; its ``solver``
or ``serve`` entry holds the program's own settings, passed as they are.
"""

from __future__ import annotations

from typing import Dict


class SolverSystem:
    """``SteinerSolver(SolverConfig(**cfg["solver"])).prepare(graph)``; a
    query is ``PreparedGraph.solve(seeds)``, whose answer is every stage it
    produced (``SolveOutput.raw``).  A mesh backend's ``mesh_shape`` (a
    list in the file) reaches ``SolverConfig`` as a tuple; every rank of
    its world builds this system and makes the same calls."""

    kind = "solver"

    def __init__(self, cfg: dict, graph, device):
        from repro_torch.solver import SolverConfig, SteinerSolver

        conf = dict(cfg["solver"])
        if "mesh_shape" in conf:
            conf["mesh_shape"] = tuple(conf["mesh_shape"])
        self.handle = SteinerSolver(SolverConfig(**conf), device=device).prepare(graph)
        self.lanes = 1

    def warmup(self, seeds) -> None:
        self.handle.solve(seeds)

    def call(self, seeds):
        return self.handle.solve(seeds)

    @staticmethod
    def rounds(out) -> int:
        return int(out.telemetry.iterations)

    @staticmethod
    def messages(out) -> int:
        return int(out.telemetry.messages)


class ServerSystem:
    """``SteinerServer(graph, ServeConfig(**cfg["serve"]))``; requests go in
    by ``submit`` and come back from ``flush``, whose answer for a request is
    its total distance and edge count."""

    kind = "server"

    def __init__(self, cfg: dict, graph, device):
        from repro_torch.serve import ServeConfig, SteinerServer

        conf = dict(cfg["serve"])
        conf["buckets"] = tuple(conf["buckets"])
        self.server = SteinerServer(graph, ServeConfig(**conf), device=device)
        self.buckets = conf["buckets"]
        self.lanes = int(conf["max_batch"])

    def warmup(self, seeds) -> None:
        """``SteinerServer.warmup``: one batch of every bucket."""
        self.server.warmup()

    def submit(self, seeds) -> int:
        return self.server.submit(seeds)

    def flush(self) -> Dict[int, object]:
        return self.server.flush()


SYSTEMS = {"solver": SolverSystem, "server": ServerSystem}


def build(cfg: dict, graph, device):
    return SYSTEMS[cfg["system"]](cfg, graph, device)
