"""The solver facade: one config, one prepare, many solves.

Usage::

    from repro_torch.solver import SolverConfig, SteinerSolver

    solver = SteinerSolver(SolverConfig())  # backend "single", mode "bucket"
    handle = solver.prepare(graph)        # graph to the GPU (and ELL view), once
    out = handle.solve(seeds)             # Voronoi rounds + tail
    out.total_distance                    # D(G_S)

``SolverConfig(backend="batch", ...)`` takes a (B, S) seed batch instead and
returns (B,) totals and edge counts.  ``backend="mesh1d"`` and ``"mesh2d"``
run one rank of a ``torch.distributed`` mesh (every rank makes the same
calls); ``mesh_shape=(1, 1)`` needs no setup.  ``prepare`` also takes an on-disk
:class:`~repro_torch.graphstore.GraphStore` (from ``open_store``); such a
handle follows the store's delta log with :meth:`PreparedGraph.refresh`.
The solver runs on ``device="cuda"`` unless given another device; with no
CUDA device present the default raises instead of running on the CPU.

With :mod:`repro_torch.obs` enabled, ``prepare``, ``refresh`` and ``solve``
record spans, ``solve`` its seconds and messages and its per-round
telemetry (as the reference's); with obs off, ``solve`` takes the same path
as if obs did not exist.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.mesh import rank_device
from repro_torch.solver.config import SolverConfig
from repro_torch.solver.registry import SolveOutput, get_backend


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must be present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path instead of the kernels"
        )
    return device


class PreparedGraph:
    """A graph bound to one backend and device with its preprocessing done.

    Created by :meth:`SteinerSolver.prepare`; do not construct directly.
    """

    def __init__(self, config: SolverConfig, backend, artifacts, device):
        self.config = config
        self.device = device
        self._backend = backend
        self._artifacts = artifacts
        # the resident COO graph on the device (a store's, materialized)
        self.graph = artifacts["graph"]
        # delta-log epoch of a store at prepare time (None for in-memory
        # graphs): refresh() compares it against the store's current epoch
        store = artifacts.get("store")
        self.epoch = None if store is None else store.epoch
        # hub-sorted stores relabel vertices; solve() takes ORIGINAL ids
        # and translates them through the persisted permutation
        perm = None if store is None else store.vertex_perm
        self._vertex_perm = None if perm is None else np.asarray(perm)

    @property
    def backend(self) -> str:
        return self._backend.name

    @property
    def preprocessing(self):
        """What :meth:`SteinerSolver.prepare` computed for this backend."""
        return tuple(self._backend.preprocessing)

    def artifact(self, name: str):
        """One preprocessing artifact by name ("graph", "ell",
        "blocked_layout", "store"; for the mesh backends "mesh", "part"
        and "edges", this rank's shard); None if absent."""
        return self._artifacts.get(name)

    def refresh(self) -> dict:
        """Re-prepares what the store's delta log changed.

        For a handle prepared from a :class:`~repro_torch.graphstore.GraphStore`
        whose epoch moved on since prepare (``append_deltas``), this reloads
        the store and rebuilds the epoch-dependent artifacts: the resident
        COO graph, the ELL view and (with ``src_block`` on the card) the
        blocked layout of that view.  Returns ``{"refreshed": (...),
        "from_epoch", "epoch"}``; a no-op (same epoch, or an in-memory
        graph) returns ``refreshed=()``.
        """
        store = self._artifacts.get("store")
        if store is None:
            return {"refreshed": (), "from_epoch": self.epoch, "epoch": self.epoch}
        store.reload(verify=False)
        if store.epoch == self.epoch:
            return {"refreshed": (), "from_epoch": self.epoch, "epoch": store.epoch}
        with obs.span(
            "refresh", backend=self.backend, from_epoch=self.epoch, to_epoch=store.epoch,
        ):
            self._artifacts = self._backend.prepare(self.config, store, self.device)
        self.graph = self._artifacts["graph"]
        prev, self.epoch = self.epoch, store.epoch
        return {"refreshed": tuple(sorted(k for k in self._artifacts if k != "store")),
                "from_epoch": prev, "epoch": store.epoch}

    def solve(self, seeds, *, warm_state=None) -> SolveOutput:
        """Solves one query, (S,) seed ids, or a (B, S) batch for
        backend="batch" (numpy, list or tensor), in the graph's original
        vertex numbering: a handle prepared from a hub-sorted store
        translates them through the store's ``vertex_perm``.

        ``warm_state``: optional :class:`~repro_torch.core.voronoi.VoronoiState`
        warm start (backend "single", modes "dense", "bucket" and
        "frontier"; see ``repro.delta.resolve.reset_affected`` for how the
        reference builds a sound one from a previous epoch's state).
        """
        if warm_state is not None and self.backend != "single":
            raise ValueError(
                f"warm_state is only supported by backend 'single', not {self.backend!r}"
            )
        if self._vertex_perm is not None:
            if isinstance(seeds, torch.Tensor):
                seeds = seeds.cpu().numpy()
            seeds = self._vertex_perm[np.asarray(seeds, np.int64)]
        seeds = torch.as_tensor(seeds, dtype=torch.int32, device=self.device)
        if seeds.dim() != self._backend.seeds_ndim:
            want = "(S,)" if self._backend.seeds_ndim == 1 else "(B, S)"
            raise ValueError(
                f"backend {self.backend!r} expects {want} seeds, got shape "
                f"{tuple(seeds.shape)}"
            )
        kw = {} if warm_state is None else {"warm_state": warm_state}
        num_seeds = int(seeds.shape[-1])
        if not obs.enabled():
            return self._backend.solve(self.config, self._artifacts, seeds, num_seeds, **kw)
        # The backend's solve ends in one fetch of its totals and counters
        # to the host, so the span covers the device's work with no sync
        # of its own.
        cfg = self.config
        labels = {"backend": self.backend, "mode": cfg.mode}
        t0 = obs.now()
        with obs.span("solve", backend=self.backend, mode=cfg.mode, num_seeds=num_seeds):
            out = self._backend.solve(cfg, self._artifacts, seeds, num_seeds, **kw)
        t1 = obs.now()
        hist = obs.histogram(
            "solver_solve_seconds", "wall time of one PreparedGraph.solve", labels=labels
        )
        if hist is not None:
            hist.observe(t1 - t0)
        if out.telemetry is not None:
            ctr = obs.counter(
                "solver_messages_total",
                "candidate transmissions attempted across solves",
                labels=labels,
            )
            if ctr is not None:
                ctr.inc(out.telemetry.messages)
            obs.emit_round_telemetry(
                out.telemetry.per_round, t0, t1, label=f"{self.backend}/{cfg.mode}",
                per_rank=out.telemetry.per_rank,
            )
        return out


class SteinerSolver:
    """Validates the config, prepares graphs on ``device``, hands out solve
    handles."""

    def __init__(self, config: SolverConfig = SolverConfig(), device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        if config.backend in ("mesh1d", "mesh2d"):
            # a mesh rank runs on cuda:LOCAL_RANK unless given an index
            self.device = rank_device(self.device)
        self._backend = get_backend(config.backend)
        self._backend.validate(config)

    def prepare(self, graph) -> PreparedGraph:
        """Runs the backend's one-time preprocessing for an in-memory
        :class:`~repro_torch.core.graph.Graph` (moved to the solver's device
        if it lives elsewhere) or an on-disk
        :class:`~repro_torch.graphstore.GraphStore` (materialized on it)."""
        with obs.span("prepare", backend=self.config.backend, mode=self.config.mode):
            artifacts = self._backend.prepare(self.config, graph, self.device)
        return PreparedGraph(self.config, self._backend, artifacts, self.device)
