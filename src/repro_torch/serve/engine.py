"""Micro-batching query engine over one resident graph.

Counterpart of ``repro.serve.engine``: queries arrive one at a time, the
engine canonicalizes and bucket-pads them (:mod:`repro_torch.serve.plan`),
answers repeats from an LRU result cache, and drains the rest through one
prepared ``"batch"``-backend solver handle (:mod:`repro_torch.solver`) in
fixed-shape (max_batch, bucket) micro-batches.

Lifecycle::

    server = SteinerServer(g, ServeConfig(max_batch=8))  # mode "bucket"
    server.warmup()                  # optional: one batch a bucket first
    t = server.submit([3, 17, 42])   # enqueue, returns a ticket
    results = server.flush()         # run pending micro-batches
    results[t].total_distance

or one-shot: ``server.query([3, 17, 42])``.  Counters (QPS, p50/p99
latency, cache hit rate, padding waste) via ``server.stats()``.

The server runs on ``device="cuda"`` unless given another device, in every
mode of the batch backend ("dense", "bucket" by default, "pallas").

Store-backed servers (``graph_path=`` or a
:class:`~repro_torch.graphstore.GraphStore` as ``g``) are *epoch-aware*:
:meth:`SteinerServer.apply_deltas` appends edge deltas to the store's log
(:mod:`repro_torch.delta`), refreshes the solver handle, and re-validates
the result cache against the changed vertices instead of flushing it.  An
entry whose converged Voronoi labels show every changed vertex unreached is
still exact and keeps serving; the rest are evicted (counted in
``cache_invalidations_total``) and, on their next query, re-solved *warm*
from the retained per-key Voronoi state
(:func:`repro_torch.delta.resolve.reset_affected`), so only the affected
cells are relaxed again.  ``stats()`` keeps the reference's keys.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.core.tree import tree_edge_sets
from repro_torch.core.voronoi import VoronoiState
from repro_torch.delta.log import append_deltas, read_segment
from repro_torch.delta.resolve import entry_survives, reset_affected
from repro_torch.graphstore.loader import GraphStore, open_store
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import plan as planmod
from repro_torch.solver import SolverConfig, SteinerSolver
from repro_torch.solver.registry import to_host


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static service configuration (the same fields and defaults as the
    reference, which validates nothing here either)."""

    buckets: Tuple[int, ...] = planmod.DEFAULT_BUCKETS
    max_batch: int = 8  # B: lanes per micro-batch
    cache_capacity: int = 4096  # LRU entries (0 disables caching)
    mode: str = "bucket"  # Voronoi schedule: "dense" | "bucket" | "pallas"
    mst_algo: str = "prim"
    delta: Optional[float] = None
    max_iters: Optional[int] = None
    materialize_edges: bool = False  # host-side edge sets in results
    # retained per-key Voronoi states for warm affected-cell re-solves after
    # apply_deltas (store-backed servers; 0 disables retention and every
    # invalidated entry re-solves cold through the batch path)
    state_capacity: int = 64


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """One served query (cache-hit results are the cached object)."""

    key: Tuple[int, ...]
    bucket: int
    total_distance: float
    num_edges: int
    # immutable so cached entries can be shared across repeat queries
    edges: Optional[FrozenSet[Tuple[int, int]]]  # None unless materialize_edges
    from_cache: bool
    latency_s: float

    def with_latency(self, latency_s: float, from_cache: bool) -> "QueryResult":
        return dataclasses.replace(self, latency_s=latency_s, from_cache=from_cache)


class LRUCache:
    """Plain OrderedDict LRU keyed on the canonical seed tuple."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: "collections.OrderedDict[Tuple[int, ...], QueryResult]" = (
            collections.OrderedDict()
        )

    def get(self, key) -> Optional[QueryResult]:
        if self.capacity <= 0:
            return None
        hit = self._d.get(key)
        if hit is not None:
            self._d.move_to_end(key)
        return hit

    def put(self, key, value: QueryResult) -> None:
        if self.capacity <= 0:
            return
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def keys(self) -> List[Tuple[int, ...]]:
        """Snapshot of resident keys (for the epoch-bump validity scan)."""
        return list(self._d.keys())

    def pop(self, key) -> None:
        """Evicts one entry (no-op when absent)."""
        self._d.pop(key, None)

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)


@dataclasses.dataclass
class _Pending:
    ticket: int
    plan: planmod.QueryPlan
    t_submit: float


class SteinerServer:
    """Batched Steiner query server over one resident graph.

    The graph comes from memory (``g``, a :class:`Graph`) or off disk
    (``graph_path`` naming a ``.gstore`` directory, or a
    :class:`~repro_torch.graphstore.GraphStore` as ``g``).  It is placed on
    ``device`` once, where the prepared ``"batch"`` handle keeps it and its
    ELL view for every micro-batch.  Hub-sorted stores stay transparent:
    the handle translates submitted ORIGINAL seed ids through the store's
    ``vertex_perm`` (``materialize_edges`` output is in stored ids).
    """

    def __init__(
        self,
        g: Union[Graph, GraphStore, None] = None,
        config: ServeConfig = ServeConfig(),
        *,
        graph_path: Optional[str] = None,
        device="cuda",
    ):
        if (g is None) == (graph_path is None):
            raise ValueError("pass exactly one of g= or graph_path=")
        if graph_path is not None:
            g = open_store(graph_path)
        self.config = config
        # one prepared solver handle: every micro-batch goes to the "batch"
        # backend (the handle validates the mode and the graph type)
        self._handle = SteinerSolver(
            SolverConfig(
                backend="batch",
                mode=config.mode,
                mst_algo=config.mst_algo,
                delta=config.delta,
                max_iters=config.max_iters,
                batch_size=config.max_batch,
            ),
            device=device,
        ).prepare(g)
        self.g = self._handle.graph  # the resident COO graph, on the device
        # epoch awareness: store-backed servers track the delta-log epoch
        # and keep per-key converged Voronoi states for warm re-solves
        self._store = g if isinstance(g, GraphStore) else None
        self.epoch = self._handle.epoch  # None for in-memory graphs
        perm = None if self._store is None else self._store.vertex_perm
        self._vertex_perm = None if perm is None else np.asarray(perm)
        # key -> (epoch, bucket, dist, lab, pred) host snapshots of the
        # converged state, LRU-bounded by config.state_capacity
        self._states: "collections.OrderedDict[Tuple[int, ...], tuple]" = (
            collections.OrderedDict()
        )
        # (from_epoch, to_epoch, changed | None) per bump_epoch call: warm
        # re-solves union the changed sets since a state's epoch; a None
        # entry (unknown changed set) blocks warm starts across it
        self._changed_log: List[Tuple[int, int, Optional[np.ndarray]]] = []
        self._warm_handle = None  # lazy single-backend handle on self.g
        self.cache = LRUCache(config.cache_capacity)
        self._queues: Dict[int, "collections.deque[_Pending]"] = {
            b: collections.deque() for b in sorted(config.buckets)
        }
        self._next_ticket = 0
        # results computed by a flush() that failed part-way (a later
        # batch raised): delivered by the next flush instead of being lost
        # with the exception
        self._ready: Dict[int, QueryResult] = {}
        # Service counters live on a per-server MetricsRegistry: stats()
        # works on any server, and two servers in one process do not share
        # counters.  Cache hits are ready at batch assembly while fresh
        # solves wait for the batch, so the two latency populations get
        # separate streams.
        self.metrics = MetricsRegistry()
        self._m_completed = self.metrics.counter(
            "serve_queries_completed_total", "queries answered (fresh + cached)"
        )
        self._m_hits = self.metrics.counter(
            "serve_cache_hits_total", "queries answered from the LRU result cache"
        )
        self._m_lanes = self.metrics.counter(
            "serve_lanes_run_total", "micro-batch lanes launched (incl. padding)"
        )
        self._m_padded = self.metrics.counter(
            "serve_lanes_padded_total", "inert padding lanes launched"
        )
        self._m_lat = {
            path: self.metrics.histogram(
                "serve_latency_seconds",
                "submit-to-result latency of one query",
                labels={"path": path},
            )
            for path in ("fresh", "cached")
        }
        self._m_batches = {
            b: self.metrics.counter(
                "serve_batches_total",
                "fixed-shape micro-batches executed",
                labels={"bucket": str(b)},
            )
            for b in config.buckets
        }
        self._m_invalidated = self.metrics.counter(
            "cache_invalidations_total",
            "cache entries evicted by an epoch bump (deltas touched a cell)",
        )
        self._m_revalidated = self.metrics.counter(
            "serve_cache_revalidations_total",
            "cache entries proven still exact across an epoch bump",
        )
        self._m_warm = self.metrics.counter(
            "serve_warm_resolves_total",
            "queries re-solved warm from a retained prior-epoch state",
        )
        self._g_epoch = self.metrics.gauge(
            "delta_epoch", "delta-log epoch this server is serving"
        )
        self._g_epoch.set(float(self.epoch or 0))
        self._g_pad_waste = self.metrics.gauge(
            "serve_pad_waste",
            "fraction of executed lanes that were padding",
        )
        self._g_queue_depth = self.metrics.gauge(
            "serve_queue_depth", "queries currently queued across buckets"
        )
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def submit(self, seeds: Sequence[int]) -> int:
        """Enqueues one seed-set query; returns its ticket id.

        Raises ValueError on seeds outside [0, n): a scatter would fail or
        write out of bounds, and a garbage result would poison the cache.
        """
        arr = np.asarray(seeds, np.int64)
        if arr.size and (arr.min() < 0 or arr.max() >= self.g.n):
            raise ValueError(
                f"seed ids must be in [0, {self.g.n}), got "
                f"[{arr.min()}, {arr.max()}]"
            )
        p = planmod.plan_query(seeds, self.config.buckets)
        t = self._next_ticket
        self._next_ticket += 1
        now = time.perf_counter()
        if self._t_first is None:
            self._t_first = now
        self._queues[p.bucket].append(_Pending(ticket=t, plan=p, t_submit=now))
        self._g_queue_depth.set(float(self.pending()))
        return t

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    # ------------------------------------------------------------------
    # mutation (store-backed servers)
    # ------------------------------------------------------------------

    def apply_deltas(self, records: Sequence, *, map_ids: bool = True) -> dict:
        """Appends edge deltas to the backing store and bumps the epoch.

        One call = one log segment (:func:`repro_torch.delta.append_deltas`)
        + one :meth:`bump_epoch` with that segment's exact changed-vertex
        set: the solver handle refreshes, surviving cache entries keep
        serving, the rest are evicted and later re-solved warm.

        Returns the :meth:`bump_epoch` report plus ``"records"``.
        """
        if self._store is None:
            raise ValueError(
                "apply_deltas needs a store-backed server "
                "(graph_path= or a GraphStore as g)"
            )
        info = append_deltas(self._store, records, map_ids=map_ids)
        seg = read_segment(self._store.path / info["file"], info["epoch"])
        # endpoints are already in stored-id space (append mapped them), the
        # id space of the retained Voronoi labels
        changed = np.unique(np.concatenate([seg.u, seg.v]).astype(np.int64))
        report = self.bump_epoch(changed)
        report["records"] = info["count"]
        return report

    def bump_epoch(self, changed: Optional[Sequence[int]] = None) -> dict:
        """Adopts the store's current epoch; re-validates the cache.

        ``changed`` is the union of delta-record endpoints (stored ids)
        appended since this server's epoch.  Every cached entry whose
        retained converged labels show ALL changed vertices unreached (the
        S sentinel) is still exact and keeps serving with its state stamp
        advanced.  Every other entry (entries whose state was LRU-dropped
        included) is evicted and counted in ``cache_invalidations_total``.
        ``changed=None`` means "unknown": the whole cache is flushed and
        warm starts across this bump are disabled.

        Call this directly only after mutating the store externally;
        :meth:`apply_deltas` does the whole round in-process.
        """
        if self._store is None:
            raise ValueError(
                "bump_epoch needs a store-backed server "
                "(graph_path= or a GraphStore as g)"
            )
        prev = self.epoch
        refreshed = self._handle.refresh()
        self.epoch = refreshed["epoch"]
        # the resident graph and the warm handle bound to it are
        # epoch-dependent: rebind both to the refreshed artifacts
        self.g = self._handle.graph
        self._warm_handle = None
        if changed is not None:
            changed = np.unique(np.asarray(changed, np.int64))
        self._changed_log.append((prev, self.epoch, changed))
        invalidated = revalidated = 0
        for key, rec in list(self._states.items()):
            epoch0, bucket, dist, lab, pred = rec
            if changed is not None and epoch0 == prev and entry_survives(lab, changed, bucket):
                # still the exact fixpoint at the new epoch
                self._states[key] = (self.epoch, bucket, dist, lab, pred)
                if key in self.cache:
                    revalidated += 1
        for key in self.cache.keys():
            rec = self._states.get(key)
            if rec is None or rec[0] != self.epoch:
                self.cache.pop(key)
                invalidated += 1
        self._m_invalidated.inc(invalidated)
        self._m_revalidated.inc(revalidated)
        self._g_epoch.set(float(self.epoch or 0))
        return {
            "epoch": self.epoch,
            "from_epoch": prev,
            "invalidated": invalidated,
            "revalidated": revalidated,
            "refreshed": refreshed["refreshed"],
        }

    def _changed_since(self, epoch0: int) -> Optional[np.ndarray]:
        """Union of changed vertices over epochs (epoch0, self.epoch]; None
        when the log does not cover that range (a warm start is unsound)."""
        if epoch0 == self.epoch:
            return np.empty(0, np.int64)
        parts = []
        lo = None
        for fr, to, ch in self._changed_log:
            if to <= epoch0:
                continue
            if ch is None:
                return None
            parts.append(ch)
            lo = fr if lo is None else min(lo, fr)
        if lo is None or lo > epoch0:
            return None  # gap: the state predates the retained log
        return np.unique(np.concatenate(parts))

    def _store_state(self, key, bucket: int, dist, lab, pred) -> None:
        """Retains one converged Voronoi state (host copies, current epoch)."""
        if self._store is None or self.config.state_capacity <= 0:
            return
        self._states[key] = (
            self.epoch,
            int(bucket),
            dist.cpu().numpy(),
            lab.cpu().numpy(),
            pred.cpu().numpy(),
        )
        self._states.move_to_end(key)
        while len(self._states) > self.config.state_capacity:
            self._states.popitem(last=False)

    def _warm_prepared(self):
        """Lazy single-backend handle over the resident graph for warm
        affected-cell re-solves (rebuilt after every epoch bump): mode
        "dense" or "bucket" as served, "dense" for "pallas", which takes no
        warm start."""
        if self._warm_handle is None:
            mode = self.config.mode if self.config.mode in ("dense", "bucket") else "dense"
            self._warm_handle = SteinerSolver(
                SolverConfig(
                    backend="single",
                    mode=mode,
                    mst_algo=self.config.mst_algo,
                    delta=self.config.delta,
                    max_iters=self.config.max_iters,
                ),
                device=self._handle.device,
            ).prepare(self.g)
        return self._warm_handle

    def _warm_resolve(self, plan: planmod.QueryPlan) -> Optional[QueryResult]:
        """Re-solves one invalidated query warm from its retained state.

        Resets only the delta-affected Voronoi cells
        (:func:`repro_torch.delta.resolve.reset_affected`) and relaxes from
        there: bit-exact against a cold solve, but the kept cells start
        converged.  Returns None (the caller falls through to a cold batch
        lane) when no usable state is retained.
        """
        if self._store is None or self.config.state_capacity <= 0:
            return None
        if self.config.materialize_edges:
            return None  # edge materialization runs on the batch path
        rec = self._states.get(plan.key)
        if rec is None:
            return None
        epoch0, bucket, dist, lab, pred = rec
        if bucket != plan.bucket:
            return None
        changed = self._changed_since(epoch0)
        if changed is None:
            return None
        self._states.move_to_end(plan.key)
        seeds = plan.padded.astype(np.int64)
        if self._vertex_perm is not None:
            seeds = self._vertex_perm[seeds]
        dev = self._handle.device
        st = VoronoiState(*(torch.from_numpy(x).to(dev) for x in (dist, lab, pred)))
        warm, _, _ = reset_affected(st, seeds, changed, bucket)
        out = self._warm_prepared().solve(seeds.astype(np.int32), warm_state=warm)
        result = QueryResult(
            key=plan.key,
            bucket=plan.bucket,
            total_distance=float(out.total_distance),
            num_edges=int(out.num_edges),
            edges=None,
            from_cache=False,
            latency_s=0.0,
        )
        self.cache.put(plan.key, result)
        s = out.raw.state
        self._store_state(plan.key, bucket, s.dist, s.lab, s.pred)
        self._m_warm.inc()
        return result

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------

    def warmup(self) -> None:
        """Runs one full batch per bucket before traffic arrives (builds
        the kernels and warms the allocator)."""
        # the first real edge; a (1,) index keeps the lookup on the device
        lo = torch.argmax(torch.isfinite(self.g.w).to(torch.int8)).view(1)
        u, v = (int(x[0]) for x in to_host(self.g.src[lo], self.g.dst[lo]))
        for b in self.config.buckets:
            batch = np.tile(
                planmod.pad_seed_set((min(u, v), max(u, v)), b),
                (self._handle.config.batch_size, 1),
            )
            self._execute(b, batch)

    def _execute(self, bucket: int, seed_batch: np.ndarray, n_real: Optional[int] = None):
        """One fixed-shape (max_batch, bucket) batch.

        ``n_real`` bounds host-side edge materialization to the lanes that
        carry distinct queries (the rest are inert batch padding).  Totals
        and edge counts come back in the backend's one fetch a batch.
        """
        out = self._handle.solve(seed_batch)
        res = out.raw
        edges = None
        if self.config.materialize_edges:
            edges = tree_edge_sets(
                res.state, res.tree, seed_batch.shape[0] if n_real is None else n_real
            )
        return out.total_distance, out.num_edges, edges, res

    def flush(self) -> Dict[int, QueryResult]:
        """Drains every bucket queue; returns {ticket: QueryResult}.

        Exception-safe: if a solver failure interrupts a batch, that batch's
        tickets go back on their queue, results of batches that already
        completed in this call are held for the next ``flush``, and the
        exception propagates: no ticket is ever dropped.
        """
        # deliver results stranded by a previously failed flush first
        out: Dict[int, QueryResult] = self._ready
        self._ready = {}
        # the solver config owns the lane count (ServeConfig.max_batch is
        # copied into it at construction)
        B = self._handle.config.batch_size
        for bucket, queue in self._queues.items():
            while queue:
                # Assemble up to B *distinct uncached* keys; duplicate and
                # already-cached tickets ride along without a lane.
                lanes: List[np.ndarray] = []
                lane_of: Dict[Tuple[int, ...], int] = {}
                # (pending, result or None, from_cache): None awaits the
                # batch; a result with from_cache=False came from a warm
                # re-solve during assembly
                riders: List[Tuple[_Pending, Optional[QueryResult], bool]] = []
                while queue and len(lanes) < B:
                    p = queue.popleft()
                    hit = self.cache.get(p.plan.key)
                    from_cache = hit is not None
                    if hit is None:
                        # invalidated by an epoch bump but state retained:
                        # re-solve warm (affected cells only) instead of
                        # taking a cold batch lane
                        hit = self._warm_resolve(p.plan)
                    if hit is None and p.plan.key not in lane_of:
                        lane_of[p.plan.key] = len(lanes)
                        lanes.append(p.plan.padded)
                    riders.append((p, hit, from_cache))
                t_assembled = time.perf_counter()
                t_done = t_assembled
                fresh_by_key: Dict[Tuple[int, ...], QueryResult] = {}
                if lanes:
                    n_real = len(lanes)
                    while len(lanes) < B:  # inert batch-dim padding
                        lanes.append(lanes[0])
                    try:
                        totals, nedges, edges, res = self._execute(
                            bucket, np.stack(lanes), n_real
                        )
                    except Exception:
                        # the riders were already popped: put them back (in
                        # order) and stash the results of the batches this
                        # call already completed, then surface the failure
                        for p, _, _ in reversed(riders):
                            queue.appendleft(p)
                        self._ready = out
                        self._g_queue_depth.set(float(self.pending()))
                        raise
                    t_done = time.perf_counter()
                    self._m_batches[bucket].inc()
                    self._m_lanes.inc(B)
                    self._m_padded.inc(B - n_real)
                    self._g_pad_waste.set(self._m_padded.value / self._m_lanes.value)
                    # the real lanes' converged states: the raw material for
                    # warm re-solves after future epoch bumps
                    capture = self._store is not None and self.config.state_capacity > 0
                    for key, i in lane_of.items():
                        fresh = QueryResult(
                            key=key,
                            bucket=bucket,
                            total_distance=float(totals[i]),
                            num_edges=int(nedges[i]),
                            edges=edges[i] if edges is not None else None,
                            from_cache=False,
                            latency_s=0.0,
                        )
                        fresh_by_key[key] = fresh
                        self.cache.put(key, fresh)
                        if capture:
                            s = res.state
                            self._store_state(key, bucket, s.dist[i], s.lab[i], s.pred[i])
                for p, hit, from_cache in riders:
                    if hit is None:
                        hit = fresh_by_key[p.plan.key]
                        ready_at = t_done  # waited for the batch
                    else:
                        # cache hits and warm re-solves were ready once
                        # assembly finished
                        ready_at = t_assembled
                    if from_cache:
                        self._m_hits.inc()
                    self._m_completed.inc()
                    lat = ready_at - p.t_submit
                    self._m_lat["cached" if from_cache else "fresh"].observe(lat)
                    out[p.ticket] = hit.with_latency(lat, from_cache)
                self._t_last = t_done
        self._g_queue_depth.set(float(self.pending()))
        return out

    # ------------------------------------------------------------------
    # convenience front-ends
    # ------------------------------------------------------------------

    def query(self, seeds: Sequence[int]) -> QueryResult:
        """Synchronous single query (micro-batch of one).

        The internal flush may also drain tickets submitted by other callers
        (or stranded by an earlier failed flush); those results are held for
        their own ``flush`` consumers, not discarded.
        """
        t = self.submit(seeds)
        results = self.flush()
        mine = results.pop(t)
        self._ready.update(results)
        return mine

    def query_many(self, seed_sets: Sequence[Sequence[int]]) -> List[QueryResult]:
        """Submits a burst, flushes once, returns results in input order.

        As with :meth:`query`, results for tickets that are not part of this
        burst are held for their own ``flush`` consumers.
        """
        tickets = [self.submit(s) for s in seed_sets]
        results = self.flush()
        out = [results.pop(t) for t in tickets]
        self._ready.update(results)
        return out

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------

    def stats(self) -> dict:
        """Service counters: a dict view over the per-server registry
        (``self.metrics``; :meth:`prometheus_text` exposes the same series).

        Latency percentiles are ``None`` until the matching population has
        served a query.  ``latency_*`` covers all completed queries;
        ``fresh_*`` / ``cached_*`` split the solve path from the cache path.
        """

        def pcts(vals):
            if not vals:
                return None, None
            lat = np.asarray(vals)
            return (
                float(np.percentile(lat, 50) * 1e3),
                float(np.percentile(lat, 99) * 1e3),
            )

        fresh = self._m_lat["fresh"].values()
        cached = self._m_lat["cached"].values()
        p50, p99 = pcts(fresh + cached)
        fresh_p50, fresh_p99 = pcts(fresh)
        cached_p50, cached_p99 = pcts(cached)
        completed = int(self._m_completed.value)
        cache_hits = int(self._m_hits.value)
        lanes_run = int(self._m_lanes.value)
        lanes_padded = int(self._m_padded.value)
        span = (
            (self._t_last - self._t_first)
            if (self._t_first is not None and self._t_last is not None)
            else 0.0
        )
        return {
            "completed": completed,
            "cache_hits": cache_hits,
            "cache_hit_rate": (cache_hits / completed if completed else 0.0),
            "cache_entries": len(self.cache),
            "qps": completed / span if span > 0 else 0.0,
            "latency_p50_ms": p50,
            "latency_p99_ms": p99,
            "fresh_p50_ms": fresh_p50,
            "fresh_p99_ms": fresh_p99,
            "cached_p50_ms": cached_p50,
            "cached_p99_ms": cached_p99,
            "lanes_run": lanes_run,
            "lanes_padded": lanes_padded,
            "pad_waste": (lanes_padded / lanes_run if lanes_run else 0.0),
            "batches_per_bucket": {b: int(c.value) for b, c in self._m_batches.items()},
            # delta-epoch serving state (in-memory servers: epoch None,
            # counters 0)
            "epoch": self.epoch,
            "cache_invalidations": int(self._m_invalidated.value),
            "cache_revalidations": int(self._m_revalidated.value),
            "warm_resolves": int(self._m_warm.value),
            "retained_states": len(self._states),
        }

    def prometheus_text(self) -> str:
        """This server's counters in Prometheus text exposition format."""
        return self.metrics.prometheus_text()
