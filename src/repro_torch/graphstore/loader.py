"""Opening ``.gstore`` directories: lazy views over memmapped CSR.

Counterpart of ``repro.graphstore.loader``.  ``open_store(path)`` returns a
:class:`GraphStore`, a handle whose arrays stay on disk until touched.
From it you get

* ``to_graph(device=)``  the padded COO :class:`~repro_torch.core.graph.Graph`
                         the solver consumes (materializes O(M) once);
* ``ell(k, device=)``    the split-row ELL view filled straight from the
                         CSR on the device, bit-equal to
                         ``to_ell(to_graph(), k)``;
* ``iter_coo(...)``      bounded-memory chunks of the directed edge list.

Checksums are verified at open by default (``verify=False`` skips it, e.g.
when reopening a store this process just wrote).  ``load_partition*``
rebuild the mesh backends' per-rank partitions from the shard files that
:mod:`repro_torch.graphstore.partition` writes.
"""

from __future__ import annotations

from pathlib import Path
from typing import TYPE_CHECKING, Iterator, Optional, Tuple, Union

import numpy as np

from repro_torch.graphstore import format as fmt

if TYPE_CHECKING:  # torch is imported where a view is built on a device, so
    import torch   # the host tools (the CLI, compaction) never load it

DEFAULT_COO_CHUNK_EDGES = 1 << 20


def _host_tensor(a, dtype) -> "torch.Tensor":
    """A host array (a read-only memmap included) as a CPU tensor of
    ``dtype``; copies only where numpy must."""
    import torch

    return torch.from_numpy(np.require(a, dtype, "W"))


class GraphStore:
    """Read-only handle on one on-disk graph.  See :func:`open_store`.

    A store with a non-empty delta log (:mod:`repro_torch.delta`) is opened
    as the base CSR plus a folded COO *overlay*: ``iter_coo`` / ``coo`` /
    ``to_graph`` / ``ell`` yield the EFFECTIVE edge list (deletions
    filtered, reweights applied, additions appended), while
    ``indptr``/``indices``/``weights`` stay the raw base arrays.  ``epoch``
    counts applied delta segments; ``compact()`` (in
    :mod:`repro_torch.delta.compact`) folds the log back into a fresh CSR.
    """

    def __init__(self, path: Union[str, Path], *, verify: bool = True):
        self.path = Path(path)
        self._load_manifest(verify=verify)

    def _load_manifest(self, *, verify: bool) -> None:
        from repro_torch.delta.overlay import fold_overlay

        self.manifest = fmt.read_manifest(self.path)
        if verify:
            fmt.verify_store(self.path, self.manifest)
        self.n: int = int(self.manifest["n"])
        self.m: int = int(self.manifest["m"])
        self.epoch: int = int(self.manifest.get("epoch", 0))
        self.overlay = fold_overlay(self.path, self.manifest)
        self._maps: dict = {}
        self._eff_cache: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None

    def reload(self, *, verify: bool = False) -> "GraphStore":
        """Re-reads the manifest and delta log (after an append or a compact
        by this or another process); drops cached memmaps and the effective
        CSR."""
        self._load_manifest(verify=verify)
        return self

    # ------------------------------------------------------------------
    # lazy array views
    # ------------------------------------------------------------------

    def array(self, name: str) -> np.memmap:
        """Memmaps one manifest array (cached per handle)."""
        mm = self._maps.get(name)
        if mm is None:
            mm = fmt.map_array(self.path, self.manifest, name)
            self._maps[name] = mm
        return mm

    @property
    def indptr(self) -> np.memmap:
        return self.array("indptr")

    @property
    def indices(self) -> np.memmap:
        return self.array("indices")

    @property
    def weights(self) -> np.memmap:
        return self.array("weights")

    @property
    def vertex_perm(self) -> Optional[np.ndarray]:
        """old id -> stored id map of a hub-sorted store (None otherwise)."""
        if "vertex_perm" not in self.manifest["arrays"]:
            return None
        return self.array("vertex_perm")

    def map_ids(self, ids) -> np.ndarray:
        """Translates original vertex ids (e.g. query seeds) to stored ids."""
        ids = np.asarray(ids)
        perm = self.vertex_perm
        return ids if perm is None else np.asarray(perm)[ids].astype(ids.dtype)

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def partition_meta(self) -> Optional[dict]:
        return self.manifest.get("partition")

    @property
    def partition_fresh(self) -> bool:
        """True when persisted shards reflect the store's current epoch.

        Shards written before deltas were appended describe the stale base
        graph; loading them would silently drop the mutations, so the
        shard-load paths gate on this.  Re-partitioning (which stamps the
        current epoch) or compacting restores freshness.
        """
        meta = self.partition_meta
        if not meta:
            return False
        return self.overlay is None or int(meta.get("epoch", 0)) == self.epoch

    def verify(self) -> None:
        """Re-checks every array and delta segment checksum."""
        fmt.verify_store(self.path, self.manifest)

    # ------------------------------------------------------------------
    # materialization
    # ------------------------------------------------------------------

    def iter_base_coo(
        self, chunk_edges: int = DEFAULT_COO_CHUNK_EDGES
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Directed (src, dst, w) chunks of the BASE CSR (no overlay),
        bounded memory, cut on vertex boundaries."""
        indptr = np.asarray(self.indptr)
        v = 0
        while v < self.n:
            # largest vertex boundary still within chunk_edges of indptr[v]
            hi = int(np.searchsorted(indptr, indptr[v] + chunk_edges, side="right")) - 1
            v_hi = max(v + 1, min(self.n, hi))
            e0, e1 = int(indptr[v]), int(indptr[v_hi])
            counts = np.diff(indptr[v : v_hi + 1]).astype(np.int64)
            src = np.repeat(np.arange(v, v_hi, dtype=np.int32), counts)
            yield src, np.asarray(self.indices[e0:e1]), np.asarray(self.weights[e0:e1])
            v = v_hi

    def iter_coo(
        self, chunk_edges: int = DEFAULT_COO_CHUNK_EDGES
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """EFFECTIVE directed (src, dst, w) chunks, bounded memory.

        Base-CSR chunks come first (deletions filtered, reweights applied;
        chunks may shrink, even to empty), then the surviving delta
        additions, symmetrized one chunk per append batch: the canonical
        effective edge stream, whose per-row arrival order the effective
        CSR keeps.
        """
        ov = self.overlay
        for s, d, w in self.iter_base_coo(chunk_edges):
            if ov is not None:
                s, d, w = ov.apply_base_chunk(s, d, w)
            yield s, d, w
        if ov is not None:
            yield from ov.iter_add_chunks()

    def coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Materializes the full EFFECTIVE directed edge list (O(M) host)."""
        indptr = np.asarray(self.indptr)
        counts = np.diff(indptr).astype(np.int64)
        src = np.repeat(np.arange(self.n, dtype=np.int32), counts)
        if self.overlay is None:
            return src, np.asarray(self.indices), np.asarray(self.weights)
        parts = [
            self.overlay.apply_base_chunk(
                src, np.asarray(self.indices), np.asarray(self.weights)
            )
        ]
        parts.extend(self.overlay.iter_add_chunks())
        return tuple(np.concatenate([p[i] for p in parts]) for i in range(3))

    def to_graph(self, *, pad_to: int = 1, device="cuda"):
        """Materializes the padded COO :class:`~repro_torch.core.graph.Graph`
        on ``device``.

        The store already holds both directions of every edge, so nothing
        is symmetrized.  With a delta overlay the COO is expanded from the
        (cached) effective CSR, so one ``prepare``/``refresh`` folds the
        overlay once however many views it builds.
        """
        from repro_torch.core.graph import from_edges

        if self.overlay is None:
            src, dst, w = self.coo()
        else:
            indptr, dst, w = self.effective_csr()
            src = np.repeat(
                np.arange(self.n, dtype=np.int32), np.diff(indptr).astype(np.int64)
            )
        dst = np.require(dst, np.int32, "W")
        w = np.require(w, np.float32, "W")
        return from_edges(
            src, dst, w, self.n, symmetrize=False, pad_to=pad_to, device=device
        )

    def effective_csr(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(indptr, indices, weights) of the EFFECTIVE graph, in host memory.

        With no overlay: host copies of the base memmaps.  With one, the
        effective edge stream (:meth:`iter_coo`) folded through the same
        two-pass builder ingest uses, cached until :meth:`reload`.
        """
        if self.overlay is None:
            return (
                np.asarray(self.indptr),
                np.asarray(self.indices),
                np.asarray(self.weights),
            )
        if self._eff_cache is None:
            from repro_torch.graphstore.ingest import csr_from_chunks

            self._eff_cache = csr_from_chunks(
                self.n, _EffectiveSource(self), symmetrize=False
            )
        return self._eff_cache

    def ell(self, k: int, *, pad_rows_to: int = 1, device="cuda"):
        """Split-row ELLPACK view of width ``k`` on ``device``, filled from
        the CSR (the effective one with a delta overlay).

        The same view as ``to_ell(to_graph(), k, pad_rows_to=...)``, bit
        for bit, without the COO's sort: within a row, neighbors keep CSR
        order.  ``pad_rows_to`` rounds the row count up to a multiple with
        spare all-``+inf`` rows (``row2v`` 0), which the delta layer's row
        surgery claims for degree growth.
        """
        if self.overlay is None:
            indptr, indices, weights = self.indptr, self.indices, self.weights
        else:
            indptr, indices, weights = self.effective_csr()
        return _ell_from_csr(
            indptr, indices, weights, self.n, k, pad_rows_to=pad_rows_to, device=device
        )

    # ------------------------------------------------------------------
    # shards
    # ------------------------------------------------------------------

    def _check_shards_fresh(self) -> None:
        # no partition at all is the loaders' own (clearer) error
        if self.partition_meta and not self.partition_fresh:
            raise fmt.StoreFormatError(
                f"{self.path}: persisted shards predate the delta log "
                f"(shard epoch {int((self.partition_meta or {}).get('epoch', 0))}"
                f" != store epoch {self.epoch}); re-partition or compact "
                f"before loading shards"
            )

    def load_partition(self):
        """Rebuilds the stored 1D partition (see ``partition.py``)."""
        from repro_torch.graphstore.partition import load_partition

        self._check_shards_fresh()
        return load_partition(self)

    def load_partition_2d(self):
        """Rebuilds the stored 2D partition (see ``partition.py``)."""
        from repro_torch.graphstore.partition import load_partition_2d

        self._check_shards_fresh()
        return load_partition_2d(self)

    def load_partition_ell(self):
        """Rebuilds the stored 1D ELL partition, the sharded priority-queue
        layout of the mesh frontier mode (see ``partition.py``)."""
        from repro_torch.graphstore.partition import load_partition_ell

        self._check_shards_fresh()
        return load_partition_ell(self)

    def __repr__(self) -> str:
        part = self.partition_meta
        return (
            f"GraphStore({str(self.path)!r}, n={self.n}, m={self.m}, "
            f"partition={part['scheme'] if part else None})"
        )


class _EffectiveSource:
    """Re-iterable edge-source adapter over a store's effective stream
    (what :func:`~repro_torch.graphstore.ingest.csr_two_pass` consumes)."""

    def __init__(self, store: GraphStore):
        self._store = store
        self.n = store.n
        self.describe = f"effective({store.path.name}@{store.epoch})"

    def __iter__(self):
        return self._store.iter_coo()


def _ell_from_csr(
    indptr, indices, weights, n: int, k: int, *, pad_rows_to: int = 1, device="cuda"
):
    """CSR -> split-row ELLPACK fill on ``device`` (see :meth:`GraphStore.ell`).

    The rows of one vertex are contiguous, so the j-th edge of vertex v
    lands at flat slot ``row_off[v] * k + j``; CSR order is already by
    source, so no sort is needed.
    """
    import torch

    from repro_torch.core.graph import EllGraph

    dev = torch.device(device)
    indptr = _host_tensor(indptr, np.int64).to(dev)
    counts = indptr[1:] - indptr[:-1]
    rows_per_v = torch.clamp((counts + k - 1) // k, min=1)
    row_off = torch.cumsum(rows_per_v, 0) - rows_per_v
    n_rows = int(rows_per_v.sum())
    padded_rows = -(-n_rows // pad_rows_to) * pad_rows_to
    m = int(indptr[-1])
    src = torch.repeat_interleave(
        torch.arange(n, device=dev), counts, output_size=m
    )
    flat = row_off[src] * k
    flat += torch.arange(m, device=dev)
    flat -= indptr[:-1][src]
    del src
    nbr = torch.zeros(padded_rows * k, dtype=torch.int32, device=dev)
    wgt = torch.full((padded_rows * k,), float("inf"), dtype=torch.float32, device=dev)
    nbr[flat] = _host_tensor(indices, np.int32).to(dev)
    wgt[flat] = _host_tensor(weights, np.float32).to(dev)
    del flat
    row2v = torch.zeros(padded_rows, dtype=torch.int32, device=dev)
    row2v[:n_rows] = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=dev), rows_per_v, output_size=n_rows
    )
    return EllGraph(
        nbr=nbr.view(padded_rows, k), wgt=wgt.view(padded_rows, k), row2v=row2v, n=n
    )


def open_store(path: Union[str, Path], *, verify: bool = True) -> GraphStore:
    """Opens a ``.gstore`` directory.

    Args:
      path: the store directory.
      verify: check every array's CRC32 against the manifest (streaming,
        bounded memory).  Corruption raises
        :class:`~repro_torch.graphstore.format.ChecksumError`; an unknown
        layout version raises
        :class:`~repro_torch.graphstore.format.StoreFormatError`.
    """
    return GraphStore(path, verify=verify)
