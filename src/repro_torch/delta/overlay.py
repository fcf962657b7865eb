"""Folding a delta log into a COO overlay over the base CSR.

A numpy-only copy of ``repro.delta.overlay``.

:func:`fold_overlay` replays the manifest-listed segments (epoch order,
record order) into a :class:`DeltaOverlay` — the compact normal form of
the whole log:

* ``removed``   — sorted canonical pair keys whose BASE edges are dead
  (a later re-add lives in the additions list, not the base);
* ``rw_keys`` / ``rw_w`` — pair keys of surviving base edges whose
  weight was overridden (last reweight wins);
* ``add_u/v/w`` — surviving added edges, one direction, log order, with
  ``add_epoch`` recording each addition's segment so application can
  chunk additions exactly on append-batch boundaries (the ingest CSR is
  arrival-order-sensitive per row; keeping the batch grouping is what
  makes ``compact()`` bit-identical to a fresh ingest of the final edge
  stream — the reference's tests/test_properties.py);
* ``changed``   — sorted unique endpoints touched by ANY record (used
  for affected-cell invalidation and incremental shard rewrite; no-op
  records still count — conservatively stale beats silently wrong).

A canonical pair key packs an undirected pair into one int64
(``min << 32 | max``), so both stored directions of an edge match one
delete/reweight record regardless of record orientation.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

from repro_torch.delta.log import OP_ADD, OP_DELETE, OP_REWEIGHT, read_segments


def pair_key(u, v) -> np.ndarray:
    """Canonical undirected int64 key(s): ``min(u,v) << 32 | max(u,v)``."""
    u = np.asarray(u, np.int64)
    v = np.asarray(v, np.int64)
    return (np.minimum(u, v) << 32) | np.maximum(u, v)


def _isin_sorted(keys: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Membership of ``keys`` in a SORTED unique key table."""
    if table.size == 0:
        return np.zeros(keys.shape, bool)
    pos = np.searchsorted(table, keys)
    pos = np.minimum(pos, table.size - 1)
    return table[pos] == keys


@dataclasses.dataclass(frozen=True)
class DeltaOverlay:
    """Folded delta log (see module docstring).  Immutable."""

    epoch: int
    removed: np.ndarray  # sorted unique i64 pair keys (dead base edges)
    rw_keys: np.ndarray  # sorted unique i64 pair keys (reweighted base)
    rw_w: np.ndarray  # (len(rw_keys),) f32
    add_u: np.ndarray  # (A,) i32 surviving additions, log order
    add_v: np.ndarray  # (A,) i32
    add_w: np.ndarray  # (A,) f32 (final weights)
    add_epoch: np.ndarray  # (A,) i64 segment epoch per addition
    changed: np.ndarray  # sorted unique i32 endpoints of all records
    counts: dict  # {"add": .., "delete": .., "reweight": ..} record totals

    @property
    def num_additions(self) -> int:
        return int(self.add_u.shape[0])

    def apply_base_chunk(
        self, s: np.ndarray, d: np.ndarray, w: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Filters deletions out of / applies reweights to one directed
        base-CSR chunk.  May return shorter (even empty) arrays.

        Every removed or reweighted key pairs two record endpoints, so only
        edges whose source is in ``changed`` can match one: the keys are
        built for those edges alone (a few of a chunk's), not for all.  The
        two key tables are disjoint (a delete drops the pair's reweight), so
        reweighting before filtering gives the reference's result.
        """
        if self.removed.size == 0 and self.rw_keys.size == 0:
            return s, d, w
        idx = np.flatnonzero(np.isin(s, self.changed))
        if idx.size == 0:
            return s, d, w
        k = pair_key(s[idx], d[idx])
        if self.rw_keys.size:
            pos = np.minimum(np.searchsorted(self.rw_keys, k), self.rw_keys.size - 1)
            hit = self.rw_keys[pos] == k
            if hit.any():
                w = w.copy()
                w[idx[hit]] = self.rw_w[pos[hit]]
        if self.removed.size:
            dead = _isin_sorted(k, self.removed)
            if dead.any():
                keep = np.ones(s.shape[0], bool)
                keep[idx[dead]] = False
                s, d, w = s[keep], d[keep], w[keep]
        return s, d, w

    def iter_add_chunks(
        self,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Surviving additions as symmetrized directed chunks, one chunk
        per source segment (append batch) — the canonical order the
        compactor, the overlay views, and the fresh-ingest reference all
        share."""
        if self.add_u.size == 0:
            return
        for ep in np.unique(self.add_epoch):
            sel = self.add_epoch == ep
            u, v, w = self.add_u[sel], self.add_v[sel], self.add_w[sel]
            yield (
                np.concatenate([u, v]),
                np.concatenate([v, u]),
                np.concatenate([w, w]),
            )


def fold_segments(segments, epoch: int) -> DeltaOverlay:
    """Folds decoded segments (epoch order) into a :class:`DeltaOverlay`."""
    removed: dict = {}
    rw: dict = {}
    add_u: list = []
    add_v: list = []
    add_w: list = []
    add_ep: list = []
    alive: list = []
    live_by_key: dict = {}
    changed: set = set()
    counts = {"add": 0, "delete": 0, "reweight": 0}
    for seg in segments:
        ops = np.asarray(seg.ops)
        su = np.asarray(seg.u)
        sv = np.asarray(seg.v)
        sw = np.asarray(seg.w)
        keys = pair_key(su, sv)
        for i in range(ops.shape[0]):
            op, u, v, w = int(ops[i]), int(su[i]), int(sv[i]), float(sw[i])
            k = int(keys[i])
            changed.add(u)
            changed.add(v)
            if op == OP_ADD:
                counts["add"] += 1
                live_by_key.setdefault(k, []).append(len(add_u))
                add_u.append(u)
                add_v.append(v)
                add_w.append(w)
                add_ep.append(seg.epoch)
                alive.append(True)
            elif op == OP_DELETE:
                counts["delete"] += 1
                for j in live_by_key.pop(k, ()):
                    alive[j] = False
                removed[k] = True
                rw.pop(k, None)
            elif op == OP_REWEIGHT:
                counts["reweight"] += 1
                for j in live_by_key.get(k, ()):
                    add_w[j] = w
                if k not in removed:
                    # applied lazily: keys matching no base edge are inert
                    rw[k] = w
            else:  # pragma: no cover - rejected at decode
                raise ValueError(f"bad op code {op}")
    live = np.asarray(alive, bool) if alive else np.zeros(0, bool)
    rwk = np.array(sorted(rw), np.int64)
    return DeltaOverlay(
        epoch=int(epoch),
        removed=np.array(sorted(removed), np.int64),
        rw_keys=rwk,
        rw_w=np.asarray([rw[k] for k in rwk], np.float32),
        add_u=np.asarray(add_u, np.int32)[live],
        add_v=np.asarray(add_v, np.int32)[live],
        add_w=np.asarray(add_w, np.float32)[live],
        add_epoch=np.asarray(add_ep, np.int64)[live],
        changed=np.asarray(sorted(changed), np.int32),
        counts=counts,
    )


def fold_overlay(path, manifest: dict):
    """Replays a store's delta log; None when the log is empty."""
    if not manifest.get("deltas"):
        return None
    return fold_segments(read_segments(path, manifest), int(manifest.get("epoch", 0)))
