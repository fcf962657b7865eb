"""Synthetic user-behaviour stream for the MIND architecture.

A numpy copy of ``repro.data.recsys``: users are mixtures of latent
interest clusters; a history is drawn from a user's clusters and the target
item continues one of them, so the multi-interest capsules have real
structure to learn.  Deterministic and seekable like the token stream:
``batch_at(step)`` here and in the reference are the same arrays, bit for
bit.  Item ids stay in ``[0, n_items)`` (``% n_items``).
"""

from __future__ import annotations

import numpy as np


class BehaviorStream:
    def __init__(
        self,
        n_items: int,
        hist_len: int,
        batch: int,
        *,
        n_clusters: int = 64,
        seed: int = 0,
    ):
        self.n_items = n_items
        self.hist_len = hist_len
        self.batch = batch
        self.n_clusters = n_clusters
        self.seed = seed
        rng = np.random.default_rng(seed)
        # each cluster owns a contiguous-ish slice of the catalog
        self._centers = rng.integers(0, n_items, size=n_clusters)
        self._width = max(8, n_items // (4 * n_clusters))

    def _draw(self, rng, clusters, size):
        c = rng.choice(clusters, size=size)
        offs = rng.integers(-self._width, self._width + 1, size=size)
        return (self._centers[c] + offs) % self.n_items

    def batch_at(self, step: int):
        """The batch of ``step``: ``hist_ids`` (B, L) int32, ``hist_mask``
        (B, L) f32 (a valid prefix of L/2 to L items) and ``target_id`` (B,)
        int32."""
        rng = np.random.default_rng((self.seed, step))
        B, Lh = self.batch, self.hist_len
        hist = np.zeros((B, Lh), np.int64)
        mask = np.ones((B, Lh), np.float32)
        target = np.zeros((B,), np.int64)
        for b in range(B):
            k = rng.integers(1, 4)  # 1-3 interests per user
            clusters = rng.choice(self.n_clusters, size=k, replace=False)
            hist[b] = self._draw(rng, clusters, Lh)
            n_valid = rng.integers(Lh // 2, Lh + 1)
            mask[b, n_valid:] = 0.0
            target[b] = self._draw(rng, clusters, 1)[0]
        return {
            "hist_ids": hist.astype(np.int32),
            "hist_mask": mask,
            "target_id": target.astype(np.int32),
        }
