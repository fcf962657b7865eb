"""Synthetic LM token pipeline (a numpy copy of ``repro.data.tokens``).

Deterministic, seekable stream: batch ``i`` is a pure function of
``(seed, i)``, so a restarted job resumes mid-epoch with no data loss or
duplication (the checkpoint stores only the step counter). The generator
mimics Zipfian token statistics with short-range structure so the loss
curve is non-trivial (markov bigram mixing).
"""

from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, batch: int, seq_len: int, *, seed: int = 0):
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        # fixed random bigram successor table (small, derived from seed)
        rng = np.random.default_rng(seed)
        self._succ = rng.integers(0, vocab, size=(min(vocab, 4096),), dtype=np.int64)

    def batch_at(self, step: int) -> np.ndarray:
        """(batch, seq_len) int32 tokens for global step ``step``."""
        rng = np.random.default_rng((self.seed, step))
        # Zipf-ish marginals
        z = rng.zipf(1.3, size=(self.batch, self.seq_len)).astype(np.int64)
        toks = (z - 1) % self.vocab
        # inject bigram structure: half the positions follow the table
        follow = rng.random((self.batch, self.seq_len)) < 0.5
        prev = np.roll(toks, 1, axis=1)
        succ = self._succ[prev % self._succ.shape[0]]
        toks = np.where(follow, succ, toks)
        return toks.astype(np.int32)

    def __iter__(self):
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1
