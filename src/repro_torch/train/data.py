"""Sharded LM token pipeline over the synthetic corpus (counterpart of
``repro.train.data``).

Stateless batch addressing: batch ``(step, shard)`` is a pure function of
(seed, step, shard), so data-parallel shards and gossip nodes each draw
their own stream without coordination, and a restarted job resumes
exactly. numpy end to end: the batches are bitwise the reference's.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import token_stream


class TokenBatches:
    """Batches of (tokens, labels) windows from a synthetic corpus, as
    int32 numpy arrays (B, S)."""

    def __init__(self, vocab_size: int, batch: int, seq: int, *,
                 corpus_tokens: int = 1 << 18, seed: int = 0):
        self.corpus = token_stream(corpus_tokens, vocab_size, seed=seed)
        self.batch, self.seq = batch, seq
        self.rng_seed = seed

    def __call__(self, step: int, shard: int = 0) -> dict:
        rng = np.random.default_rng((self.rng_seed, step, shard))
        starts = rng.integers(0, len(self.corpus) - self.seq - 1,
                              size=self.batch)
        idx = starts[:, None] + np.arange(self.seq + 1)[None, :]
        window = self.corpus[idx]
        return {"tokens": window[:, :-1].astype(np.int32),
                "labels": window[:, 1:].astype(np.int32)}
