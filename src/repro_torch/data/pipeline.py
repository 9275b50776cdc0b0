"""Synthetic-but-learnable token data.

A tiny order-2 Markov language over the model's vocabulary: next-token
distribution depends on (prev_token % K); a model that trains correctly drops
well below the uniform-entropy loss within a few hundred steps, which is what
the end-to-end training example asserts.
"""
from __future__ import annotations

import numpy as np


class SyntheticLM:
    def __init__(self, vocab_size: int, seed: int = 0, branching: int = 17):
        self.vocab = vocab_size
        self.k = branching
        rng = np.random.default_rng(seed)
        # each state s in [0, K) prefers a small set of successor tokens
        self.tables = rng.integers(0, vocab_size,
                                   size=(branching, 8)).astype(np.int32)

    def sample(self, rng: np.random.Generator, batch: int, seq: int
               ) -> np.ndarray:
        out = np.empty((batch, seq), np.int32)
        tok = rng.integers(0, self.vocab, size=batch)
        for t in range(seq):
            state = tok % self.k
            choice = rng.integers(0, self.tables.shape[1], size=batch)
            nxt = self.tables[state, choice]
            # 10% uniform noise
            noise = rng.integers(0, self.vocab, size=batch)
            mask = rng.random(batch) < 0.10
            tok = np.where(mask, noise, nxt).astype(np.int32)
            out[:, t] = tok
        return out


def token_batches(vocab_size: int, batch: int, seq: int, n_steps: int,
                  seed: int = 0):
    """Yields {'tokens': (B, S) int32} batches."""
    gen = SyntheticLM(vocab_size, seed)
    rng = np.random.default_rng(seed + 1)
    for _ in range(n_steps):
        yield {"tokens": gen.sample(rng, batch, seq)}
