"""Deterministic synthetic token streams (the JAX package's
``data/synthetic.token_batches``, the same numpy draws in the same order,
so the port trains on bit-identical batches)."""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

__all__ = ["token_batches"]


def token_batches(
    vocab: int, batch: int, seq: int, *, seed: int = 0
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless stream of (tokens, labels) int32 (batch, seq) with order-1
    Markov structure."""
    rng = np.random.default_rng(seed)
    # sparse transition structure: each token has 8 likely successors
    succ = rng.integers(0, vocab, size=(vocab, 8))
    while True:
        t = np.empty((batch, seq + 1), np.int32)
        t[:, 0] = rng.integers(0, vocab, batch)
        for i in range(seq):
            pick = succ[t[:, i], rng.integers(0, 8, batch)]
            flip = rng.random(batch) < 0.1
            t[:, i + 1] = np.where(flip, rng.integers(0, vocab, batch), pick)
        yield t[:, :-1], t[:, 1:]
