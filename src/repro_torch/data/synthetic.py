"""Deterministic synthetic datasets (the JAX package's
``data/synthetic.py``: the same numpy draws in the same order, so the port
trains on bit-identical arrays).

* ``image_dataset``: class-conditional template + noise images with MNIST /
  CIFAR10 shapes.  A CNN has to learn the templates, so exact-vs-approximate
  multiplier accuracy deltas (DAL) and retraining recovery are measurable:
  the paper's Table VIII protocol on matched-shape data.
* ``token_batches``: order-1 Markov token streams for LM training.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

__all__ = ["ImageData", "image_dataset", "token_batches"]


@dataclasses.dataclass
class ImageData:
    x_train: np.ndarray          # (n_train, H, W, C) float32 in [0, 1]
    y_train: np.ndarray          # (n_train,) int32
    x_test: np.ndarray
    y_test: np.ndarray


def image_dataset(
    dataset: str = "mnist",
    *,
    n_train: int = 2048,
    n_test: int = 512,
    num_classes: int = 10,
    noise: float = 0.35,
    seed: int = 0,
) -> ImageData:
    shape = (28, 28, 1) if dataset == "mnist" else (32, 32, 3)
    rng = np.random.default_rng(seed)
    # smooth class templates: low-frequency random fields
    k = 6
    freq = rng.normal(size=(num_classes, k, k, shape[2]))
    temps = []
    for c in range(num_classes):
        t = np.kron(freq[c], np.ones((shape[0] // k + 1, shape[1] // k + 1, 1)))
        temps.append(t[: shape[0], : shape[1], :])
    temps = np.stack(temps)                     # (C, H, W, ch)
    temps = temps / np.abs(temps).max()

    def make(n, salt):
        r = np.random.default_rng(seed + salt)
        y = r.integers(0, num_classes, n)
        x = temps[y] + noise * r.normal(size=(n, *shape))
        return np.clip(x * 0.5 + 0.5, 0, 1).astype(np.float32), y.astype(np.int32)

    xtr, ytr = make(n_train, 1)
    xte, yte = make(n_test, 2)
    return ImageData(xtr, ytr, xte, yte)


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
