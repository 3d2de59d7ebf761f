"""Distributed data loading: deterministic per-host sharding (the JAX
package's ``data/loader.py``, copied: numpy only, the same draws, so both
packages see identical batches).

Every host draws a disjoint slice of the global batch and stays bitwise
deterministic under restarts and elastic resizes: each batch is derived
purely from (seed, step, host_slice).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

__all__ = ["ShardedTokenLoader"]


@dataclasses.dataclass(frozen=True)
class ShardedTokenLoader:
    """Deterministic synthetic token stream, sharded by host.

    ``global_batch`` rows are split evenly over ``num_hosts``; host
    ``host_id`` materializes only its rows.  ``batch_at(step)`` is a pure
    function, the basis of checkpoint-restart and elastic-resize
    determinism.
    """

    vocab: int
    global_batch: int
    seq_len: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.global_batch % self.num_hosts != 0:
            raise ValueError(f"global_batch {self.global_batch} is not a multiple of "
                             f"num_hosts {self.num_hosts}")
        if not 0 <= self.host_id < self.num_hosts:
            raise ValueError(f"host_id {self.host_id} not in [0, {self.num_hosts})")

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.num_hosts

    def _row(self, step: int, row: int) -> np.ndarray:
        """One (seq_len+1,) token row, derived only from (seed, step, row)."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, row]))
        succ = rng.integers(0, self.vocab, size=8)
        t = np.empty(self.seq_len + 1, np.int64)
        t[0] = rng.integers(0, self.vocab)
        picks = rng.integers(0, 8, self.seq_len)
        flips = rng.random(self.seq_len) < 0.1
        rand = rng.integers(0, self.vocab, self.seq_len)
        for i in range(self.seq_len):
            t[i + 1] = rand[i] if flips[i] else (t[i] + succ[picks[i]]) % self.vocab
        return t

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The host-local slice of the global batch for ``step``."""
        lo = self.host_id * self.host_batch
        rows = np.stack([self._row(step, lo + r) for r in range(self.host_batch)])
        return {
            "tokens": rows[:, :-1].astype(np.int32),
            "labels": rows[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
