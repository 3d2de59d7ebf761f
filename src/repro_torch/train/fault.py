"""Fault-tolerance runtime pieces (host code only; the JAX package's
``train/fault.py``):

* ``StragglerMonitor`` — EWMA step-time watchdog. On real pods the step time
  is a collective barrier, so one slow host inflates everyone's step; the
  monitor flags sustained outliers (policy hook decides: re-slice, evict,
  or alert). Here the policy hook is injectable for tests.
* ``PreemptionGuard`` — SIGTERM/SIGINT handler that requests a final
  checkpoint flush + clean exit at the next step boundary (the GKE/Borg
  maintenance-event pattern).
* ``run_with_restarts`` — supervisor that restarts a training function from
  the latest checkpoint after a (simulated or real) failure, up to a retry
  budget: checkpoint/restart fault tolerance in one callable.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, List, Optional

__all__ = ["StragglerMonitor", "PreemptionGuard", "run_with_restarts"]


@dataclasses.dataclass
class StragglerMonitor:
    """Flags steps slower than ``threshold`` x the EWMA step time."""

    alpha: float = 0.1
    threshold: float = 2.0
    warmup: int = 5
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    _ewma: float = 0.0
    _n: int = 0
    events: List[int] = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        self._n += 1
        if self._n <= self.warmup:
            self._ewma = dt if self._ewma == 0 else (1 - self.alpha) * self._ewma + self.alpha * dt
            return False
        is_straggler = dt > self.threshold * self._ewma
        if is_straggler:
            self.events.append(step)
            if self.on_straggler:
                self.on_straggler(step, dt, self._ewma)
        else:
            # only fold non-outlier samples into the EWMA
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * dt
        return is_straggler

    @property
    def ewma(self) -> float:
        return self._ewma


class PreemptionGuard:
    """Install as a context manager; ``should_stop`` flips on SIGTERM/SIGINT
    so the training loop can flush a checkpoint and exit cleanly."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = signals
        self._old = {}
        self.should_stop = False

    def _handler(self, signum, frame):
        self.should_stop = True

    def __enter__(self):
        for s in self._signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._old.items():
            signal.signal(s, h)
        return False


def run_with_restarts(
    fn: Callable[[int], Any],
    *,
    max_restarts: int = 3,
    backoff_s: float = 0.0,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
) -> Any:
    """Run ``fn(attempt)`` restarting on exceptions (node failure model).
    ``fn`` is expected to resume from the latest checkpoint internally."""
    attempt = 0
    while True:
        try:
            return fn(attempt)
        except KeyboardInterrupt:
            raise
        except BaseException as e:  # noqa: BLE001 - supervisor catches all
            attempt += 1
            if attempt > max_restarts:
                raise
            if on_restart:
                on_restart(attempt, e)
            if backoff_s:
                time.sleep(backoff_s)
