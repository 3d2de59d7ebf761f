"""Arithmetic error metrics for approximate multipliers (paper Section
III.A; the JAX package's ``core/metrics.py``, copied).

ED    = |Value' - Value|                              (eq. 1)
MED   = mean(ED) over the full input domain           (eq. 2)
ER    = fraction of inputs with ED != 0               (eq. 3)
NMED  = MED / (2**n - 1)**2                           (eq. 10)
MRED  = mean(ED / Value) over inputs with Value > 0   (eq. 11, conventional
        form; the paper's printed denominator ``Value' * 2**n`` does not
        reproduce its own Table V, the conventional mean-relative-ED does)
DAL   = DNN accuracy loss: accuracy(exact) - accuracy(approx).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["MultiplierMetrics", "multiplier_metrics", "dal"]


@dataclasses.dataclass(frozen=True)
class MultiplierMetrics:
    name: str
    er: float      # percent
    med: float
    nmed: float    # percent
    mred: float    # percent
    max_ed: int

    def as_dict(self) -> Dict[str, float]:
        return {
            "er_pct": self.er,
            "med": self.med,
            "nmed_pct": self.nmed,
            "mred_pct": self.mred,
            "max_ed": float(self.max_ed),
        }


def multiplier_metrics(table: np.ndarray, name: str = "") -> MultiplierMetrics:
    """ER/MED/NMED/MRED over the multiplier's full input domain."""
    n_bits = int(np.log2(table.shape[0]))
    exact = (
        np.arange(table.shape[0], dtype=np.int64)[:, None]
        * np.arange(table.shape[1], dtype=np.int64)[None, :]
    )
    ed = np.abs(table.astype(np.int64) - exact)
    er = 100.0 * float(np.count_nonzero(ed)) / ed.size
    med = float(ed.mean())
    nmed = 100.0 * med / float((2**n_bits - 1) ** 2)
    nz = exact > 0
    mred = 100.0 * float((ed[nz] / exact[nz]).mean())
    return MultiplierMetrics(
        name=name, er=er, med=med, nmed=nmed, mred=mred, max_ed=int(ed.max())
    )


def dal(exact_accuracy: float, approx_accuracy: float) -> float:
    """DNN accuracy loss in percentage points."""
    return exact_accuracy - approx_accuracy
