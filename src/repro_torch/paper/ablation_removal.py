"""Ablation: which partial product is "M2"?  (The JAX package's
``benchmarks/ablation_removal.py`` on the port's copies; pure numpy.)

    python -m repro_torch.paper.ablation_removal

The paper's Fig. 1 text is ambiguous about which multiplier index is removed
in MUL8x8_3.  This enumerates every single partial-product removal from the
MUL8x8_2 aggregation and reports exhaustive ER/MED/NMED/MRED: the evidence
behind the row-major M_{3i+j} reading (M2 = A[2:0]xB[7:6], M6 =
A[7:6]xB[2:0], matching "A[7:6] or B[7:6] is 00 => remove M2 or M6"), plus
the DNN-facing consequence: with co-optimized weights (B < 32) the M2
removal is error-free, every alternative is not.
"""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np

from repro_torch.core import multipliers as M
from repro_torch.core.metrics import multiplier_metrics

__all__ = ["run"]

_PIECES = ("lo", "mid", "hi")


def run() -> List[Tuple[str, float, str]]:
    """Rows (name, host microseconds to compute, result text)."""
    rows = []
    base = M.mul8x8_table("mul8x8_2")
    for pa in _PIECES:
        for pb in _PIECES:
            if (pa, pb) == ("hi", "hi"):
                continue  # that's M8, the exact 2x2 — kept by all designs
            t0 = time.perf_counter()
            spec = M.AggregationSpec("ablate", "mul3x3_2", removed=((pa, pb),))
            tab = M.aggregate_8x8(spec)
            m = multiplier_metrics(tab, f"rm_{pa}x{pb}")
            # error-free on the co-optimized domain? (weights/rhs < 32)
            free_w31 = bool(np.array_equal(tab[:, :32], base[:, :32]))
            # error-free when activations/lhs < 32?
            free_a31 = bool(np.array_equal(tab[:32, :], base[:32, :]))
            us = (time.perf_counter() - t0) * 1e6
            name = "M2" if (pa, pb) == ("lo", "hi") else ("M6" if (pa, pb) == ("hi", "lo") else "")
            rows.append(
                (f"ablation/remove_A{pa}xB{pb}{('_'+name) if name else ''}", us,
                 f"ER={m.er:.2f}% MED={m.med:.2f} NMED={m.nmed:.2f}% "
                 f"error-free@w<32={free_w31} @a<32={free_a31}")
            )
    return rows


if __name__ == "__main__":
    for row in run():
        print(f"{row[0]:36s} {row[2]}")
