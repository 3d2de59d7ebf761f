"""Paper Table V: arithmetic accuracy of the approximate multipliers (the
JAX package's ``benchmarks/table_v.py`` on the port's copies; pure numpy).

    python -m repro_torch.paper.table_v

Reports the exhaustive-domain ER/MED/NMED/MRED of the architecture-faithful
implementations next to the paper's printed values (the 3x3 metrics match
exactly; the printed 8x8 numbers are not reachable from the described
aggregation)."""
from __future__ import annotations

import time
from typing import List, Tuple

from repro_torch.core import multipliers as M
from repro_torch.core.metrics import multiplier_metrics

__all__ = ["PAPER", "run"]

PAPER = {
    "mul8x8_1": (22.8, 137.04, 0.21, 1.50),
    "mul8x8_2": (20.49, 114.83, 0.18, 1.42),
    "mul8x8_3": (31.41, 648.20, 1.00, 2.53),
    "pkm": (49.86, 938.32, 1.44, 3.89),
    "etm": (98.88, None, 2.85, 25.21),
}


def run() -> List[Tuple[str, float, str]]:
    """Rows (name, host microseconds to compute, result text)."""
    rows = []
    for name, tab in [("mul3x3_1", M.mul3x3_1_table()), ("mul3x3_2", M.mul3x3_2_table())]:
        t0 = time.perf_counter()
        m = multiplier_metrics(tab, name)
        us = (time.perf_counter() - t0) * 1e6
        rows.append(
            (f"table_v/{name}", us,
             f"ER={m.er:.3f}% MED={m.med:.3f} (paper: 9.375%/" +
             ("1.125)" if name == "mul3x3_1" else "0.5)"))
        )
    for name in ("mul8x8_1", "mul8x8_2", "mul8x8_3", "pkm", "etm"):
        t0 = time.perf_counter()
        m = multiplier_metrics(M.mul8x8_table(name), name)
        us = (time.perf_counter() - t0) * 1e6
        p = PAPER[name]
        rows.append(
            (f"table_v/{name}", us,
             f"ER={m.er:.2f}% MED={m.med:.2f} NMED={m.nmed:.2f}% MRED={m.mred:.2f}%"
             f" | paper ER={p[0]} MED={p[1]} NMED={p[2]} MRED={p[3]}")
        )
    return rows


if __name__ == "__main__":
    for row in run():
        print(f"{row[0]:28s} {row[2]}")
