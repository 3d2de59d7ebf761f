"""Paper Tables VI/VII: area, power and delay (the JAX package's
``benchmarks/table_vi_vii.py`` on the port's copies; pure numpy).

    python -m repro_torch.paper.table_vi_vii

The repository runs no EDA tools, so the paper's ASAP7 DC numbers are data;
beside them stand the unit-gate structural estimate (a trend check) and
the accelerator-level systolic-array roll-up."""
from __future__ import annotations

import time
from typing import List, Tuple

from repro_torch.core.hwcost import (
    PAPER_TABLE_VI,
    PAPER_TABLE_VII,
    systolic_array_cost,
    unit_gate_estimate,
)

__all__ = ["run"]


def run() -> List[Tuple[str, float, str]]:
    """Rows (name, host microseconds to compute, result text)."""
    rows = []
    base = PAPER_TABLE_VI["exact3x3"]
    for name in ("mul3x3_1", "mul3x3_2"):
        t0 = time.perf_counter()
        imp = PAPER_TABLE_VI[name].improvement_over(base)
        est = unit_gate_estimate(name)
        us = (time.perf_counter() - t0) * 1e6
        rows.append(
            (f"table_vi/{name}", us,
             f"area -{imp['area_pct']:.2f}% power -{imp['power_pct']:.2f}% "
             f"delay -{imp['delay_pct']:.2f}% | unit-gate rel-area {est['relative_area']:.3f}")
        )
    base8 = PAPER_TABLE_VII["exact8x8"]
    for name in ("mul8x8_1", "mul8x8_2", "mul8x8_3", "siei", "pkm"):
        t0 = time.perf_counter()
        imp = PAPER_TABLE_VII[name].improvement_over(base8)
        derived = (
            f"area -{imp['area_pct']:.2f}% power -{imp['power_pct']:.2f}% "
            f"delay -{imp['delay_pct']:.2f}%"
        )
        if name.startswith("mul8x8"):
            est = unit_gate_estimate(name)
            derived += f" | unit-gate rel-area {est['relative_area']:.3f}"
        us = (time.perf_counter() - t0) * 1e6
        rows.append((f"table_vii/{name}", us, derived))
    # accelerator-level roll-up (128x128 MAC array)
    for name in ("mul8x8_2", "mul8x8_3"):
        t0 = time.perf_counter()
        c = systolic_array_cost(name)
        us = (time.perf_counter() - t0) * 1e6
        rows.append(
            (f"systolic_128x128/{name}", us,
             f"area {c['area_mm2']:.2f}mm2 (-{c['area_saving_pct']:.1f}%) "
             f"power {c['power_w']:.1f}W (-{c['power_saving_pct']:.1f}%) "
             f"cp {c['critical_path_ns']:.2f}ns")
        )
    return rows


if __name__ == "__main__":
    for row in run():
        print(f"{row[0]:28s} {row[2]}")
