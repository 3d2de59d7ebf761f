"""The approximate matmul's execution modes side by side: the paper-faithful
LUT gather (``lut``), the exact form with its error decomposition in float64
(``lowrank``, K1's plain version), the exact integer product (``exact_quant``)
and K1 (``kernel``).  The matmul half of the JAX package's
``benchmarks/kernel_bench.py``, on the card.

    python -m repro_torch.paper.kernel_bench [--device D]

Every mode's output must equal the LUT oracle's (``exact_quant`` aside: it
is the exact product, the yardstick of the cost of the integer matmul
alone).  Times are CUDA-event means on the card, host-clock means on the
CPU; each row names the device.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.approx import ApproxConfig, quantized_matmul
from repro_torch.device import resolve_device

__all__ = ["MODES", "run"]

MODES = ("exact_quant", "lut", "lowrank", "kernel")


def _time_us(fn: Callable[[], torch.Tensor], dev: torch.device, iters: int) -> float:
    fn()                                       # warm: builds the kernel, caches tables
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters * 1e3


def run(device=None, shape: Tuple[int, int, int] = (256, 512, 256),
        iters: int = 5) -> List[Tuple[str, float, str]]:
    """Rows (name, microseconds per call, result text); raises if a mode's
    output differs from the LUT oracle's."""
    dev = resolve_device(device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    M_, K_, N_ = shape
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(0, 256, (M_, K_)).astype(np.uint8)).to(dev)
    b = torch.from_numpy(rng.integers(0, 256, (K_, N_)).astype(np.uint8)).to(dev)
    rows, outs = [], {}
    for mode in MODES:
        cfg = ApproxConfig(multiplier="mul8x8_2", mode=mode)
        fn = lambda cfg=cfg: quantized_matmul(a, b, cfg)
        us = _time_us(fn, dev, iters)
        outs[mode] = fn()
        rows.append((f"kernel/{mode}_matmul_{M_}x{K_}x{N_}", us,
                     f"{2 * M_ * K_ * N_ / us / 1e3:.2f} GOP/s-equiv on {where}"))
    for mode in ("lowrank", "kernel"):
        equal = torch.equal(outs[mode], outs["lut"])
        if not equal:
            raise AssertionError(f"{mode} differs from the LUT oracle at {shape}")
        rows.append((f"kernel/{mode}_bitexact_vs_lut", 0.0, f"equal={equal}"))

    # range-pruned variant (co-optimized weights < 32): F=6 -> 3
    bw = torch.from_numpy(rng.integers(0, 32, (K_, N_)).astype(np.uint8)).to(dev)
    pruned = {}
    for mode in ("lut", "lowrank", "kernel"):
        cfg = ApproxConfig(multiplier="mul8x8_2", mode=mode, w_qmax=31)
        fn = lambda cfg=cfg: quantized_matmul(a, bw, cfg)
        pruned[mode] = fn()
        if mode != "lut":
            us = _time_us(fn, dev, iters)
            rows.append((f"kernel/{mode}_pruned_matmul_{M_}x{K_}x{N_}", us,
                         f"F=3 (weights<32) on {where}"))
    for mode in ("lowrank", "kernel"):
        if not torch.equal(pruned[mode], pruned["lut"]):
            raise AssertionError(f"pruned {mode} differs from the LUT oracle at {shape}")
    return rows


def main(argv: Optional[List[str]] = None) -> List[Tuple[str, float, str]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows = run(resolve_device(args.device))
    for name, us, text in rows:
        print(f"{name:44s} {us:12.1f} us  {text}")
    return rows


if __name__ == "__main__":
    main()
