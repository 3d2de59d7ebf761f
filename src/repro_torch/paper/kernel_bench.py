"""The approximate matmul's execution modes side by side: the paper-faithful
LUT gather (``lut``), the exact form with its error decomposition in float64
(``lowrank``, K1's plain version), the exact integer product (``exact_quant``)
and K1 (``kernel``); then the decode engines, ``greedy_generate_legacy``
against ``generate`` (``_decode_bench``).  The JAX package's
``benchmarks/kernel_bench.py``, on the card.

    python -m repro_torch.paper.kernel_bench [--device D]

Every mode's output must equal the LUT oracle's (``exact_quant`` aside: it
is the exact product, the yardstick of the cost of the integer matmul
alone).  Matmul times are CUDA-event means on the card, host-clock means on
the CPU; decode times are host-clock seconds per run, ending when the
tokens are on the device; each row names the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.approx import ApproxConfig, quantized_matmul
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import generate, greedy_generate_legacy

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

    rows.extend(_decode_bench(dev, iters=iters))
    return rows


def _decode_bench(device=None, *, cfg=None, params=None, batch: int = 8,
                  prompt_len: int = 8, max_new: int = 32, max_len: Optional[int] = None,
                  iters: int = 3, warm: bool = True,
                  outputs: Optional[Dict[str, torch.Tensor]] = None
                  ) -> List[Tuple[str, float, str]]:
    """Decode throughput: the legacy per-token loop against ``generate``
    (fused prefill, then the decode loop).  By default the JAX benchmark's
    model: reduced granite-3-2b in float mode, which isolates the engines'
    dispatch cost; ``cfg``/``params`` (and ``max_len``, the stripe) time
    another model: ``chip_smoke.py`` passes granite-3-2b at full width
    through K1, skips the warm-up (``warm=False``: every kernel and table
    is warm by then) and takes each engine's last tokens in ``outputs``
    (keyed by row name) to check them."""
    dev = resolve_device(device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if cfg is None:
        cfg = dataclasses.replace(reduced_config(get_config("granite-3-2b")),
                                  approx=ApproxConfig(mode="float"))
        params = init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    run = dict(max_new=max_new, max_len=max_len, device=dev)
    engines = (("legacy_loop", lambda: greedy_generate_legacy(cfg, params, prompt, **run)),
               ("scan_engine", lambda: generate(cfg, params, prompt, **run)))
    rows = []
    for name, fn in engines:
        if warm:
            fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) / iters
        if outputs is not None:
            outputs[name] = out
        rows.append((f"serve/decode_{name}_b{batch}_n{max_new}", dt * 1e6,
                     f"{batch * max_new / dt:.1f} tok/s on {where}"))
    return rows


def main(argv: Optional[List[str]] = None) -> List[Tuple[str, float, str]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows = run(args.device)
    for name, us, text in rows:
        print(f"{name:44s} {us:12.1f} us  {text}")
    return rows


if __name__ == "__main__":
    main()
