"""Quickstart: the paper's multipliers as a composable PyTorch feature (the
JAX package's ``examples/quickstart.py`` on the port).

    python -m repro_torch.examples.quickstart [--device D]
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import lowrank, multipliers as M
from repro_torch.core.approx import ApproxConfig, approx_dense, quantized_matmul
from repro_torch.core.metrics import multiplier_metrics
from repro_torch.device import resolve_device
from repro_torch.kernels.approx_matmul import approx_matmul, approx_matmul_lut


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    out = {}

    print("== 1. The paper's multipliers as LUTs ==")
    for name in ("mul8x8_1", "mul8x8_2", "mul8x8_3", "pkm", "etm"):
        m = multiplier_metrics(M.mul8x8_table(name), name)
        print(f"  {name:10s} ER={m.er:6.2f}%  MED={m.med:8.2f}  NMED={m.nmed:5.2f}%  "
              f"MRED={m.mred:6.2f}%")

    print("\n== 2. Exact low-rank decomposition ==")
    for name in ("mul8x8_1", "mul8x8_2", "mul8x8_3"):
        c = lowrank.build_correction(name, side="rhs")
        cp = lowrank.build_correction(name, side="rhs", rhs_max=31)
        print(f"  {name}: approx(A,B) = A@B - sum of {c.num_features} feature dots"
              f" (co-optimized weights<32: {cp.num_features})")

    print(f"\n== 3. Bit-exact approximate matmul, three ways (on {dev}) ==")
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(0, 256, (64, 128)).astype(np.uint8)).to(dev)
    b = torch.from_numpy(rng.integers(0, 256, (128, 32)).astype(np.uint8)).to(dev)
    lut = approx_matmul_lut(a, b, torch.from_numpy(M.mul8x8_table("mul8x8_2")).to(dev))
    lowr = quantized_matmul(a, b, ApproxConfig(multiplier="mul8x8_2", mode="lowrank"))
    kern = approx_matmul(a, b, multiplier="mul8x8_2")
    out["lowrank_equal"] = torch.equal(lut, lowr)
    out["kernel_equal"] = torch.equal(lut, kern)
    print("  LUT-oracle == lowrank :", out["lowrank_equal"])
    print("  LUT-oracle == kernel  :", out["kernel_equal"],
          "(K1)" if dev.type == "cuda" else "(the kernel's plain version on the CPU)")

    print("\n== 4. A real-valued dense layer under the approximate multiplier ==")
    x = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32)).to(dev)
    y_exact = x @ w
    for mult in ("exact", "mul8x8_2", "mul8x8_3"):
        mode = "exact_quant" if mult == "exact" else "kernel"
        y = approx_dense(x, w, ApproxConfig(multiplier=mult, mode=mode))
        rel = (torch.linalg.norm(y - y_exact) / torch.linalg.norm(y_exact)).item()
        out[f"rel_err_{mult}"] = rel
        print(f"  {mult:10s} rel-error vs float matmul: {rel:.4f}")

    print("\n== 5. Gradients flow (QAT straight-through) ==")
    cfg = ApproxConfig(multiplier="mul8x8_2", mode="kernel")
    wg = w.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sum(approx_dense(x, wg, cfg) ** 2), wg)
    out["grad_finite"] = bool(torch.isfinite(g).all())
    print("  d/dw finite:", out["grad_finite"], " norm:", torch.linalg.norm(g).item())
    return out


if __name__ == "__main__":
    main()
