"""Gather-free bitwise evaluation of the paper's approximate multipliers.

The port's own copy of the JAX package's ``core/logic.py``.  It evaluates
the K-map semantics directly: the exact 3x3 product minus the six-row
correction, by compare/mask arithmetic with no table gather, then the
shift-add aggregation of the nine 3x3 (and one exact 2x2) partial products
into the 8x8 product.  This is what the elementwise kernel (K3,
``kernels/csrc/approx_mul_eltwise.cu``) evaluates per element; it is
bit-identical to ``multipliers.mul8x8_table`` for mul8x8_1/2/3.
"""
from __future__ import annotations

import torch

__all__ = ["approx_mul3x3", "approx_mul8x8_bitwise"]


def approx_mul3x3(a: torch.Tensor, b: torch.Tensor, design: int = 1) -> torch.Tensor:
    """Bitwise 3x3 approximate product (MUL3x3_1 or _2) of int tensors.

    design 1: the six rows with product > 31 are rewritten so O5 = 0:
      (5,7)/(7,5) -> -8; (6,6),(6,7),(7,6) -> -12; (7,7) -> -20.
    design 2: the prediction unit restores O5=1/O4=0 on the a2a1b2b1 rows:
      (5,7)/(7,5) -> -8; (6,6),(6,7),(7,6) -> +4; (7,7) -> -4.
    """
    exact = a * b
    m57 = (((a == 5) & (b == 7)) | ((a == 7) & (b == 5))).to(exact.dtype)
    m66 = ((a == 6) & (b == 6)).to(exact.dtype)
    m67 = (((a == 6) & (b == 7)) | ((a == 7) & (b == 6))).to(exact.dtype)
    m77 = ((a == 7) & (b == 7)).to(exact.dtype)
    if design == 1:
        return exact - 8 * m57 - 12 * m66 - 12 * m67 - 20 * m77
    return exact - 8 * m57 + 4 * (m66 + m67) - 4 * m77


def approx_mul8x8_bitwise(a: torch.Tensor, b: torch.Tensor, design: int = 2,
                          removed_m2: bool = False) -> torch.Tensor:
    """Elementwise aggregated 8x8 approximate product via bit logic only.

    a, b: uint8-valued integer tensors (int32 result).  ``removed_m2``:
    MUL8x8_3 semantics (drop M2 = A[2:0]*B[7:6] and its shifter)."""
    a = a.to(torch.int32)
    b = b.to(torch.int32)
    alo, amid, ahi = a & 7, (a >> 3) & 7, (a >> 6) & 3
    blo, bmid, bhi = b & 7, (b >> 3) & 7, (b >> 6) & 3

    def m(x, y):
        return approx_mul3x3(x, y, design)

    out = (
        m(alo, blo)
        + (m(alo, bmid) << 3) + (m(amid, blo) << 3)
        + (m(amid, bmid) << 6)
        + (m(amid, bhi) << 9) + (m(ahi, bmid) << 9)
        + ((ahi * bhi) << 12)                    # exact 2x2 (M8)
        + (m(ahi, blo) << 6)
    )
    if not removed_m2:
        out = out + (m(alo, bhi) << 6)
    return out
