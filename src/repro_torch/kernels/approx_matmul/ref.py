"""Plain PyTorch version of the approximate-multiplier matmul.

``out[m, n] = sum_k LUT[a[m, k], b[k, n]]`` evaluated through the exact
decomposition of the multiplier's error (``core/lowrank.py``):

    out = A @ B - sum_f v_f(A) @ u_f(B)

in float64, where every partial sum of these integer products stays below
2**53 and is therefore exact; the result is cast to int32.  This is what the
CPU tests hold against the JAX package, and what ``chip_smoke.py`` holds the
CUDA kernel against on the card at full shapes (a LUT gather would
materialise an (M, K, N) index tensor there).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import lowrank as lr

__all__ = ["approx_matmul_plain", "correction"]


@functools.lru_cache(maxsize=None)
def correction(multiplier: str, lhs_max: int, rhs_max: int) -> lr.LowRankCorrection:
    """Cached factorization with the indicator features on the rhs (weight)
    side — the co-optimized weight band (0, 31) prunes rhs rows hardest."""
    return lr.build_correction(multiplier, side="rhs", lhs_max=lhs_max, rhs_max=rhs_max)


def approx_matmul_plain(
    a_codes: torch.Tensor,
    b_codes: torch.Tensor,
    *,
    multiplier: str = "mul8x8_2",
    lhs_max: int = 255,
    rhs_max: int = 255,
) -> torch.Tensor:
    """a (..., M, K) codes x b (K, N) codes -> (..., M, N) int32, exact on
    codes in [0, lhs_max] x [0, rhs_max]."""
    a64 = a_codes.to(torch.float64)
    b64 = b_codes.to(torch.float64)
    out = a64 @ b64
    for f in correction(multiplier.lower(), lhs_max, rhs_max).features:
        va = lr.v_map(a_codes, f.v_terms)
        ub = lr.u_map(b_codes, f.kind, f.u_shift, f.u_bits, f.residue, f.u_terms)
        out -= va @ ub
    return out.to(torch.int32)
