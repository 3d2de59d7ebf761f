"""Plain PyTorch versions of the approximate-multiplier matmul.

``out[m, n] = sum_k LUT[a[m, k], b[k, n]]`` evaluated through the exact
decomposition of the multiplier's error (``core/lowrank.py``):

    out = A @ B - sum_f v_f(A) @ u_f(B)

in float64, where every partial sum of these integer products stays below
2**53 and is therefore exact; the result is cast to int32.  This is what the
CPU tests hold against the JAX package, and what ``chip_smoke.py`` holds the
CUDA kernel against on the card at full shapes (a LUT gather would
materialise an (M, K, N) index tensor there).

``approx_matmul_lut`` is the paper-faithful form, the JAX package's
``approx_matmul_ref``: one gather of the multiplier's 256 x 256 LUT per MAC,
summed in int32 over K-chunks of 512.  It is the ``lut`` execution mode and
the oracle of the other two.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import lowrank as lr

__all__ = ["approx_matmul_lut", "approx_matmul_plain", "approx_mul_elementwise", "correction"]

# elements of one (rows, k-chunk, N) index tensor the LUT gather builds
_GATHER_ELEMS = 1 << 24


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


def approx_mul_elementwise(a: torch.Tensor, b: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """LUT[a, b] elementwise (broadcasting); codes in [0, 255]."""
    return lut.reshape(-1)[a.long() * 256 + b.long()]


def approx_matmul_lut(a_codes: torch.Tensor, b_codes: torch.Tensor, lut: torch.Tensor, *,
                      block_k: int = 512) -> torch.Tensor:
    """sum_k LUT[a[..., m, k], b[k, n]] with int32 accumulation, exact on
    every code in [0, 255].

    a_codes: (..., M, K) codes; b_codes: (K, N); lut: (256, 256) ints on the
    operands' device.  K is summed in chunks of ``block_k`` as the JAX
    oracle sums it, and rows in slices small enough that one gather's index
    tensor stays below 2**24 elements (integer sums do not depend on the
    order)."""
    *lead, M, K = a_codes.shape
    N = b_codes.shape[1]
    a2 = a_codes.reshape(-1, K).long()
    b = b_codes.long()
    flat = lut.reshape(-1).to(torch.int32)
    out = torch.zeros((a2.shape[0], N), dtype=torch.int32, device=a_codes.device)
    for k0 in range(0, K, block_k):
        bk = b[k0:k0 + block_k]
        rows = max(1, _GATHER_ELEMS // max(1, bk.shape[0] * N))
        for m0 in range(0, a2.shape[0], rows):
            ak = a2[m0:m0 + rows, k0:k0 + block_k]
            out[m0:m0 + rows] += approx_mul_elementwise(
                ak[:, :, None], bk[None], flat).sum(dim=1, dtype=torch.int32)
    return out.reshape(*lead, M, N)
