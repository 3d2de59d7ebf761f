"""Wrapper of the CUDA approximate-multiplier matmul (K1).

A CPU tensor takes the plain PyTorch version (``ref.py``); a CUDA tensor
launches the kernel in ``kernels/csrc/approx_matmul.cu`` or raises.
``approx_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import multipliers as mul
from repro_torch.kernels._build import KernelLaunchError, library
from repro_torch.kernels.approx_matmul.ref import approx_matmul_plain

__all__ = ["approx_matmul", "MAX_EXACT_K"]

# int32 accumulation of LUT values <= 65025 is exact for K * 65025 < 2**31
MAX_EXACT_K = (2**31 - 1) // 65025

_LUTS: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def _lut(multiplier: str, device: torch.device) -> torch.Tensor:
    """The multiplier's 256x256 LUT as 16-bit codes on ``device`` (every
    registered design lies in [0, 65025]; held as int16 bit patterns)."""
    key = (multiplier, device)
    if key not in _LUTS:
        tab = mul.mul8x8_table(multiplier)
        if tab.min() < 0 or tab.max() > 0xFFFF:
            raise ValueError(f"multiplier {multiplier!r} LUT does not fit 16 bits")
        bits = np.ascontiguousarray(tab.astype(np.uint16)).view(np.int16)
        _LUTS[key] = torch.from_numpy(bits.reshape(-1).copy()).to(device)
    return _LUTS[key]


@functools.lru_cache(maxsize=None)
def _fn():
    fn = library("approx_matmul").approx_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def approx_matmul(
    a_codes: torch.Tensor,
    b_codes: torch.Tensor,
    *,
    multiplier: str = "mul8x8_2",
    lhs_max: int = 255,
    rhs_max: int = 255,
) -> torch.Tensor:
    """a (..., M, K) codes x b (K, N) codes -> (..., M, N) int32 under the
    named approximate multiplier, bit-exact to the LUT.

    ``lhs_max``/``rhs_max`` are the code bounds the plain version's feature
    set is pruned to; the LUT kernel computes every code exactly and ignores
    them."""
    *lead, M, K = a_codes.shape
    Kb, N = b_codes.shape
    if K != Kb:
        raise ValueError(f"contraction mismatch: a has K={K}, b has K={Kb}")
    if a_codes.device.type == "cpu" and b_codes.device.type == "cpu":
        return approx_matmul_plain(
            a_codes, b_codes, multiplier=multiplier, lhs_max=lhs_max, rhs_max=rhs_max
        )
    if not (a_codes.is_cuda and b_codes.is_cuda) or a_codes.device != b_codes.device:
        raise ValueError(
            f"operands on {a_codes.device} and {b_codes.device}: both must be "
            "on the CPU (plain version) or on one CUDA device (kernel)"
        )
    if K > MAX_EXACT_K:
        raise ValueError(f"K={K} > {MAX_EXACT_K}: int32 accumulation would overflow")
    name = multiplier.lower()
    lut = _lut(name, a_codes.device)
    a2 = a_codes.reshape(-1, K).to(torch.uint8).contiguous()
    b2 = b_codes.to(torch.uint8).contiguous()
    out = torch.zeros((a2.shape[0], N), dtype=torch.int32, device=a_codes.device)
    if out.numel() == 0:
        return out.reshape(*lead, M, N)
    stream = torch.cuda.current_stream(a_codes.device).cuda_stream
    rc = _fn()(a2.data_ptr(), b2.data_ptr(), lut.data_ptr(), out.data_ptr(),
               a2.shape[0], N, K, stream)
    if rc != 0:
        raise KernelLaunchError(f"approx_matmul launch failed: cudaError {rc}")
    approx_matmul.launches += 1
    return out.reshape(*lead, M, N)


approx_matmul.launches = 0
