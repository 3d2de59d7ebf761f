"""Wrapper of the CUDA elementwise approximate multiplier (K3).

A CPU tensor takes the plain PyTorch version (``ref.py``); a CUDA tensor
launches the kernel in ``kernels/csrc/approx_mul_eltwise.cu`` or raises.
``approx_mul_eltwise.launches`` counts kernel launches.

The kernel evaluates the multiplier's bit logic (``core/logic.py``), never
its LUT, so on the card it is an independent cross-check of the products
that the approximate matmul (K1) computes.  Only the three designs with a bitwise
form exist here: mul8x8_1, mul8x8_2 and mul8x8_3.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels._build import KernelLaunchError, library
from repro_torch.kernels.approx_matmul.ops import approx_matmul
from repro_torch.kernels.approx_mul_eltwise.ref import approx_mul_eltwise_plain

__all__ = ["DESIGNS", "UnsupportedMultiplierError", "approx_mul_eltwise", "lut_mismatches"]

# multiplier -> (3x3 design, M2 partial product removed)
DESIGNS = {"mul8x8_1": (1, False), "mul8x8_2": (2, False), "mul8x8_3": (2, True)}


class UnsupportedMultiplierError(ValueError):
    """The multiplier has no bitwise form (only mul8x8_1/2/3 do)."""


@functools.lru_cache(maxsize=None)
def _fn():
    fn = library("approx_mul_eltwise").approx_mul_eltwise_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _codes(x: torch.Tensor) -> torch.Tensor:
    """uint8 codes, contiguous, on a 4-byte boundary (the kernel loads four
    codes at a time); an int32 input keeps its low 8 bits."""
    x = x.contiguous() if x.dtype == torch.uint8 else (x & 255).to(torch.uint8)
    return x if x.data_ptr() % 4 == 0 else x.clone()


def approx_mul_eltwise(a: torch.Tensor, b: torch.Tensor, *,
                       multiplier: str = "mul8x8_2") -> torch.Tensor:
    """a, b: uint8 or int32 tensors of one shape holding codes in [0, 255]
    -> int32 approximate products, same shape."""
    name = multiplier.lower()
    if name not in DESIGNS:
        raise UnsupportedMultiplierError(
            f"multiplier {multiplier!r} has no bitwise form; the elementwise "
            f"kernel takes {sorted(DESIGNS)}")
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} and {tuple(b.shape)}")
    for t in (a, b):
        if t.dtype not in (torch.uint8, torch.int32):
            raise TypeError(f"codes must be uint8 or int32, got {t.dtype}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return approx_mul_eltwise_plain(a, b, name)
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(
            f"operands on {a.device} and {b.device}: both must be on the CPU "
            "(plain version) or on one CUDA device (kernel)")
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    a8, b8 = _codes(a), _codes(b)
    design, removed = DESIGNS[name]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = _fn()(a8.data_ptr(), b8.data_ptr(), out.data_ptr(), out.numel(), design,
               int(removed), stream)
    if rc != 0:
        raise KernelLaunchError(f"approx_mul_eltwise launch failed: cudaError {rc}")
    approx_mul_eltwise.launches += 1
    return out


approx_mul_eltwise.launches = 0


def lut_mismatches(multiplier: str, device=None) -> int:
    """How many of the 65,536 code pairs (a, b) have a product under the
    multiplier's bit logic (the kernel, on a CUDA device) other than the
    table K1 computes on that device: one approximate matmul with K = 1,
    the codes 0..255 as a column times the codes 0..255 as a row.  0 when
    K1 is right.  ``device`` defaults to the CUDA device (raising without
    one)."""
    dev = resolve_device(device)
    codes = torch.arange(256, device=dev, dtype=torch.uint8)
    got = approx_mul_eltwise(codes.repeat_interleave(256), codes.repeat(256),
                             multiplier=multiplier)
    table = approx_matmul(codes[:, None], codes[None, :], multiplier=multiplier)
    return int((got != table.reshape(-1)).sum())
