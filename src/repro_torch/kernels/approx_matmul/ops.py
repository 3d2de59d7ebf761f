"""Wrapper of the CUDA approximate-multiplier matmul (K1).

A CPU tensor takes the plain PyTorch version (``ref.py``); a CUDA tensor
launches the kernel in ``kernels/csrc/approx_matmul.cu`` or raises.
``approx_matmul.launches`` counts kernel launches.

The kernel computes ``A@B - c * sum_f vt_f(A) @ u'_f(B)`` on the integer
tensor cores, every operand 8 bits wide; ``feature_tables`` builds those
maps from the plain version's factorization and checks them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import multipliers as mul
from repro_torch.kernels._build import KernelLaunchError, library
from repro_torch.kernels.approx_matmul.ref import approx_matmul_plain, correction

__all__ = ["FeatureTables", "MAX_EXACT_K", "MAX_FEATURES", "approx_matmul", "feature_tables"]

# int32 accumulation of products <= 65025 is exact for K * 65025 < 2**31
MAX_EXACT_K = (2**31 - 1) // 65025
# one packed 8-byte table entry holds the code and up to 7 feature bytes
MAX_FEATURES = 7


@dataclasses.dataclass(frozen=True)
class FeatureTables:
    """The multiplier's error as 8-bit maps:

        LUT[a, b] = a*b - c * sum_f vt_f(a) * u'_f(b)

    exact on codes in [0, lhs_max] x [0, rhs_max].  ``v`` holds each vt_f as
    256 bytes, two's complement where ``v_signed[f]`` (int8) and plain
    where not (uint8, at most one map, placed first); ``u`` holds each
    u'_f (uint8).  ``packed`` is what
    the kernel loads, on the device: ``packed[0, a]`` the bytes
    (vt_0(a), ..., vt_{F-1}(a)), ``packed[1, b]`` the bytes
    (b, u'_0(b), ..., u'_{F-1}(b)), zero-padded to 8."""

    c: int
    v: torch.Tensor            # (F, 256) uint8 bit patterns
    v_signed: Tuple[bool, ...]
    u: torch.Tensor            # (F, 256) uint8
    packed: torch.Tensor       # (2, 256, 8) uint8

    @property
    def num_features(self) -> int:
        return len(self.v_signed)

    @property
    def num_unsigned(self) -> int:
        return self.v_signed.count(False)

    def v_values(self) -> torch.Tensor:
        """(F, 256) int64 values of the vt_f maps."""
        v = self.v.to(torch.int64)
        signed = torch.tensor(self.v_signed, dtype=torch.bool, device=v.device)[:, None]
        return torch.where(signed & (v > 127), v - 256, v)


_TABLES: Dict[Tuple[str, int, int, torch.device], FeatureTables] = {}


def _build_tables(multiplier: str, lhs_max: int, rhs_max: int) -> Tuple[int, np.ndarray,
                                                                        Tuple[bool, ...],
                                                                        np.ndarray]:
    """(c, vt (F, 256) int64, signedness, u' (F, 256) int64), checked."""
    feats = correction(multiplier, lhs_max, rhs_max).features
    if len(feats) > MAX_FEATURES:
        raise ValueError(f"multiplier {multiplier!r}: {len(feats)} features, the kernel "
                         f"takes at most {MAX_FEATURES}")
    gs = [math.gcd(*(abs(int(x)) for x in f.v_tab if x != 0)) or 1 for f in feats]
    c = math.gcd(*gs) if gs else 1
    vt = np.array([f.v_tab.astype(np.int64) // g for f, g in zip(feats, gs)],
                  np.int64).reshape(-1, 256)
    up = np.array([f.u_tab.astype(np.int64) * (g // c) for f, g in zip(feats, gs)],
                  np.int64).reshape(-1, 256)
    # s8 wherever the values allow it, u8 only for maps that reach past 127;
    # the kernel takes those first, and at most one of them
    order = sorted(range(len(vt)), key=lambda f: vt[f].max() <= 127)
    vt, up = vt[order], up[order]
    signed = tuple(bool(row.max() <= 127) for row in vt)
    if signed.count(False) > 1:
        raise ValueError(f"multiplier {multiplier!r}: {signed.count(False)} activation maps "
                         "need uint8; the kernel takes at most one")
    for f, (row, s) in enumerate(zip(vt, signed)):
        lo, hi = (-128, 127) if s else (0, 255)
        if row.min() < lo or row.max() > hi:
            raise ValueError(f"multiplier {multiplier!r}: feature {f}'s activation map "
                             f"spans {row.min()}..{row.max()}, beyond an 8-bit operand")
        if up[f].min() < 0 or up[f].max() > 255:
            raise ValueError(f"multiplier {multiplier!r}: feature {f}'s weight map spans "
                             f"{up[f].min()}..{up[f].max()}, beyond uint8")
    a, b = np.arange(lhs_max + 1), np.arange(rhs_max + 1)
    want = (mul.exact_table(8, 8).astype(np.int64)
            - mul.mul8x8_table(multiplier).astype(np.int64))[:lhs_max + 1, :rhs_max + 1]
    got = c * np.einsum("fa,fb->ab", vt[:, a], up[:, b])
    if not np.array_equal(got, want):
        raise ValueError(f"multiplier {multiplier!r}: the 8-bit feature tables do not "
                         f"reconstruct its error on [0,{lhs_max}]x[0,{rhs_max}]")
    return c, vt, signed, up


def feature_tables(multiplier: str, lhs_max: int = 255, rhs_max: int = 255,
                   device="cpu") -> FeatureTables:
    """The checked 8-bit feature tables of ``multiplier`` on ``device``,
    cached per (multiplier, lhs_max, rhs_max, device); raises if they do
    not reconstruct ``exact_table - mul8x8_table`` on [0, lhs_max] x
    [0, rhs_max] or a value does not fit its 8-bit type."""
    name = multiplier.lower()
    dev = torch.device(device)
    key = (name, lhs_max, rhs_max, dev)
    if key not in _TABLES:
        c, vt, signed, up = _build_tables(name, lhs_max, rhs_max)
        nf = len(signed)
        packed = np.zeros((2, 256, 8), np.uint8)
        packed[0, :, :nf] = (vt.T & 0xFF).astype(np.uint8)
        packed[1, :, 0] = np.arange(256)
        packed[1, :, 1:nf + 1] = up.T.astype(np.uint8)
        as_u8 = lambda x: torch.from_numpy(np.ascontiguousarray(x).astype(np.uint8)).to(dev)
        _TABLES[key] = FeatureTables(c=c, v=as_u8(vt & 0xFF), v_signed=signed, u=as_u8(up),
                                     packed=as_u8(packed))
    return _TABLES[key]


@functools.lru_cache(maxsize=None)
def _fn():
    fn = library("approx_matmul").approx_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _operand(x: torch.Tensor) -> torch.Tensor:
    """Contiguous, on a 16-byte boundary (the kernel copies 16-byte chunks)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def approx_matmul(
    a_codes: torch.Tensor,
    b_codes: torch.Tensor,
    *,
    multiplier: str = "mul8x8_2",
    lhs_max: int = 255,
    rhs_max: int = 255,
) -> torch.Tensor:
    """a (..., M, K) codes x b (K, N) codes -> (..., M, N) int32 under the
    named approximate multiplier: ``sum_k LUT[a, b]``, exact on codes in
    [0, lhs_max] x [0, rhs_max].

    Like the TPU kernel (``approx_matmul_kernel_call``), the kernel uses
    the factorization pruned to those bounds, so a code above its bound
    gives an undefined result; the plain version is held to the same
    contract."""
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
    tabs = feature_tables(multiplier, lhs_max, rhs_max, a_codes.device)
    a2 = a_codes.reshape(-1, K).to(torch.uint8)
    b2 = b_codes.to(torch.uint8)
    out = torch.empty((a2.shape[0], N), dtype=torch.int32, device=a_codes.device)
    if out.numel() == 0:
        return out.reshape(*lead, M, N)
    # code 0 pads K on both sides and B's rows to 16-byte multiples: it
    # adds nothing (LUT[0][0] == 0, and every feature term vanishes there)
    Kp, ldb = -(-K // 16) * 16, -(-N // 16) * 16
    if Kp != K:
        a2 = F.pad(a2, (0, Kp - K))
    if Kp != K or ldb != N:
        b2 = F.pad(b2, (0, ldb - N, 0, Kp - K))
    a2, b2 = _operand(a2), _operand(b2)
    stream = torch.cuda.current_stream(a_codes.device).cuda_stream
    rc = _fn()(a2.data_ptr(), b2.data_ptr(), tabs.packed.data_ptr(), out.data_ptr(),
               a2.shape[0], N, Kp, ldb, tabs.num_features, tabs.num_unsigned, tabs.c, stream)
    if rc != 0:
        raise KernelLaunchError(f"approx_matmul launch failed: cudaError {rc}")
    approx_matmul.launches += 1
    return out.reshape(*lead, M, N)


approx_matmul.launches = 0
