"""ApproxConfig — the switch for the paper's technique, and the quantized
dense layer every projection routes through.

Modes (every quantized one bit-exact to the multiplier's LUT semantics):
  float       no quantization at all (fp baseline)
  exact_quant uint8 affine quantization with an exact integer matmul
  lut         the paper-faithful simulation: one gather of the multiplier's
              LUT per MAC (kernels/approx_matmul/ref.py), on either device;
              as in the JAX package it is a plain gather, not a kernel, and
              a caller picks it, it is no fallback
  lowrank     the plain exact form A@B - U(A)@V(B) (core/lowrank.py) in
              float64 — K1's plain version, on any device
  kernel      the CUDA approximate-matmul kernel (kernels/approx_matmul) for
              CUDA tensors, its plain version for CPU tensors

On a float weight ``approx_dense`` is the QAT layer of the paper's
retraining: its value is the integer simulation and its gradient flows
through a straight-through estimator (STE), written as ``.detach()``
algebra as the JAX package writes it with ``stop_gradient``.  The integer
matmul takes codes and records no graph, so no ``autograd.Function`` is
needed.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.core import multipliers as mul
from repro_torch.kernels.approx_matmul.ops import approx_matmul
from repro_torch.kernels.approx_matmul.ref import approx_matmul_lut, approx_matmul_plain
from repro_torch.quant.affine import calibrate, dequantize, quantize

__all__ = [
    "ApproxConfig",
    "Modes",
    "QWeight",
    "approx_dense",
    "concat_weights",
    "prequantize_tree",
    "quantized_matmul",
    "w_dim",
]

Modes = ("float", "exact_quant", "lut", "lowrank", "kernel")


@dataclasses.dataclass(frozen=True)
class ApproxConfig:
    """Static (hashable) configuration of the approximate-multiplier feature."""

    multiplier: str = "mul8x8_2"       # exact | mul8x8_1/2/3 | pkm | etm | mul8x8_msr*
    mode: str = "lowrank"              # one of Modes
    act_qmax: int = 255                # activation code band
    w_qmax: int = 255                  # weight code band (co-optimized: 31)
    w_per_channel: bool = True         # per-output-channel weight scales
    band_reg: float = 0.0              # weight band-regularizer strength (retraining)
    act_per_row: bool = False          # per-row (per-token) activation scales:
    #   each flattened (M, K) row calibrates independently, so a row's codes
    #   (and its outputs) do not depend on which other rows share the batch

    def __post_init__(self):
        if self.mode not in Modes:
            raise ValueError(f"mode {self.mode!r} not in {Modes}")
        if self.mode in ("lut", "lowrank", "kernel"):
            mul.mul8x8_table(self.multiplier)  # validate name

    @property
    def is_quantized(self) -> bool:
        return self.mode != "float"



def _int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer matmul of codes: float64 products and sums of uint8
    codes stay below 2**53, so the cast back to int32 is exact (CUDA has
    no int32 matmul)."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _lut(multiplier: str, device: torch.device) -> torch.Tensor:
    """The multiplier's 256 x 256 LUT as int32 on ``device``, cached."""
    return torch.from_numpy(mul.mul8x8_table(multiplier).astype(np.int32)).to(device)


def quantized_matmul(a_codes: torch.Tensor, b_codes: torch.Tensor, cfg: ApproxConfig) -> torch.Tensor:
    """Integer matmul of uint8 codes under the configured multiplier.

    a_codes: (..., M, K) in [0, act_qmax]; b_codes: (K, N) in [0, w_qmax].
    Returns (..., M, N) int32 equal (bit-exactly) to ``sum_k LUT[a, b]``."""
    if cfg.mode == "exact_quant" or cfg.multiplier == "exact":
        return _int_dot(a_codes, b_codes)
    if cfg.mode == "lut":
        return approx_matmul_lut(a_codes, b_codes, _lut(cfg.multiplier, a_codes.device))
    if cfg.mode == "lowrank":
        return approx_matmul_plain(a_codes, b_codes, multiplier=cfg.multiplier,
                                   lhs_max=cfg.act_qmax, rhs_max=cfg.w_qmax)
    if cfg.mode == "kernel":
        return approx_matmul(a_codes, b_codes, multiplier=cfg.multiplier,
                             lhs_max=cfg.act_qmax, rhs_max=cfg.w_qmax)
    raise ValueError(cfg.mode)


# ---------------------------------------------------------------------------
# Frozen pre-quantized weights (serving path)
# ---------------------------------------------------------------------------


class QWeight(NamedTuple):
    """A weight matrix frozen to uint8 codes at load time: serving reads 1
    byte per element and skips per-step weight calibration.  Stacked layer
    weights carry a leading layer axis on every field."""

    codes: torch.Tensor        # (..., K, N) uint8
    scale: torch.Tensor        # per-channel (..., 1, N) or scalar, f32
    zero_point: torch.Tensor   # int32, same shape as scale
    col_sum: torch.Tensor      # (..., 1, N) f32: sum_k codes (zero-point term)


_PREQUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")


def w_dim(w, i: int) -> int:
    """Shape accessor that works for float weights and frozen QWeights."""
    return (w.codes if isinstance(w, QWeight) else w).shape[i]


def concat_weights(ws, dim: int = -1):
    """Concatenate weights along the output-channel axis; QWeights stay
    frozen (per-channel scales concatenate losslessly)."""
    if any(isinstance(w, QWeight) for w in ws):
        if not all(isinstance(w, QWeight) for w in ws):
            raise ValueError("cannot concatenate frozen and float weights")
        def bcast(t, w):
            return t.expand(*w.col_sum.shape)
        return QWeight(
            codes=torch.cat([w.codes for w in ws], dim=dim),
            scale=torch.cat([bcast(w.scale, w) for w in ws], dim=-1),
            zero_point=torch.cat([bcast(w.zero_point, w) for w in ws], dim=-1),
            col_sum=torch.cat([w.col_sum for w in ws], dim=-1),
        )
    return torch.cat(ws, dim=dim)


def _freeze(leaf: torch.Tensor, cfg: ApproxConfig) -> QWeight:
    qp = calibrate(leaf, axis=(leaf.dim() - 2,) if cfg.w_per_channel else None,
                   qmax=cfg.w_qmax)
    codes = quantize(leaf, qp)
    return QWeight(
        codes=codes,
        scale=qp.scale,
        zero_point=qp.zero_point,
        col_sum=codes.to(torch.float32).sum(dim=-2, keepdim=True),
    )


def prequantize_tree(params: Dict[str, Any], cfg: ApproxConfig) -> Dict[str, Any]:
    """Freeze every projection weight (``wq/wk/wv/wo``, ``w_gate/w_up/
    w_down``, ``lm_head``) to a QWeight; embeddings and norms stay float."""

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, torch.Tensor) and node.dim() >= 2 and key in _PREQUANT_KEYS:
            return _freeze(node, cfg)
        return node

    return walk(params)


# ---------------------------------------------------------------------------
# Real-valued dense layer with approximate-multiplier semantics
# ---------------------------------------------------------------------------


def _act_codes(x2: torch.Tensor, cfg: ApproxConfig):
    qp_x = calibrate(x2, axis=(1,) if cfg.act_per_row else None, qmax=cfg.act_qmax)
    return qp_x, quantize(x2, qp_x)


def _zero_point_correct(raw, qx, zx, zw, col_w, K):
    """sum_k (qx - zx)(qw - zw) from the raw code dot, in the JAX package's
    f32 operation order."""
    row_x = qx.to(torch.float32).sum(dim=-1, keepdim=True)
    return raw - zx * col_w - row_x * zw + (K * zx) * zw


def approx_dense(x: torch.Tensor, w, cfg: ApproxConfig) -> torch.Tensor:
    """y = x @ w computed through the approximate-multiplier pipeline.

    x: (..., K) float; w: (K, N) float or a frozen ``QWeight``.  Quantizes
    both operands to unsigned codes (dynamic activation scale, per-channel
    weight scales), runs the configured integer multiplier, applies the
    zero-point corrections and dequantizes.

    On a float ``w`` the result is the JAX package's straight-through sum

        y = y_lin + (y_int - y_lin).detach(),   y_lin = fq(x) @ fq(w)

    in float32: its value is the integer simulation ``y_int`` (to f32
    roundoff) and its gradient is that of ``y_lin``, the product of the
    bf16-rounded fake-quantized operands.  The cotangents pass back through
    the bf16 casts, so the weight gradient is bf16-rounded as in JAX.  A
    QWeight (serving) returns ``x.dtype`` and records no graph."""
    if isinstance(w, QWeight):
        return _approx_dense_frozen(x, w, cfg)
    if cfg.mode == "float":
        return (x.to(torch.float32) @ w.to(x.dtype).to(torch.float32)).to(x.dtype)
    x2 = x.reshape(-1, x.shape[-1])
    xd, wd = x2.detach(), w.detach()
    qp_x, qx = _act_codes(xd, cfg)
    qp_w = calibrate(wd, axis=(0,) if cfg.w_per_channel else None, qmax=cfg.w_qmax)
    qw = quantize(wd, qp_w)

    # differentiable STE path: an f32 product of bf16-exact operands equals
    # the bf16 x bf16 -> f32 product up to summation order
    x_fq = x2 + (dequantize(qx, qp_x).to(x2.dtype) - x2).detach()
    w_fq = w + (dequantize(qw, qp_w).to(w.dtype) - w).detach()
    bf = torch.bfloat16
    y_lin = x_fq.to(bf).to(torch.float32) @ w_fq.to(bf).to(torch.float32)

    # integer simulation (value path, gradient-free)
    raw = quantized_matmul(qx, qw, cfg).to(torch.float32)
    col_w = qw.to(torch.float32).sum(dim=0, keepdim=True)
    acc = _zero_point_correct(raw, qx, qp_x.zero_point.to(torch.float32),
                              qp_w.zero_point.to(torch.float32), col_w, x2.shape[-1])
    y_int = acc * (qp_x.scale * qp_w.scale)

    y = y_lin + (y_int - y_lin).detach()
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _approx_dense_frozen(x: torch.Tensor, w: QWeight, cfg: ApproxConfig) -> torch.Tensor:
    """Inference dense against frozen uint8 weight codes (no calibration of
    w) — the serving path."""
    x2 = x.reshape(-1, x.shape[-1])
    qp_x, qx = _act_codes(x2, cfg)
    raw = quantized_matmul(qx, w.codes, cfg).to(torch.float32)
    acc = _zero_point_correct(raw, qx, qp_x.zero_point.to(torch.float32),
                              w.zero_point.to(torch.float32), w.col_sum, x2.shape[-1])
    y = acc * (qp_x.scale * w.scale)
    return y.reshape(*x.shape[:-1], w.codes.shape[-1]).to(x.dtype)
