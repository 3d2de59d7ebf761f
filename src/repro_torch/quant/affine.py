"""Unsigned 8-bit affine quantization (paper Section IV platform substrate).

The paper's multipliers are *unsigned* 8x8; real-valued tensors map onto
uint8 codes via the standard affine scheme (Jacob et al., CVPR'18):

    x ~ s * (q - z),   q = clip(round(x / s) + z, 0, qmax)

``qmax`` is configurable (< 255) to express the paper's co-optimization:
retraining weights into the (0, 31) code band means quantizing with
``qmax = 31``.

``torch.round`` rounds half to even, as ``jnp.round`` does, so codes are
bit-identical to the JAX package's on the same float input.  Every
intermediate keeps the reference's dtype: the range arithmetic runs in the
input's dtype and the scale is stored as float32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["QuantParams", "calibrate", "quantize", "dequantize"]


@dataclasses.dataclass(frozen=True)
class QuantParams:
    """Affine quantization parameters. ``scale``/``zero_point`` broadcast
    against the tensor (per-tensor: 0-dim; per-channel: shaped)."""

    scale: torch.Tensor               # float32
    zero_point: torch.Tensor          # int32, same shape as scale
    qmax: int = 255


def calibrate(
    x: torch.Tensor,
    *,
    axis: Optional[Tuple[int, ...]] = None,
    qmax: int = 255,
    eps: float = 1e-8,
) -> QuantParams:
    """Min/max affine calibration. ``axis=None`` -> per-tensor; otherwise the
    reduction axes (remaining axes are per-channel)."""
    if axis is None:
        lo, hi = x.min(), x.max()
    else:
        lo = torch.amin(x, dim=axis, keepdim=True)
        hi = torch.amax(x, dim=axis, keepdim=True)
    lo = torch.clamp(lo, max=0.0)
    hi = torch.clamp(hi, min=0.0)
    scale = torch.clamp((hi - lo) / float(qmax), min=eps).to(torch.float32)
    zp = torch.clamp(torch.round(-lo.to(torch.float32) / scale), 0, qmax)
    return QuantParams(scale=scale, zero_point=zp.to(torch.int32), qmax=qmax)


def quantize(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """Real -> uint8 codes in [0, qmax]."""
    q = torch.round(x.to(torch.float32) / qp.scale) + qp.zero_point
    return torch.clamp(q, 0, qp.qmax).to(torch.uint8)


def dequantize(q: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    return (q.to(torch.float32) - qp.zero_point.to(torch.float32)) * qp.scale
