"""Quantization-aware training utilities (the paper's retraining platform).

* ``fake_quant``: quantize->dequantize with a straight-through estimator
  (forward value quantized, gradient the identity).
* ``band_regularizer``: the paper's "retraining by regularization" — a
  penalty that pushes weight codes into a target band (e.g. (0, 31)) so
  that the aggressive MUL8x8_3 multiplier (removed M2 partial product)
  stays accurate.

Both mirror the JAX package's ``quant/qat.py`` op for op, with ``.detach()``
in place of ``stop_gradient``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.quant.affine import QuantParams

__all__ = ["fake_quant", "band_regularizer"]


def fake_quant(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """Straight-through fake-quantization: forward
    ``dequantize(quantize(x))``, backward the identity."""
    zp = qp.zero_point.to(x.dtype)
    q = torch.clamp(torch.round(x / qp.scale) + zp, 0, qp.qmax)
    fq = (q - zp) * qp.scale
    return x + (fq.to(x.dtype) - x).detach()


def band_regularizer(w: torch.Tensor, qp: QuantParams, *,
                     band: Tuple[int, int] = (0, 31)) -> torch.Tensor:
    """Mean squared excursion of weight codes outside ``band``, on the
    real-valued (unrounded) affine map so that it is differentiable."""
    lo, hi = band
    soft_code = w / qp.scale + qp.zero_point.to(w.dtype)
    under = torch.clamp(float(lo) - soft_code, min=0.0)
    over = torch.clamp(soft_code - float(hi), min=0.0)
    return torch.mean(under ** 2 + over ** 2)
