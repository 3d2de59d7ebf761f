"""Plain PyTorch version of the elementwise approximate multiplier (K3):
the gather ``LUT[a, b]`` from the multiplier's 256x256 table, as the JAX
package's ``approx_mul_eltwise/ref.py`` does.  The kernel evaluates bit
logic instead, so the two are independent derivations of one function.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import multipliers as mul

__all__ = ["approx_mul_eltwise_plain"]

_TABLES: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def _table(multiplier: str, device: torch.device) -> torch.Tensor:
    key = (multiplier, device)
    if key not in _TABLES:
        tab = torch.from_numpy(mul.mul8x8_table(multiplier).reshape(-1).copy())
        _TABLES[key] = tab.to(device=device, dtype=torch.int32)
    return _TABLES[key]


def approx_mul_eltwise_plain(a: torch.Tensor, b: torch.Tensor,
                             multiplier: str = "mul8x8_2") -> torch.Tensor:
    """``LUT[a, b]`` elementwise: uint8-valued integer tensors of one shape
    in, int32 of that shape out (an int32 input is read through its low 8
    bits, as the bit logic reads it)."""
    idx = (a.to(torch.int64) & 255) * 256 + (b.to(torch.int64) & 255)
    return _table(multiplier.lower(), a.device)[idx]
