"""Shared layers.  Every projection routes through ``dense``, which applies
the approximate-multiplier pipeline when configured."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.approx import ApproxConfig, QWeight, approx_dense

__all__ = [
    "dense",
    "init_dense",
    "rms_norm",
    "rotary",
    "apply_rope",
    "truncated_normal_init",
]


def truncated_normal_init(shape, generator: torch.Generator, scale: float = 1.0,
                          device: Optional[torch.device] = None) -> torch.Tensor:
    """std = scale / sqrt(fan_in) times a standard normal truncated to
    [-2, 2] — the JAX package's init, drawn from a torch.Generator."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * (scale / math.sqrt(fan_in))


def init_dense(d_in: int, d_out: int, generator: torch.Generator,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return truncated_normal_init((d_in, d_out), generator, device=device)


def dense(x: torch.Tensor, w, cfg: ApproxConfig) -> torch.Tensor:
    """x (..., K) @ w (K, N) under the configured multiplier semantics;
    ``w`` may be a frozen ``QWeight`` (serving path)."""
    if isinstance(w, QWeight) or cfg.mode != "float":
        return approx_dense(x, w, cfg).to(x.dtype)
    return x @ w.to(x.dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * gamma.to(x.dtype)


def rotary(positions: torch.Tensor, dim: int, theta: float = 10000.0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables, (..., dim//2)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def _rope_rotate(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(q, k, positions, theta: float = 10000.0):
    """q/k: (B, S, H, hd); positions: (B, S)."""
    cos, sin = rotary(positions, q.shape[-1], theta)       # (B, S, hd/2)
    cos = cos[:, :, None, :].to(q.dtype)
    sin = sin[:, :, None, :].to(q.dtype)
    return _rope_rotate(q, cos, sin), _rope_rotate(k, cos, sin)
