"""Serving-level names for the multiplier pipeline, weight freezing, and
token selection.

Sampling: greedy (``temperature <= 0``) is argmax with the first index on
ties, as in the JAX package — the cross-framework contract.  Temperature
sampling uses the port's own positional key schedule: the token at
position ``p`` of request ``r`` in a session seeded ``s`` is the Gumbel-max
draw over Philox4x32-10 uniforms keyed by ``(s, r)`` with counter ``(p,
vocab index)``.  A token therefore depends only on the request, its
position and its logits — never on the slot or on what else is in flight —
and the draw is the same on the CPU and on the card.  (``jax.random``'s
``fold_in`` keys have no torch twin, so temperature outputs are held to
this contract within the port only.)
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.approx import ApproxConfig, prequantize_tree
from repro_torch.core.multipliers import MSR_SPECS

__all__ = [
    "EXECUTION_MODES",
    "SamplingConfig",
    "freeze_params",
    "philox_uniform",
    "resolve_execution_mode",
    "select_token",
]

EXECUTION_MODES = ("exact", "exact_quant", "approx", "approx_lowrank", "approx_msr")


def resolve_execution_mode(
    mode: str, multiplier: str = "mul8x8_2", *, act_per_row: bool = False
) -> ApproxConfig:
    """Map a serving execution mode onto an ``ApproxConfig``.

    exact          float matmuls (baseline)
    exact_quant    uint8 affine quantization, exact integer matmul
    approx         named approximate multiplier through the CUDA kernel
                   (``mode="kernel"``; its plain version for CPU tensors)
    approx_lowrank same semantics via the plain exact decomposition
    approx_msr     the fixed-shift MSR family through the same kernel
                   (default rung ``mul8x8_msr4`` unless an MSR name is given)
    """
    if mode == "exact":
        return ApproxConfig(mode="float")
    if mode == "exact_quant":
        return ApproxConfig(multiplier="exact", mode="exact_quant", act_per_row=act_per_row)
    if mode == "approx":
        return ApproxConfig(multiplier=multiplier, mode="kernel", act_per_row=act_per_row)
    if mode == "approx_lowrank":
        return ApproxConfig(multiplier=multiplier, mode="lowrank", act_per_row=act_per_row)
    if mode == "approx_msr":
        msr = multiplier if multiplier in MSR_SPECS else "mul8x8_msr4"
        return ApproxConfig(multiplier=msr, mode="kernel", act_per_row=act_per_row)
    raise ValueError(f"execution mode {mode!r} not in {EXECUTION_MODES}")


def freeze_params(cfg: ModelConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """Pre-quantize projection weights to frozen uint8 ``QWeight``s for
    serving (no-op for float execution)."""
    if not cfg.approx.is_quantized:
        return params
    return prequantize_tree(params, cfg.approx)


class SamplingConfig(NamedTuple):
    """temperature <= 0 selects greedy argmax; top_k == 0 disables top-k
    filtering; eos_id < 0 disables stop-on-eos."""

    temperature: float = 0.0
    top_k: int = 0
    eos_id: int = -1


_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of a * b for a 32-bit constant and a tensor
    of 32-bit values held in int64 (split so no product overflows)."""
    p0 = a * (b & 0xFFFF)
    p1 = a * (b >> 16)
    t = p0 + ((p1 & 0xFFFF) << 16)
    return (t >> 32) + (p1 >> 16), t & _MASK32


def philox_uniform(key0: torch.Tensor, key1: torch.Tensor, ctr0: torch.Tensor,
                   ctr1: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 on broadcastable int64 tensors of 32-bit key/counter
    words (the two upper counter words are 0); the first output word as a
    float64 uniform in (0, 1)."""
    c0, c1 = ctr0 & _MASK32, ctr1 & _MASK32
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = key0 & _MASK32, key1 & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return (c0.to(torch.float64) + 0.5) / 2.0**32


def select_token(
    logits: torch.Tensor,          # (B, V) float32
    sampling: SamplingConfig,
    *,
    seed: int = 0,
    req_ids: torch.Tensor = None,  # (B,) request ids (temperature only)
    positions: torch.Tensor = None,  # (B,) position of the sampled token
) -> torch.Tensor:
    """(B, V) logits -> (B,) int64 next tokens."""
    if sampling.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = logits / sampling.temperature
    if sampling.top_k > 0:
        kth = torch.topk(scaled, sampling.top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, torch.full_like(scaled, -1e30), scaled)
    V = logits.shape[-1]
    u = philox_uniform(
        torch.full_like(req_ids.long(), seed)[:, None], req_ids.long()[:, None],
        positions.long()[:, None], torch.arange(V, device=logits.device)[None, :],
    )
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(scaled.to(torch.float64) + gumbel, dim=-1)
