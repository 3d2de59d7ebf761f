"""Batched generation on the slot layout, serving-level names for the
multiplier pipeline, weight freezing, and token selection.

``generate`` seeds a ``max_len`` KV stripe per row with a fused prefill
(one ``forward(return_kv=True)`` pass) or a teacher-forced one (the
prompt through ``decode_step``), then decodes ``max_new - 1`` more tokens.
The JAX package compiles all of it into one program (a ``lax.scan`` over
the decode steps); the port runs the same steps as a Python loop of
``decode_step`` calls on the device, with no host synchronisation inside
the loop.  ``greedy_generate_legacy`` keeps the JAX package's original
per-token loop as the parity oracle and baseline.

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

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.approx import ApproxConfig, prequantize_tree
from repro_torch.core.multipliers import MSR_SPECS
from repro_torch.device import resolve_device
from repro_torch.models.transformer import (
    decode_step,
    forward,
    fuse_params,
    init_cache,
    params_to,
    seed_cache,
)

__all__ = [
    "EXECUTION_MODES",
    "GenerationState",
    "SamplingConfig",
    "draft_config",
    "freeze_params",
    "generate",
    "greedy_generate",
    "greedy_generate_legacy",
    "philox_uniform",
    "prefill_step",
    "resolve_execution_mode",
    "select_token",
    "serve_step",
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


def draft_config(cfg: ModelConfig, draft_mode: str,
                 multiplier: str = "mul8x8_2") -> ModelConfig:
    """The self-speculative DRAFT model's config: the verifier's ``cfg``
    with only ``approx`` swapped for ``draft_mode``'s pipeline.  Draft and
    verifier share every weight; only the path of the projection matmuls
    differs (``layers.dense`` reads ``cfg.approx`` per call), so the accept
    rate a session measures is an end-to-end readout of ``multiplier``'s
    error rate.  ``draft_mode`` may be any execution mode, the verifier's
    own included (a self-test: every drafted token is then accepted).  The
    draft keeps the verifier's ``act_per_row`` (the JAX package's draft
    always scales per tensor; its verifiers do too, as no JAX entry point
    serves per-row scales outside its tiers), so a per-row verifier's
    self-test drafts with the verifier's own arithmetic."""
    return dataclasses.replace(cfg, approx=resolve_execution_mode(
        draft_mode, multiplier, act_per_row=cfg.approx.act_per_row))


def freeze_params(cfg: ModelConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """Pre-quantize projection weights to frozen uint8 ``QWeight``s for
    serving, with the fused leaves of ``cfg.fuse_qkv``/``fuse_gate_up``
    built once (``transformer.fuse_params``); a no-op for float
    execution."""
    if not cfg.approx.is_quantized:
        return params
    return fuse_params(cfg, prequantize_tree(params, cfg.approx))


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


# ---------------------------------------------------------------------------
# Generation on the slot layout
# ---------------------------------------------------------------------------


def prefill_step(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward: (B, S) tokens -> (B, S, Vp) logits."""
    return forward(cfg, params, tokens)


def serve_step(cfg: ModelConfig, params, cache: Dict[str, torch.Tensor],
               tokens: torch.Tensor, cur_len: torch.Tensor) -> torch.Tensor:
    """One decode step: (B, 1) tokens -> (B, 1, Vp) logits; the cache is
    written in place."""
    return decode_step(cfg, params, cache, tokens, cur_len)


class GenerationState(NamedTuple):
    """What one decode step carries to the next (the JAX package's scan
    carry, less its PRNG key: the port's sampling keys are positional)."""

    cache: Dict[str, torch.Tensor]   # transformer.init_cache leaves, written in place
    cur_len: torch.Tensor            # (B,) next cache write position
    last_token: torch.Tensor         # (B,) token to feed next step
    done: torch.Tensor               # (B,) bool: row hit eos (masking, not exit)


def _prefill_fused(cfg: ModelConfig, params, prompt: torch.Tensor, cache) -> torch.Tensor:
    """One full-sequence pass: last-position logits, and the cache seeded."""
    logits, kvs = forward(cfg, params, prompt, return_kv=True)
    seed_cache(cfg, cache, kvs)
    return logits[:, -1, :]


def _prefill_decode(cfg: ModelConfig, params, prompt: torch.Tensor, cache) -> torch.Tensor:
    """Teacher-forced prefill: the prompt one position at a time through
    ``decode_step`` (bit-identical to step-wise decode)."""
    B, S0 = prompt.shape
    cur = torch.zeros((B,), dtype=torch.long, device=prompt.device)
    last = None
    for i in range(S0):
        last = decode_step(cfg, params, cache, prompt[:, i:i + 1], cur)[:, 0, :]
        cur = cur + 1
    return last


def _sample(logits, sampling: SamplingConfig, seed: int, positions) -> torch.Tensor:
    """Row ``b``'s token at ``positions[b]``, keyed by (seed, b, position)."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    return select_token(logits, sampling, seed=seed, req_ids=rows, positions=positions)


@torch.no_grad()
def generate(
    cfg: ModelConfig,
    params,
    prompt_tokens,                   # (B, S0) int token ids
    *,
    max_new: int = 16,
    sampling: Optional[SamplingConfig] = None,
    max_len: Optional[int] = None,
    cache_dtype: torch.dtype = torch.float32,
    seed: int = 0,
    prefill_mode: str = "fused",     # fused | decode
    device=None,
) -> torch.Tensor:
    """Batched generation on the slot layout.

    Returns (B, S0 + max_new) int64 tokens on ``device`` (prompt included);
    rows that hit ``sampling.eos_id`` are padded with it.
    ``prefill_mode="decode"`` teacher-forces the prompt through the decode
    path (the ssm and hybrid families always do, as in the JAX package:
    their conv/ssm state has no fused seeding); ``"fused"`` seeds the cache
    in one full-sequence pass.  The JAX
    package compiles this into one program; here it is a Python loop of
    ``decode_step`` calls, issued without waiting on the device.  Temperature
    sampling draws row ``b``'s token at position ``p`` from the positional
    Philox schedule keyed by (``seed``, ``b``, ``p``), not from
    ``jax.random.split``, so it is held to the JAX package in distribution
    only.  ``params`` move to ``device`` (default: the CUDA device; without
    one, this raises)."""
    if not cfg.embed_input:
        raise ValueError(f"{cfg.name}: token generation requires an embed-input arch")
    if prefill_mode not in ("fused", "decode"):
        raise ValueError(f"prefill_mode {prefill_mode!r} not in ('fused', 'decode')")
    sampling = sampling if sampling is not None else SamplingConfig()
    if max_new < 1:
        raise ValueError(f"max_new must be >= 1, got {max_new}")
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt_tokens, device=dev).long()
    B, S0 = prompt.shape
    max_len = max_len or (S0 + max_new)
    if max_len < S0 + max_new:
        raise ValueError(f"max_len={max_len} < prompt_len + max_new = {S0 + max_new}")
    if cfg.family in ("ssm", "hybrid"):
        prefill_mode = "decode"
    params = fuse_params(cfg, params_to(params, dev))
    cache = init_cache(cfg, B, max_len, cache_dtype, device=dev)
    prefill = _prefill_fused if prefill_mode == "fused" else _prefill_decode
    last_logits = prefill(cfg, params, prompt, cache)

    eos = sampling.eos_id
    cur = torch.full((B,), S0, dtype=torch.long, device=dev)
    tok0 = _sample(last_logits, sampling, seed, cur)
    state = GenerationState(cache, cur, tok0, tok0 == eos if eos >= 0 else
                            torch.zeros((B,), dtype=torch.bool, device=dev))
    new_tokens = [tok0]
    for _ in range(max_new - 1):
        logits = decode_step(cfg, params, state.cache, state.last_token[:, None],
                             state.cur_len)
        # the sampled token lands at position cur_len + 1
        tok = _sample(logits[:, 0, :], sampling, seed, state.cur_len + 1)
        done = state.done
        if eos >= 0:
            tok = torch.where(done, torch.full_like(tok, eos), tok)
            done = done | (tok == eos)
        state = GenerationState(state.cache, state.cur_len + 1, tok, done)
        new_tokens.append(tok)
    return torch.cat([prompt, torch.stack(new_tokens, dim=1)], dim=1)


def greedy_generate(cfg: ModelConfig, params, prompt_tokens, *, max_new: int = 16,
                    max_len: Optional[int] = None, dtype: torch.dtype = torch.float32,
                    device=None) -> torch.Tensor:
    """Historical entry point: batched greedy decoding through ``generate``."""
    return generate(cfg, params, prompt_tokens, max_new=max_new, max_len=max_len,
                    cache_dtype=dtype, device=device)


@torch.no_grad()
def greedy_generate_legacy(cfg: ModelConfig, params, prompt_tokens, *, max_new: int = 16,
                           max_len: Optional[int] = None,
                           dtype: torch.dtype = torch.float32,
                           device=None) -> torch.Tensor:
    """The JAX package's original per-token loop: one ``serve_step`` per
    prompt position (teacher-forced prefill), then one per new token,
    greedy.  Kept as the parity oracle and baseline of ``generate``."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt_tokens, device=dev).long()
    B, S0 = prompt.shape
    max_len = max_len or (S0 + max_new)
    params = fuse_params(cfg, params_to(params, dev))
    cache = init_cache(cfg, B, max_len, dtype, device=dev)
    tok = torch.argmax(_prefill_decode(cfg, params, prompt, cache), dim=-1)[:, None]
    cur = torch.full((B,), S0, dtype=torch.long, device=dev)
    out = [prompt]
    for _ in range(max_new - 1):
        out.append(tok)
        last = serve_step(cfg, params, cache, tok, cur)
        cur = cur + 1
        tok = torch.argmax(last[:, -1], dim=-1)[:, None]
    out.append(tok)
    return torch.cat(out, dim=1)
