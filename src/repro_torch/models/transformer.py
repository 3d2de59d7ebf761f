"""Dense decoder stack (pre-RMSNorm GQA + SwiGLU FFN): the training and
prefill forward, one-token decode on the slot layout (a per-row
``max_len`` stripe) and on the paged pool, and the multi-token pass over
the paged pool (speculative verification, chunked prefill).

Parameters are a dict with the JAX package's tree shape: layer weights are
stacked on a leading layer axis under ``params["layers"]`` and the loop
below walks them (the JAX package scans them).  Under autograd with
``cfg.remat`` each layer runs under ``torch.utils.checkpoint``, as the JAX
package wraps its scan body in ``jax.checkpoint``.  Both decode steps
and the multi-token pass update their cache in place and return the
logits only (the JAX package returns a new cache).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.approx import ApproxConfig, QWeight
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.attention import (
    decode_attention,
    paged_decode_attention,
    paged_verify_attention,
    seed_kv_cache,
    self_attention,
)

__all__ = [
    "init_params",
    "forward",
    "init_cache",
    "seed_cache",
    "decode_step",
    "cache_max_len",
    "init_paged_cache",
    "paged_decode_step",
    "paged_verify_step",
    "paged_chunk_prefill_step",
    "params_to",
]


def _ffn(x, p: Dict[str, Any], cfg: ApproxConfig):
    h = F.silu(L.dense(x, p["w_gate"], cfg)) * L.dense(x, p["w_up"], cfg)
    return L.dense(h, p["w_down"], cfg)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None) -> Dict[str, Any]:
    """Random float32 master weights at the config's widths from a seeded
    ``torch.Generator`` on ``device``, with the JAX package's init
    (truncated normal, std 1/sqrt(fan_in); norms at one).  For runs
    without JAX; the tests bring the JAX package's own weights across with
    ``bridge.params_from_numpy`` instead.  ``device`` defaults to the CUDA
    device (raising without one)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, Lyr, ff = cfg.d_model, cfg.num_layers, cfg.d_ff
    hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def stacked(d_in, d_out):
        return torch.stack([L.init_dense(d_in, d_out, gen, dev) for _ in range(Lyr)])

    return {
        "layers": {
            "ln1": torch.ones((Lyr, d), device=dev),
            "ln2": torch.ones((Lyr, d), device=dev),
            "attn": {"wq": stacked(d, hq), "wk": stacked(d, hkv),
                     "wv": stacked(d, hkv), "wo": stacked(hq, d)},
            "ffn": {"w_gate": stacked(d, ff), "w_up": stacked(d, ff),
                    "w_down": stacked(ff, d)},
        },
        "embed": L.truncated_normal_init((cfg.vocab_size, d), gen, device=dev),
        "final_norm": torch.ones((d,), device=dev),
        "lm_head": L.init_dense(d, cfg.padded_vocab, gen, dev),
    }


def _layers(node, n: int):
    """The stacked layer tree as a list of ``n`` per-layer trees (views).
    Under autograd the backward of ``unbind`` stacks the per-layer weight
    gradients once, where indexing would add one zero-padded full-size
    gradient per layer."""
    if isinstance(node, dict):
        per = {k: _layers(v, n) for k, v in node.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    if isinstance(node, QWeight):
        fields = [t.unbind(0) if t.dim() > 0 else (t,) * n for t in node]
        return [QWeight(*(f[i] for f in fields)) for i in range(n)]
    return list(node.unbind(0))


# ---------------------------------------------------------------------------
# Forward (training and prefill)
# ---------------------------------------------------------------------------


def _attn_block(cfg: ModelConfig, x, layer):
    h, kv = self_attention(
        L.rms_norm(x, layer["ln1"]), layer["attn"],
        n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, cfg=cfg.approx,
        rope_theta=cfg.rope_theta,
    )
    x = x + h
    x = x + _ffn(L.rms_norm(x, layer["ln2"]), layer["ffn"], cfg.approx)
    return x, kv


def _block_out(cfg: ModelConfig, x, layer):
    return _attn_block(cfg, x, layer)[0]


def forward(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor, *,
            return_kv: bool = False):
    """tokens (B, S) -> logits (B, S, Vp) float32, plus with ``return_kv``
    the stacked (L, B, S, Hkv, hd) post-rope K and V — the fused-prefill
    cache seed.  Differentiable in float parameters; the dense family has
    no auxiliary loss (the JAX package's ``aux`` is 0 here)."""
    x = F.embedding(tokens.long(), params["embed"]).to(getattr(torch, cfg.dtype))
    remat = cfg.remat and torch.is_grad_enabled() and not return_kv
    ks, vs = [], []
    for layer in _layers(params["layers"], cfg.num_layers):
        if remat:
            x = checkpoint(_block_out, cfg, x, layer, use_reentrant=False)
            continue
        x, (k, v) = _attn_block(cfg, x, layer)
        if return_kv:
            ks.append(k)
            vs.append(v)
    logits = _head(cfg, params, x)
    if return_kv:
        return logits, (torch.stack(ks), torch.stack(vs))
    return logits


# ---------------------------------------------------------------------------
# Slot-layout decode
# ---------------------------------------------------------------------------


def _dense_family_only(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{what} for the {cfg.family} family: its conv/ssm decode state "
            "arrives with the MoE, SSM and hybrid slice of the port (ROADMAP "
            "section 1, item 9)"
        )


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32, *,
               device=None) -> Dict[str, torch.Tensor]:
    """Slot-layout KV cache: one ``max_len`` stripe per batch row, plus one
    trash position at index ``max_len`` that absorbs the writes the JAX
    package's scatter drops (a ``cur_len`` at or past ``max_len``).  Leaves
    are (L, batch, max_len + 1, Hkv, hd); attention never reads the trash
    position."""
    _dense_family_only(cfg, "init_cache")
    shape = (cfg.num_layers, batch, max_len + 1, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_max_len(cfg: ModelConfig, cache: Dict[str, torch.Tensor]) -> int:
    """The positions an ``init_cache`` stripe holds (its trash position aside)."""
    return cache["k"].shape[2] - 1


def seed_cache(cfg: ModelConfig, cache: Dict[str, torch.Tensor], kvs) -> None:
    """Write fused-prefill K/V (from ``forward(..., return_kv=True)``, each
    (L, B, S0, Hkv, hd)) into positions [0, S0) of every layer IN PLACE."""
    k, v = kvs
    for i in range(cfg.num_layers):
        seed_kv_cache(cache["k"][i], cache["v"][i], k[i], v[i])


def decode_step(
    cfg: ModelConfig,
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,               # (B, 1)
    cur_len: torch.Tensor,              # (B,)
) -> torch.Tensor:
    """One-token decode against an ``init_cache`` stripe: each row writes
    its new K/V at its ``cur_len`` and attends over positions
    ``[0, cur_len]``.  Writes the cache in place; returns logits (B, 1, Vp)
    float32."""
    _dense_family_only(cfg, "decode_step")
    x = params["embed"][tokens.long()].to(getattr(torch, cfg.dtype))
    a = cfg.approx
    for i, layer in enumerate(_layers(params["layers"], cfg.num_layers)):
        h = decode_attention(
            L.rms_norm(x, layer["ln1"]), layer["attn"], cache["k"][i], cache["v"][i],
            cur_len, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, cfg=a,
            rope_theta=cfg.rope_theta,
        )
        x = _decode_mlp(cfg, x + h, layer, a)
    return _head(cfg, params, x)


# ---------------------------------------------------------------------------
# Paged decode
# ---------------------------------------------------------------------------


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=torch.float32, *, device=None) -> Dict[str, torch.Tensor]:
    """Paged KV pool: ``num_blocks`` fixed-size blocks per layer, plus one
    trash block at index ``num_blocks`` that absorbs the writes the JAX
    package's scatters drop (sentinel table entries, rows past their
    table).  Leaves are (L, num_blocks + 1, block_size, Hkv, hd); nothing
    ever reads the trash block."""
    shape = (cfg.num_layers, num_blocks + 1, block_size, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _decode_mlp(cfg: ModelConfig, x, layer, a: ApproxConfig):
    return x + _ffn(L.rms_norm(x, layer["ln2"]), layer["ffn"], a)


def paged_decode_step(
    cfg: ModelConfig,
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,               # (B, 1)
    cur_len: torch.Tensor,              # (B,)
    block_tables: torch.Tensor,         # (B, W) int32
    *,
    block_size: int,
    attn_impl: str = "kernel",
) -> torch.Tensor:
    """One-token decode against an ``init_paged_cache`` pool: each row's
    K/V reads and the new token's write go through its block table (shared
    by every layer).  Writes the pool in place; returns logits (B, 1, Vp)
    float32."""
    x = params["embed"][tokens.long()].to(getattr(torch, cfg.dtype))
    a = cfg.approx
    for i, layer in enumerate(_layers(params["layers"], cfg.num_layers)):
        h = paged_decode_attention(
            L.rms_norm(x, layer["ln1"]), layer["attn"],
            cache["k"][i], cache["v"][i], block_tables, cur_len,
            block_size=block_size, n_heads=cfg.num_heads,
            n_kv=cfg.num_kv_heads, cfg=a, rope_theta=cfg.rope_theta,
            attn_impl=attn_impl,
        )
        x = _decode_mlp(cfg, x + h, layer, a)
    return _head(cfg, params, x)


# ---------------------------------------------------------------------------
# Multi-token paged pass: speculative verification and chunked prefill
# ---------------------------------------------------------------------------


def _norm_per_position(x, gamma):
    """``rms_norm`` of each position's (B, 1, d) slice.  A CUDA reduction
    picks its thread layout from the number of rows it reduces, so one norm
    over B*S rows would sum each row in another order than a decode step's
    norm over B rows; S norms of B rows keep the multi-token pass
    bit-identical to S decode steps."""
    return torch.cat([L.rms_norm(x[:, j:j + 1], gamma) for j in range(x.shape[1])], dim=1)


def paged_verify_step(
    cfg: ModelConfig,
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,               # (B, S)
    cur_len: torch.Tensor,              # (B,) position of the first token
    block_tables: torch.Tensor,         # (B, W) int32
    *,
    block_size: int,
) -> torch.Tensor:
    """Score ``S`` consecutive tokens per row against the paged pool in one
    pass: row ``b``'s token ``j`` sits at position ``cur_len[b] + j``.
    Returns logits (B, S, Vp) float32: ``logits[:, j]`` is what a
    sequential ``paged_decode_step(attn_impl="gather")`` at ``cur_len + j``
    would give, bit for bit where the projections are (per-row activation
    scales, or float matmuls that do not depend on the row count), and the
    pool holds this pass's K/V at ``[cur_len, cur_len + S)``, written in
    place.  Projections run batched over the S positions; norms and
    attention run per position (``paged_verify_attention``).

    Dense family only: MoE routing is capacity-coupled across the token
    batch, so a (B*S)-token pass would route differently than B sequential
    single-token steps."""
    if cfg.family == "moe":
        raise NotImplementedError(
            "moe routing is capacity-coupled across the token batch — a "
            "batched verify pass routes differently than sequential decode, "
            "breaking the speculative acceptance contract"
        )
    _dense_family_only(cfg, "paged_verify_step")
    x = params["embed"][tokens.long()].to(getattr(torch, cfg.dtype))
    a = cfg.approx
    for i, layer in enumerate(_layers(params["layers"], cfg.num_layers)):
        h = paged_verify_attention(
            _norm_per_position(x, layer["ln1"]), layer["attn"],
            cache["k"][i], cache["v"][i], block_tables, cur_len,
            block_size=block_size, n_heads=cfg.num_heads,
            n_kv=cfg.num_kv_heads, cfg=a, rope_theta=cfg.rope_theta,
        )
        x = x + h
        x = x + _ffn(_norm_per_position(x, layer["ln2"]), layer["ffn"], a)
    return _head(cfg, params, x, norm=_norm_per_position)


def paged_chunk_prefill_step(
    cfg: ModelConfig,
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,               # (B, C) one chunk of each prompt
    prefill_pos: torch.Tensor,          # (B,) tokens already prefilled
    block_tables: torch.Tensor,         # (B, W) int32, sentinel-tailed
    *,
    block_size: int,
) -> torch.Tensor:
    """Teacher-force one (B, C) chunk of each row's prompt into the pool at
    positions ``[prefill_pos, prefill_pos + C)``, reading the prefix
    already written through the block table.  This IS ``paged_verify_step``:
    table entries covering ``[0, prefill_pos + C)`` must name real blocks,
    tail entries may still be the sentinel (their writes land in the trash
    block and no horizon reaches them), so N chunks write the pool and
    give the logits of one pass over the whole prompt, bit for bit.  The
    same family gates as the verify pass."""
    return paged_verify_step(cfg, params, cache, tokens, prefill_pos, block_tables,
                             block_size=block_size)


def _mask_pad(cfg: ModelConfig, logits):
    """-1e30 on padded vocab columns (additive, in the logits' dtype)."""
    V, Vp = cfg.vocab_size, cfg.padded_vocab
    if Vp == V:
        return logits
    neg = torch.where(torch.arange(Vp, device=logits.device) < V, 0.0, -1e30)
    return logits + neg.to(logits.dtype)


def _head(cfg: ModelConfig, params, x, norm=L.rms_norm):
    x = norm(x, params["final_norm"])
    return _mask_pad(cfg, L.dense(x, params["lm_head"], cfg.approx)).to(torch.float32)


def params_to(node, device):
    """The parameter tree (float tensors and QWeights) on ``device``."""
    if isinstance(node, dict):
        return {k: params_to(v, device) for k, v in node.items()}
    if isinstance(node, QWeight):
        return QWeight(*(t.to(device) for t in node))
    return node.to(device)
