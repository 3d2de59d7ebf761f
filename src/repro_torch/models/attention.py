"""Grouped-query attention: exact causal attention for prefill, and one
decode step against either KV layout: the slot layout's per-row
``max_len`` stripe (``decode_attention``) or the paged pool
(``paged_decode_attention``).

K/V are never head-repeated: scores use grouped einsums (q reshaped to
(B, S, Hkv, group, hd)).  All projections route through ``layers.dense``;
the score/AV einsums stay exact float (plain ``einsum``/``softmax``, as the
JAX package leaves them to XLA).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.approx import ApproxConfig, w_dim
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_plain
from repro_torch.models import layers as L

__all__ = [
    "ATTN_IMPLS",
    "attention_core",
    "self_attention",
    "seed_kv_cache",
    "decode_attention",
    "paged_decode_attention",
]

_NEG = -1e30

# paged decode-attention implementations: the CUDA kernel (K2; its plain
# version for CPU tensors) and the clamp-gather-mask plain version on any
# device — the parity oracle
ATTN_IMPLS = ("kernel", "gather")


def attention_core(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, Sk, Hkv, hd)
    v: torch.Tensor,            # (B, Sk, Hkv, hd)
    *,
    causal: bool,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,   # (B,) valid cache lengths
) -> torch.Tensor:
    """Exact-softmax GQA with f32 scores and accumulation; out in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    qt = (q * scale.to(q.dtype).to(q.device)).reshape(B, Sq, Hkv, g, hd)
    scores = torch.einsum("bchgd,bkhd->bhgck", qt.float(), k.float())
    kv_pos = torch.arange(Sk, device=q.device)
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        neg = torch.where(q_pos[:, None] >= kv_pos, 0.0, _NEG)
        scores = scores + neg
    if kv_len is not None:
        neg = torch.where(kv_pos[None, :] < kv_len[:, None], 0.0, _NEG)
        scores = scores + neg[:, None, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgck,bkhd->bchgd", probs.float(), v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def self_attention(
    x: torch.Tensor,                 # (B, S, d)
    p: Dict[str, object],
    *,
    n_heads: int,
    n_kv: int,
    cfg: ApproxConfig,
    rope_theta: float = 10000.0,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Prefill self-attention at positions 0..S-1.  Returns (out, (k, v))
    so the caller can seed the decode cache (k post-rope)."""
    B, S, _ = x.shape
    hd = w_dim(p["wq"], -1) // n_heads
    q = L.dense(x, p["wq"], cfg).reshape(B, S, n_heads, hd)
    k = L.dense(x, p["wk"], cfg).reshape(B, S, n_kv, hd)
    v = L.dense(x, p["wv"], cfg).reshape(B, S, n_kv, hd)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    q, k = L.apply_rope(q, k, positions, theta=rope_theta)
    out = attention_core(q, k, v, causal=True)
    out = L.dense(out.reshape(B, S, n_heads * hd), p["wo"], cfg)
    return out, (k, v)


def _decode_qkv(x, p, cur_len, *, n_heads, n_kv, cfg, rope_theta):
    """Project the new token's q/k/v and rotate q/k at each row's cur_len."""
    B = x.shape[0]
    hd = w_dim(p["wq"], -1) // n_heads
    q = L.dense(x, p["wq"], cfg).reshape(B, 1, n_heads, hd)
    k = L.dense(x, p["wk"], cfg).reshape(B, 1, n_kv, hd)
    v = L.dense(x, p["wv"], cfg).reshape(B, 1, n_kv, hd)
    q, k = L.apply_rope(q, k, cur_len[:, None], theta=rope_theta)
    return q, k, v


def seed_kv_cache(
    k_cache: torch.Tensor,           # (B, Smax + 1, Hkv, hd) one layer
    v_cache: torch.Tensor,
    k: torch.Tensor,                 # (B, S0, Hkv, hd) prefill keys (post-rope)
    v: torch.Tensor,
) -> None:
    """Write one layer's prefill K/V into positions [0, S0) of its decode
    stripe IN PLACE.  The K that ``self_attention`` returns is already
    rotated at positions 0..S0-1, which is what ``decode_attention`` would
    have written step by step, so the fused and the teacher-forced prefill
    seed the same stripe."""
    S0 = k.shape[1]
    k_cache[:, :S0] = k.to(k_cache.dtype)
    v_cache[:, :S0] = v.to(v_cache.dtype)


def decode_attention(
    x: torch.Tensor,                 # (B, 1, d)
    p: Dict[str, object],
    k_cache: torch.Tensor,           # (B, Smax + 1, Hkv, hd) one layer
    v_cache: torch.Tensor,
    cur_len: torch.Tensor,           # (B,) current lengths (new token index)
    *,
    n_heads: int,
    n_kv: int,
    cfg: ApproxConfig,
    rope_theta: float = 10000.0,
) -> torch.Tensor:
    """One decode step on the slot layout: write the new K/V at each row's
    ``cur_len`` IN PLACE, then attend over the stripe with ``kv_len =
    cur_len + 1`` (the plain ``attention_core``, as the JAX package leaves
    this step to XLA).

    The stripe's last position (index ``Smax``, see
    ``transformer.init_cache``) is a trash column: a row whose ``cur_len``
    is at or past ``Smax`` writes there, which is what the JAX package's
    scatter does with such a write (it drops it), where torch would refuse
    the index.  Attention reads only the first ``Smax`` positions, all of
    them valid for such a row, as in the JAX package."""
    B = x.shape[0]
    q, k, v = _decode_qkv(x, p, cur_len, n_heads=n_heads, n_kv=n_kv, cfg=cfg,
                          rope_theta=rope_theta)
    hd = q.shape[3]
    smax = k_cache.shape[1] - 1
    rows = torch.arange(B, device=x.device)
    pos = cur_len.long().clamp(max=smax)
    k_cache[rows, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, pos] = v[:, 0].to(v_cache.dtype)
    out = attention_core(q, k_cache[:, :smax], v_cache[:, :smax], causal=False,
                         kv_len=cur_len + 1)
    return L.dense(out.reshape(B, 1, n_heads * hd), p["wo"], cfg)


def paged_decode_attention(
    x: torch.Tensor,                 # (B, 1, d)
    p: Dict[str, object],
    k_blocks: torch.Tensor,          # (num_blocks + 1, block_size, Hkv, hd) one layer
    v_blocks: torch.Tensor,
    block_table: torch.Tensor,       # (B, W) int32 physical block ids
    cur_len: torch.Tensor,           # (B,) current lengths (new token index)
    *,
    block_size: int,
    n_heads: int,
    n_kv: int,
    cfg: ApproxConfig,
    rope_theta: float = 10000.0,
    attn_impl: str = "kernel",
) -> torch.Tensor:
    """One decode step against the paged pool: attend over row b's blocks
    through its table with the new token fused at ``cur_len``, then write
    the new K/V into the pool IN PLACE for the next step.

    The pool's last block (index ``num_blocks``, see
    ``transformer.init_paged_cache``) is a trash row: a row whose position
    falls past its table, or whose table entry is the sentinel, writes
    there — the JAX package drops such scatters, and torch would refuse the
    out-of-range index.  Attention reads only the first ``num_blocks``."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
    B = x.shape[0]
    q, k, v = _decode_qkv(x, p, cur_len, n_heads=n_heads, n_kv=n_kv, cfg=cfg,
                          rope_theta=rope_theta)
    hd = q.shape[3]
    num_blocks = k_blocks.shape[0] - 1
    W = block_table.shape[1]
    cur = cur_len.long()
    blk = cur // block_size
    off = cur % block_size
    tbl = block_table.long()
    phys = torch.gather(tbl, 1, blk.clamp(max=W - 1)[:, None])[:, 0]
    # past-table rows -> trash; a sentinel entry already names the trash row
    phys = torch.where(blk < W, phys, num_blocks)
    # the fused token is cast to the POOL dtype first: attention must use
    # the same rounded value every later step reads back from the pool
    kn = k[:, 0].to(k_blocks.dtype)
    vn = v[:, 0].to(v_blocks.dtype)
    args = (q[:, 0], kn, vn, k_blocks[:num_blocks], v_blocks[:num_blocks],
            block_table, cur_len)
    if attn_impl == "kernel":
        out = paged_attention(*args, block_size=block_size)
    else:
        out = paged_attention_plain(*args, block_size=block_size).to(q.dtype)
    k_blocks[phys, off] = kn
    v_blocks[phys, off] = vn
    return L.dense(out.reshape(B, 1, n_heads * hd), p["wo"], cfg)
