"""Plain PyTorch version of paged decode attention (K2).

Same semantics as the kernel — walk the block table, fuse the new token at
``cur_len``, skip sentinel blocks, mask positions past ``cur_len`` — but
computed the straightforward way: gather every table entry (clamped), mask,
one exact softmax.  The kernel's online softmax sums in another order, so
the two agree to f32 roundoff, not bitwise; masked positions carry weight
exactly 0.0 in both.

The gather and the attention are separate steps (``gather_blocks``,
``attend_gathered``) so that a multi-position pass (``attention.
paged_verify_attention``) gathers once and attends each position with the
single-token instruction sequence.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

__all__ = ["attend_gathered", "gather_blocks", "paged_attention_plain", "softmax_scale"]

_NEG = -1e30


@functools.lru_cache(maxsize=None)
def softmax_scale(hd: int, dtype: torch.dtype) -> float:
    """``1 / sqrt(float32(hd))`` rounded to ``dtype``, as a Python float.
    Computed once on the host: a product ``x * scale`` with ``x`` of that
    dtype rounds the same exact product as one with a 0-dim tensor of it,
    and copies nothing to the device."""
    s = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    return float(s.to(dtype))


def gather_blocks(k_pool: torch.Tensor, v_pool: torch.Tensor,
                  block_table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every table entry's block (sentinels clamped to the last real one),
    as (B, W * block_size, Hkv, hd) float32 K and V."""
    num_blocks, bs, n_kv, hd = k_pool.shape
    B, W = block_table.shape
    clamped = block_table.clamp(max=num_blocks - 1).long()
    kg = k_pool[clamped].reshape(B, W * bs, n_kv, hd).float()
    vg = v_pool[clamped].reshape(B, W * bs, n_kv, hd).float()
    return kg, vg


def attend_gathered(
    q: torch.Tensor,            # (B, H, hd)
    k_new: torch.Tensor,        # (B, Hkv, hd)
    v_new: torch.Tensor,        # (B, Hkv, hd)
    kg: torch.Tensor,           # (B, W * block_size, Hkv, hd) float32, gather_blocks
    vg: torch.Tensor,
    block_table: torch.Tensor,  # (B, W) int32, sentinel == num_blocks
    cur_len: torch.Tensor,      # (B,) int32
    *,
    num_blocks: int,
    block_size: int,
) -> torch.Tensor:
    """One decode step over gathered blocks: the new token fused at
    ``cur_len``, exact softmax; (B, H, hd) f32.  ``kg``/``vg`` are read,
    never written."""
    B, H, hd = q.shape
    S, n_kv = kg.shape[1], kg.shape[2]
    g = H // n_kv
    pos = torch.arange(S, device=q.device)
    cur = cur_len.long()
    at_cur = (pos[None, :] == cur[:, None])[..., None, None]
    kg = torch.where(at_cur, k_new.float()[:, None], kg)
    vg = torch.where(at_cur, v_new.float()[:, None], vg)

    # a position is attended iff it is <= cur AND its block is allocated
    pos_alloc = (block_table < num_blocks).repeat_interleave(block_size, dim=1)
    valid = (pos[None, :] <= cur[:, None]) & pos_alloc

    qg = (q.float() * softmax_scale(hd, torch.float32)).reshape(B, n_kv, g, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qg, kg)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, vg).reshape(B, H, hd)
    return torch.where(valid.any(dim=1)[:, None, None], out, torch.zeros_like(out))


def paged_attention_plain(
    q: torch.Tensor,            # (B, H, hd)
    k_new: torch.Tensor,        # (B, Hkv, hd)
    v_new: torch.Tensor,        # (B, Hkv, hd)
    k_pool: torch.Tensor,       # (num_blocks, block_size, Hkv, hd)
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # (B, W) int32, sentinel == num_blocks
    cur_len: torch.Tensor,      # (B,) int32
    *,
    block_size: int,
) -> torch.Tensor:
    """Exact-softmax paged GQA; (B, H, hd) f32.  Rows with no valid
    position (every block sentinel) return zeros."""
    kg, vg = gather_blocks(k_pool, v_pool, block_table)
    return attend_gathered(q, k_new, v_new, kg, vg, block_table, cur_len,
                           num_blocks=k_pool.shape[0], block_size=block_size)
