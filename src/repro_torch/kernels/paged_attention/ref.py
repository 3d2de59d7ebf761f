"""Plain PyTorch version of paged decode attention (K2).

Same semantics as the kernel — walk the block table, fuse the new token at
``cur_len``, skip sentinel blocks, mask positions past ``cur_len`` — but
computed the straightforward way: gather every table entry (clamped), mask,
one exact softmax.  The kernel's online softmax sums in another order, so
the two agree to f32 roundoff, not bitwise; masked positions carry weight
exactly 0.0 in both.
"""
from __future__ import annotations

import torch

__all__ = ["paged_attention_plain"]

_NEG = -1e30


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
    B, H, hd = q.shape
    num_blocks, bs, n_kv, _ = k_pool.shape
    W = block_table.shape[1]
    g = H // n_kv
    S = W * block_size

    clamped = block_table.clamp(max=num_blocks - 1).long()
    kg = k_pool[clamped].reshape(B, S, n_kv, hd).float()
    vg = v_pool[clamped].reshape(B, S, n_kv, hd).float()

    pos = torch.arange(S, device=q.device)
    cur = cur_len.long()
    at_cur = (pos[None, :] == cur[:, None])[..., None, None]
    kg = torch.where(at_cur, k_new.float()[:, None], kg)
    vg = torch.where(at_cur, v_new.float()[:, None], vg)

    # a position is attended iff it is <= cur AND its block is allocated
    pos_alloc = (block_table < num_blocks).repeat_interleave(block_size, dim=1)
    valid = (pos[None, :] <= cur[:, None]) & pos_alloc

    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    qg = (q.float() * scale.to(q.device)).reshape(B, n_kv, g, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qg, kg)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, vg).reshape(B, H, hd)
    return torch.where(valid.any(dim=1)[:, None, None], out, torch.zeros_like(out))
