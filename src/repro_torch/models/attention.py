"""Grouped-query attention: exact causal attention for prefill, one
decode step against either KV layout: the slot layout's per-row
``max_len`` stripe (``decode_attention``) or the paged pool
(``paged_decode_attention``), and the multi-position pass over the paged
pool that speculative verification and chunked prefill share
(``paged_verify_attention``, ``paged_chunk_prefill_attention``).

K/V are never head-repeated: scores use grouped einsums (q reshaped to
(B, S, Hkv, group, hd)), and prefill runs its queries in chunks of
``q_chunk`` (``attention_core``).  q/k/v come from one fused product where
the tree holds ``wqkv`` or the caller asks for ``fuse_qkv``.  All projections route through ``layers.dense``;
the score/AV einsums stay exact float (plain ``einsum``/``softmax``, as the
JAX package leaves them to XLA).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.approx import ApproxConfig, concat_weights, shard_info, w_dim
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_plain
from repro_torch.kernels.paged_attention.ref import attend_gathered, gather_blocks, softmax_scale
from repro_torch.models import layers as L

__all__ = [
    "ATTN_IMPLS",
    "TPHeadsError",
    "attention_core",
    "check_tp_heads",
    "self_attention",
    "seed_kv_cache",
    "decode_attention",
    "paged_decode_attention",
    "paged_verify_attention",
    "paged_chunk_prefill_attention",
]

_NEG = -1e30

# paged decode-attention implementations: the CUDA kernel (K2; its plain
# version for CPU tensors) and the clamp-gather-mask plain version on any
# device — the parity oracle
ATTN_IMPLS = ("kernel", "gather")


class TPHeadsError(ValueError):
    """A model axis that does not divide the query or the KV heads."""


def check_tp_heads(num_heads: int, num_kv_heads: int, tp: int) -> None:
    """Training over a model axis of ``tp`` runs ``attention_core`` on each
    rank's ``H/tp`` query and ``Hkv/tp`` KV heads, so both must divide.
    Where they do not, the JAX package pads the heads or falls back to a
    sequence split (``src/repro/models/attention.py:112-130``), which the
    port does not have (ROADMAP.md section 1, item 17)."""
    if num_heads % tp or num_kv_heads % tp:
        raise TPHeadsError(
            f"a model axis of {tp} must divide the {num_heads} query and {num_kv_heads} KV "
            "heads: the padded-head and sequence-parallel fallbacks are not ported "
            "(ROADMAP.md section 1, item 17)")


def _rank_heads(p: Dict[str, object], n_heads: int, n_kv: int) -> Tuple[int, int]:
    """The query and KV heads this rank computes: all of them, or its
    ``1/tp`` where ``wq`` (or the fused ``wqkv``) is split by column, a
    ``Shard`` or a ``DataPart`` with a column split (whole heads per rank:
    ``validate_tp_heads``, ``check_tp_heads``)."""
    info = shard_info(p["wq"] if "wq" in p else p["wqkv"])
    if info is not None:
        return n_heads // info[1].size, n_kv // info[1].size
    return n_heads, n_kv


def _attend(q, k, v, *, causal: bool, q_offset: int, kv_len: Optional[torch.Tensor]):
    """One chunk of queries at positions ``q_offset + [0, Sq)`` against
    every key: the scores, the masks and the softmax of this chunk only."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qt = (q * softmax_scale(hd, q.dtype)).reshape(B, Sq, Hkv, g, hd)
    scores = torch.einsum("bchgd,bkhd->bhgck", qt.float(), k.float())
    kv_pos = torch.arange(Sk, device=q.device)
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        scores.add_(torch.where(q_pos[:, None] >= kv_pos, 0.0, _NEG))
    if kv_len is not None:
        neg = torch.where(kv_pos[None, :] < kv_len[:, None], 0.0, _NEG)
        scores.add_(neg[:, None, None, None, :])
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    del scores
    out = torch.einsum("bhgck,bkhd->bchgd", probs.float(), v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def attention_core(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, Sk, Hkv, hd)
    v: torch.Tensor,            # (B, Sk, Hkv, hd)
    *,
    causal: bool,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,   # (B,) valid cache lengths
    q_chunk: int = 512,
) -> torch.Tensor:
    """Exact-softmax GQA with f32 scores and accumulation; out in q's dtype.

    The queries run in chunks of ``q_chunk`` when ``Sq`` is larger than
    ``q_chunk`` and a multiple of it (the JAX package's rule; otherwise as
    one chunk), each chunk's causal mask starting at ``q_offset`` plus the
    chunk's start: a chunk's (B, Hkv, g, q_chunk, Sk) scores are freed
    before the next, so prefill holds O(q_chunk * Sk) of them, not
    O(Sq * Sk)."""
    Sq = q.shape[1]
    if Sq <= q_chunk or Sq % q_chunk:
        return _attend(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    return torch.cat([_attend(q[:, s:s + q_chunk], k, v, causal=causal, q_offset=q_offset + s,
                              kv_len=kv_len) for s in range(0, Sq, q_chunk)], dim=1)


def _project_qkv(x: torch.Tensor, p: Dict[str, object], cfg: ApproxConfig, n_heads: int,
                 n_kv: int, fuse: bool = False):
    """q (B, S, n_heads, hd), k and v (B, S, n_kv, hd) of ``x`` (B, S, d):
    one product over the fused ``wqkv`` where the tree holds one (frozen
    serving weights, ``transformer.fuse_params``) or, with ``fuse``, over
    ``concat_weights`` of the three (the JAX package's ``fuse_qkv``: one
    activation quantization, one wide product), split at the heads'
    columns; else three products."""
    B, S, _ = x.shape
    if "wqkv" in p or fuse:
        w = p["wqkv"] if "wqkv" in p else concat_weights([p["wq"], p["wk"], p["wv"]])
        hd = w_dim(w, -1) // (n_heads + 2 * n_kv)
        qkv = L.dense(x, w, cfg)
        nq, nk = n_heads * hd, n_kv * hd
        q, k, v = qkv[..., :nq], qkv[..., nq:nq + nk], qkv[..., nq + nk:]
    else:
        hd = w_dim(p["wq"], -1) // n_heads
        q, k, v = (L.dense(x, p[n], cfg) for n in ("wq", "wk", "wv"))
    return (q.reshape(B, S, n_heads, hd), k.reshape(B, S, n_kv, hd),
            v.reshape(B, S, n_kv, hd))


def self_attention(
    x: torch.Tensor,                 # (B, S, d)
    p: Dict[str, object],
    *,
    n_heads: int,
    n_kv: int,
    cfg: ApproxConfig,
    m_rope: Optional[Tuple[torch.Tensor, Tuple[int, ...]]] = None,
    rope_theta: float = 10000.0,
    use_rope: bool = True,
    q_chunk: int = 512,
    fuse_qkv: bool = False,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Prefill self-attention at positions 0..S-1.  Returns (out, (k, v))
    so the caller can seed the decode cache (k post-rope).  ``m_rope`` is
    ``(positions_thw (B, 3, S), sections)`` for multimodal rope in place of
    rope; without ``use_rope`` (sinusoidal positions, added to the input)
    q and k are not rotated.  ``q_chunk`` chunks the queries
    (``attention_core``); ``fuse_qkv`` projects q/k/v in one product
    (``_project_qkv``)."""
    n_heads, n_kv = _rank_heads(p, n_heads, n_kv)
    B, S, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg, n_heads, n_kv, fuse_qkv)
    hd = q.shape[3]
    if use_rope and m_rope is not None:
        q, k = L.apply_m_rope(q, k, m_rope[0], m_rope[1], theta=rope_theta)
    elif use_rope:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        q, k = L.apply_rope(q, k, positions, theta=rope_theta)
    out = attention_core(q, k, v, causal=True, q_chunk=q_chunk)
    out = L.dense(out.reshape(B, S, n_heads * hd), p["wo"], cfg)
    return out, (k, v)


def _decode_qkv(x, p, cur_len, *, n_heads, n_kv, cfg, rope_theta, use_rope):
    """Project the new token's q/k/v (through the fused ``wqkv`` where the
    tree holds one) and rotate q/k at each row's cur_len (with
    ``use_rope``)."""
    q, k, v = _project_qkv(x, p, cfg, n_heads, n_kv)
    if use_rope:
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
    use_rope: bool = True,
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
    n_heads, n_kv = _rank_heads(p, n_heads, n_kv)
    q, k, v = _decode_qkv(x, p, cur_len, n_heads=n_heads, n_kv=n_kv, cfg=cfg,
                          rope_theta=rope_theta, use_rope=use_rope)
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
    use_rope: bool = True,
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
    n_heads, n_kv = _rank_heads(p, n_heads, n_kv)
    q, k, v = _decode_qkv(x, p, cur_len, n_heads=n_heads, n_kv=n_kv, cfg=cfg,
                          rope_theta=rope_theta, use_rope=use_rope)
    hd = q.shape[3]
    num_blocks = k_blocks.shape[0] - 1
    phys, off = _paged_slot(cur_len.long()[:, None], block_table, num_blocks, block_size)
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
    k_blocks[phys[:, 0], off[:, 0]] = kn
    v_blocks[phys[:, 0], off[:, 0]] = vn
    return L.dense(out.reshape(B, 1, n_heads * hd), p["wo"], cfg)


def _paged_slot(pos, block_table, num_blocks: int, block_size: int):
    """(physical block, offset) of cache positions ``pos`` through each
    row's table; positions past the table map to the trash block (a
    sentinel entry already names it)."""
    W = block_table.shape[1]
    blk = pos // block_size
    phys = torch.gather(block_table.long(), 1, blk.clamp(max=W - 1))
    return torch.where(blk < W, phys, num_blocks), pos % block_size


def paged_verify_attention(
    x: torch.Tensor,                 # (B, S, d): S consecutive tokens per row
    p: Dict[str, object],
    k_blocks: torch.Tensor,          # (num_blocks + 1, block_size, Hkv, hd) one layer
    v_blocks: torch.Tensor,
    block_table: torch.Tensor,       # (B, W) int32 physical block ids
    cur_len: torch.Tensor,           # (B,) position of the FIRST of the S tokens
    *,
    block_size: int,
    n_heads: int,
    n_kv: int,
    cfg: ApproxConfig,
    rope_theta: float = 10000.0,
    use_rope: bool = True,
) -> torch.Tensor:
    """Score ``S`` consecutive tokens of each row at cache positions
    ``cur_len + j`` in one pass against the paged pool.

    The projections and rope run batched over the S positions; the K/V of
    all S positions are written into the pool IN PLACE through the table
    first (past-table and sentinel targets land in the trash block, as in
    ``paged_decode_attention``); the blocks are gathered once; then each
    position attends with its own horizon ``kv_len = cur_len + j + 1``
    through ``attend_gathered``, once per position with one query, NOT
    one batched call: every position runs the instruction sequence of the
    single-token gather decode (``paged_decode_step(attn_impl="gather")``),
    so the pass is bit-identical to S sequential decode steps by
    construction.  K2 is single-query, as the TPU kernel is, so this pass
    always reads through the gather."""
    n_heads, n_kv = _rank_heads(p, n_heads, n_kv)
    B, S, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg, n_heads, n_kv)
    hd = q.shape[3]
    pos = cur_len.long()[:, None] + torch.arange(S, device=x.device)[None, :]
    if use_rope:
        q, k = L.apply_rope(q, k, pos, theta=rope_theta)
    num_blocks = k_blocks.shape[0] - 1
    phys, off = _paged_slot(pos, block_table, num_blocks, block_size)
    kn = k.to(k_blocks.dtype)
    vn = v.to(v_blocks.dtype)
    k_blocks[phys, off] = kn
    v_blocks[phys, off] = vn
    kg, vg = gather_blocks(k_blocks[:num_blocks], v_blocks[:num_blocks], block_table)
    outs = [
        attend_gathered(q[:, j], kn[:, j], vn[:, j], kg, vg, block_table, cur_len + j,
                        num_blocks=num_blocks, block_size=block_size).to(q.dtype)
        for j in range(S)
    ]
    out = torch.stack(outs, dim=1)               # (B, S, H, hd)
    return L.dense(out.reshape(B, S, n_heads * hd), p["wo"], cfg)


def paged_chunk_prefill_attention(*args, **kwargs) -> torch.Tensor:
    """Chunk-prefill attention: one chunk of each row's prompt at cache
    positions ``cur_len + j``, reading the already-written prefix through
    the block table.  This IS ``paged_verify_attention``: write the chunk's
    K/V through the table first (sentinel-tail entries of a partly filled
    table send those writes to the trash block), then attend each position
    at its own horizon.  Padding positions past a row's real chunk length
    write K/V inside the row's own blocks only, at positions the next
    chunk or decode overwrites before any horizon reaches them."""
    return paged_verify_attention(*args, **kwargs)
