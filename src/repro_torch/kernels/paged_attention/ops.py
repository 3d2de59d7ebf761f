"""Wrapper of the CUDA paged decode-attention kernel (K2).

Validates shapes (the same checks, and messages, as the JAX wrapper), then
takes the plain PyTorch version for CPU tensors or launches the kernel in
``kernels/csrc/paged_attention.cu`` for CUDA tensors; on ``meta`` tensors
(shape inference) it checks what the kernel takes and returns an empty
output of its shape and dtype, launching nothing.  A shape or dtype the
kernel does not take raises ``PagedAttentionShapeError``; nothing falls
back.  ``paged_attention.launches`` counts kernel launches (one per call:
the splits of a row's table walk are merged in the same launch).  Every
call reports its work to an active cost counter (``kernels/work.py``):
on the CPU or the card the positions it attends, read from the table and
lengths (on the host, and only while a counter is active); on ``meta``,
whose table holds no values, every table entry's positions, an upper
bound on the call's work.

On the card the query is read in its dtype (float32 or bfloat16) and the
output written in it; the pools (float32 or bfloat16) and the new token's
K/V, which arrive in the pool dtype, are read as they are stored.  Nothing
is cast or copied on the host: the only allocations are the output and the
splits' scratch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import KernelLaunchError, library
from repro_torch.kernels.paged_attention.ref import paged_attention_plain
from repro_torch.kernels.work import k2_valid_positions, k2_work, reported

__all__ = ["paged_attention", "PagedAttentionShapeError", "validate_tp_heads"]

_MAX_HEAD_DIM = 128        # q, acc and one head's rows stay small in shared memory
_MAX_GROUP = 32            # one warp keeps the group's softmax stats, lane = head
_MAX_SMEM = 227 * 1024     # dynamic shared memory a block can have on an H100
_RING_BUDGET = 40 * 1024   # ring bytes per block: about five blocks per SM
_TARGET_CTAS = 4 * 132     # split the walk until about four blocks per SM
_MAX_SPLITS = 64           # bounds the merge's scratch and weights
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # pool and q dtypes -> kernel flag
_COUNTERS = {}             # (device, stream) -> int32 ticket counters, 0 between calls


class PagedAttentionShapeError(ValueError):
    """A shape or dtype the CUDA kernel does not take."""


def validate_tp_heads(num_heads: int, num_kv_heads: int, tp: int) -> None:
    """Reject head counts that cannot shard over a ``tp``-way model axis.

    Under tensor parallelism each rank launches the kernel on its own
    heads of q/k/v and its own KV-head shard of the pool, so each rank
    must hold an integral number of query AND KV heads; otherwise the
    per-rank ``H % n_kv`` group structure (each KV head serving ``H //
    n_kv`` query heads) would differ across ranks.  The messages are the
    JAX package's."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if num_heads % tp or num_kv_heads % tp:
        raise ValueError(
            f"pallas paged attention under tp={tp} needs per-shard integral "
            f"head counts: num_heads={num_heads}, num_kv_heads={num_kv_heads} "
            f"must both divide by tp"
        )
    if (num_heads // tp) % (num_kv_heads // tp):
        raise ValueError(
            f"per-shard group structure broken: {num_heads // tp} query heads "
            f"not a multiple of {num_kv_heads // tp} KV heads per shard"
        )


@functools.lru_cache(maxsize=None)
def _fn():
    fn = library("paged_attention").paged_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def split_plan(B: int, n_kv: int, W: int):
    """(splits, chunk): how many blocks share one (row, KV head)'s table
    walk, each taking ``chunk`` consecutive entries.  From the grid's
    shape only (never the table or cur_len, which live on the card): split
    until about ``_TARGET_CTAS`` blocks are in flight."""
    W = max(W, 1)
    want = -(-_TARGET_CTAS // max(B * n_kv, 1))
    splits = max(1, min(W, _MAX_SPLITS, want))
    chunk = -(-W // splits)
    return -(-W // chunk), chunk


def _copy_unit(hd: int, esize: int) -> int:
    """Bytes per cp.async: 16, or 8 for a bf16 row that is not a multiple of 16."""
    return 16 if (hd * esize) % 16 == 0 else 8


def _ring(chunk: int, bs: int, hd: int, esize: int):
    """(R, nslot): blocks per round, and ring slots (two rounds, or the
    whole chunk where it is shorter).  R is as large as ``_RING_BUDGET``
    allows and splits the chunk into rounds of equal size."""
    slot = 2 * bs * (hd * esize + _copy_unit(hd, esize))   # one block's K and V rows
    r_max = max(1, _RING_BUDGET // (2 * slot))
    R = -(-chunk // -(-chunk // r_max))
    return R, min(2 * R, chunk)


def _smem_bytes(g, hd, bs, esize, R, nslot, splits, chunk) -> int:
    """The kernel's shared memory (``Layout`` in paged_attention.cu)."""
    up16 = lambda x: -(-x // 16) * 16
    ring = nslot * bs * (hd * esize + _copy_unit(hd, esize))
    sizes = [ring, ring, g * hd * 4, g * hd * 4, g * R * bs * 4, 3 * g * 4,
             (2 * splits + 1) * g * 4, chunk * 4, chunk * 4]
    return sum(up16(x) for x in sizes[:-1]) + sizes[-1] + 16


def _check(q_dtype, pool_dtype, H, hd, n_kv, block_size):
    """Raise ``PagedAttentionShapeError`` for what the kernel does not take."""
    g = H // n_kv
    if pool_dtype not in _DTYPES:
        raise PagedAttentionShapeError(
            f"pool dtype {pool_dtype}: the kernel reads float32 and bfloat16 pools")
    if q_dtype not in _DTYPES:
        raise PagedAttentionShapeError(
            f"query dtype {q_dtype}: the kernel takes float32 and bfloat16 queries")
    if hd > _MAX_HEAD_DIM or hd % 4:
        raise PagedAttentionShapeError(f"head_dim {hd}: the kernel takes multiples of 4 "
                                       f"up to {_MAX_HEAD_DIM}")
    if g > _MAX_GROUP:
        raise PagedAttentionShapeError(f"{g} query heads per KV head > {_MAX_GROUP}")
    smem = _smem_bytes(g, hd, block_size, pool_dtype.itemsize, 1, 2, _MAX_SPLITS, 1)
    if smem > _MAX_SMEM:
        raise PagedAttentionShapeError(
            f"block_size {block_size} x head_dim {hd}: a ring of two blocks needs {smem} B "
            f"of shared memory > {_MAX_SMEM}")


@functools.lru_cache(maxsize=256)
def _plan(q_dtype, pool_dtype, kn_dtype, vn_dtype, vp_dtype, B, H, hd, n_kv, block_size, W):
    """Check what the kernel takes and pick its launch (cached per shape):
    (splits, chunk, R, nslot, copy unit)."""
    _check(q_dtype, pool_dtype, H, hd, n_kv, block_size)
    for name, dt in (("k_new", kn_dtype), ("v_new", vn_dtype), ("v_pool", vp_dtype)):
        if dt != pool_dtype:
            raise PagedAttentionShapeError(
                f"{name} dtype {dt} != pool dtype {pool_dtype}: the new token "
                "arrives in the pool dtype")
    esize = pool_dtype.itemsize
    splits, chunk = split_plan(B, n_kv, W)
    R, nslot = _ring(chunk, block_size, hd, esize)
    smem = _smem_bytes(H // n_kv, hd, block_size, esize, R, nslot, splits, chunk)
    if smem > _MAX_SMEM:
        raise PagedAttentionShapeError(
            f"table width {W}: {chunk} entries per split need {smem} B of shared memory")
    return splits, chunk, R, nslot, _copy_unit(hd, esize)


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Ticket counters for ``n`` (row, KV head) pairs: zeroed once here,
    and every launch leaves them at 0 again."""
    key = (device, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def paged_attention(
    q: torch.Tensor,            # (B, H, hd) post-rope queries, one decode step
    k_new: torch.Tensor,        # (B, Hkv, hd) new token K (post-rope, pool dtype)
    v_new: torch.Tensor,        # (B, Hkv, hd) new token V
    k_pool: torch.Tensor,       # (num_blocks, block_size, Hkv, hd) one layer
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # (B, W) physical block ids, sentinel == num_blocks
    cur_len: torch.Tensor,      # (B,) new-token positions
    *,
    block_size: int,
) -> torch.Tensor:
    """(B, H, hd) attention outputs in the query's dtype.  The pools are
    read-only: the new token is fused while staging, and persisting it is
    the caller's write."""
    B, H, hd = q.shape
    num_blocks, bs, n_kv, hd_k = k_pool.shape
    if bs != block_size:
        raise ValueError(f"pool block_size {bs} != block_size arg {block_size}")
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"k/v pool shapes differ: {tuple(k_pool.shape)} vs {tuple(v_pool.shape)}")
    if hd != hd_k or H % n_kv:
        raise ValueError(f"q heads/dim {(H, hd)} incompatible with pool {(n_kv, hd_k)}")
    if tuple(k_new.shape) != (B, n_kv, hd) or tuple(v_new.shape) != (B, n_kv, hd):
        raise ValueError(
            f"new-token K/V must be {(B, n_kv, hd)}, got "
            f"{tuple(k_new.shape)} / {tuple(v_new.shape)}"
        )
    if block_table.dim() != 2 or block_table.shape[0] != B or tuple(cur_len.shape) != (B,):
        raise ValueError(
            f"block_table {tuple(block_table.shape)} / cur_len {tuple(cur_len.shape)} "
            f"inconsistent with batch {B}"
        )
    args = (q, k_new, v_new, k_pool, v_pool, block_table, cur_len)
    W = block_table.shape[1]
    work = lambda: k2_work(B, H, n_kv, hd, W, B * W * block_size if q.is_meta else
                           k2_valid_positions(block_table, cur_len, num_blocks, block_size),
                           q.element_size(), k_pool.element_size())
    if all(t.device.type == "cpu" for t in args):
        return reported("paged_attention", work, lambda: paged_attention_plain(
            *args, block_size=block_size).to(q.dtype))
    if all(t.device.type == "meta" for t in args):
        _plan(q.dtype, k_pool.dtype, k_new.dtype, v_new.dtype, v_pool.dtype, B, H, hd, n_kv,
              block_size, W)
        return reported("paged_attention", work, lambda: torch.empty(
            (B, H, hd), dtype=q.dtype, device=q.device))
    if not all(t.is_cuda and t.device == q.device for t in args):
        raise ValueError("paged_attention operands must all be on the CPU, on one CUDA device "
                         "or on meta")
    return reported("paged_attention", work, lambda: _launch(*args, block_size=block_size))


def _launch(q, k_new, v_new, k_pool, v_pool, block_table, cur_len, *, block_size):
    """K2 on one CUDA device (the shapes checked)."""
    B, H, hd = q.shape
    num_blocks, _, n_kv, _ = k_pool.shape
    splits, chunk, R, nslot, vec = _plan(q.dtype, k_pool.dtype, k_new.dtype, v_new.dtype,
                                         v_pool.dtype, B, H, hd, n_kv, block_size,
                                         block_table.shape[1])
    kn, vn, kp, vp = (t.contiguous() for t in (k_new, v_new, k_pool, v_pool))
    if any(t.data_ptr() % vec for t in (kn, vn, kp, vp)):
        raise PagedAttentionShapeError(f"K/V operands must start on a {vec}-byte boundary")
    qc = q.contiguous()
    tbl = block_table.to(torch.int32).contiguous()
    cl = cur_len.to(torch.int32).contiguous()
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    part = torch.empty(B * H * splits * (hd + 2), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = _counters(q.device, stream, B * n_kv)
    rc = _fn()(qc.data_ptr(), kn.data_ptr(), vn.data_ptr(), kp.data_ptr(), vp.data_ptr(),
               tbl.data_ptr(), cl.data_ptr(), out.data_ptr(), part.data_ptr(),
               counters.data_ptr(), B, H, n_kv, hd, block_size, block_table.shape[1],
               num_blocks, splits, chunk, R, nslot, _DTYPES[q.dtype], _DTYPES[k_pool.dtype],
               vec, stream)
    if rc != 0:
        raise KernelLaunchError(f"paged_attention launch failed: cudaError {rc}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
