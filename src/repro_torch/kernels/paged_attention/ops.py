"""Wrapper of the CUDA paged decode-attention kernel (K2).

Validates shapes (the same checks, and messages, as the JAX wrapper), then
takes the plain PyTorch version for CPU tensors or launches the kernel in
``kernels/csrc/paged_attention.cu`` for CUDA tensors.  A shape the kernel
does not take raises ``PagedAttentionShapeError``; nothing falls back.
``paged_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import KernelLaunchError, library
from repro_torch.kernels.paged_attention.ref import paged_attention_plain

__all__ = ["paged_attention", "PagedAttentionShapeError"]

_MAX_HEAD_DIM = 128        # four dims per lane of a warp
_MAX_GROUP = 32            # one warp per query head of a KV group
_MAX_SMEM = 48 * 1024      # default dynamic shared memory per block


class PagedAttentionShapeError(ValueError):
    """A shape or dtype the CUDA kernel does not take."""


@functools.lru_cache(maxsize=None)
def _fn():
    fn = library("paged_attention").paged_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_shapes(q, k_pool, block_size):
    B, H, hd = q.shape
    n_kv = k_pool.shape[2]
    g = H // n_kv
    if k_pool.dtype != torch.float32:
        raise PagedAttentionShapeError(f"pool dtype {k_pool.dtype}: the kernel reads f32 pools")
    if hd > _MAX_HEAD_DIM:
        raise PagedAttentionShapeError(f"head_dim {hd} > {_MAX_HEAD_DIM}")
    if g > _MAX_GROUP:
        raise PagedAttentionShapeError(f"{g} query heads per KV head > {_MAX_GROUP}")
    smem = (2 * block_size * hd + g * block_size) * 4
    if smem > _MAX_SMEM:
        raise PagedAttentionShapeError(
            f"block_size {block_size} x head_dim {hd} needs {smem} B of shared "
            f"memory > {_MAX_SMEM}"
        )


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
    if all(t.device.type == "cpu" for t in args):
        return paged_attention_plain(*args, block_size=block_size).to(q.dtype)
    if not all(t.is_cuda and t.device == q.device for t in args):
        raise ValueError("paged_attention operands must all be on the CPU or on one CUDA device")
    _check_kernel_shapes(q, k_pool, block_size)
    W = block_table.shape[1]
    qf = q.float().contiguous()
    kn = k_new.float().contiguous()
    vn = v_new.float().contiguous()
    kp = k_pool.contiguous()
    vp = v_pool.contiguous()
    tbl = block_table.to(torch.int32).contiguous()
    cl = cur_len.to(torch.int32).contiguous()
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    if B == 0:
        return out.to(q.dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _fn()(qf.data_ptr(), kn.data_ptr(), vn.data_ptr(), kp.data_ptr(),
               vp.data_ptr(), tbl.data_ptr(), cl.data_ptr(), out.data_ptr(),
               B, H, n_kv, hd, block_size, W, num_blocks, stream)
    if rc != 0:
        raise KernelLaunchError(f"paged_attention launch failed: cudaError {rc}")
    paged_attention.launches += 1
    return out.to(q.dtype)


paged_attention.launches = 0
