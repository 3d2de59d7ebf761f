"""The work of each hand-written kernel's function, and how a wrapper
reports a call to an active cost counter (``launch/roofline.py``
``count_costs``).

The work is that of the function, not of its design, so a bound read from
it holds for any implementation: K1 computes one product of uint8 codes,
2*M*N*K int8 operations on M*K + K*N bytes in and 4*M*N out, whatever
number of tensor-core products its factorization takes (``design_ops``,
(1 + F) times as many, is reported beside it and bounds nothing).  K2
reads the query, the new token's K/V, the table and lengths and the K/V
rows of the pool positions it attends (``k2_valid_positions``), and does
4 * hd float32 operations per query head and position.  K3 moves 2 bytes
in and 4 out per element; its integer logic has no rate in the data
sheet.

A wrapper runs every call through ``reported``.  With no counter active
it just runs the call.  Under a counter the call is one call of the kernel
with its work, and whatever the wrapper does inside it (the plain
version's operations on the CPU, the launch's padding on the card) is not
counted as operations of the step: so a count on the CPU and a count on
``meta`` of the same step are equal.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, TypeVar

import torch
from torch.utils._python_dispatch import _disable_current_modes, _get_current_dispatch_mode_stack

__all__ = ["KernelWork", "active_counter", "k1_work", "k2_valid_positions", "k2_work", "k3_work",
           "reported"]

T = TypeVar("T")


class KernelWork(NamedTuple):
    """One call's work: bytes that must move, operations, the class whose
    peak rate bounds them (a key of ``launch/roofline.py``'s rates) and,
    for K1, the operations of its design."""

    bytes: float
    ops: float
    op_class: str
    design_ops: float = 0.0


def k1_work(M: int, N: int, K: int, features: int = 0) -> KernelWork:
    """(M, K) x (K, N) uint8 codes -> (M, N) int32; ``features`` the F of
    the multiplier's factorization (its design: 1 + F products)."""
    ops = 2.0 * M * N * K
    return KernelWork(float(M * K + K * N + 4 * M * N), ops, "int8", ops * (1 + features))


def k2_work(B: int, H: int, hkv: int, hd: int, W: int, valid: int, qsize: int,
            esize: int) -> KernelWork:
    """One paged decode-attention call: q read and the output written in
    q's dtype (``qsize`` bytes), the new token's K/V, the (B, W) table and
    lengths, and the K/V rows of ``valid`` pool positions, each read once
    in the pool dtype (``esize`` bytes); 4 * hd float32 operations per
    query head and attended position (the new token's included)."""
    nbytes = B * (2 * H * hd * qsize + 2 * hkv * hd * esize + 4 * (W + 1)) \
        + 2 * esize * valid * hkv * hd
    return KernelWork(float(nbytes), 4.0 * H * hd * (valid + B), "float32")


def k2_valid_positions(block_table, cur_len, num_blocks: int, block_size: int) -> int:
    """Pool positions a K2 call reads: in an allocated block (a table
    entry below ``num_blocks``; ``num_blocks`` is the sentinel) and before
    its row's ``cur_len``.  Reads the table and lengths (tensors or
    arrays) on the host."""
    block_table, cur_len = torch.as_tensor(block_table), torch.as_tensor(cur_len)
    W = block_table.shape[1]
    start = torch.arange(W, device=block_table.device) * block_size
    n = (cur_len.long()[:, None] - start[None, :]).clamp(0, block_size)
    return int((n * (block_table < num_blocks)).sum())


def k3_work(n: int) -> KernelWork:
    """``n`` elementwise products: two uint8 codes in, one int32 out."""
    return KernelWork(6.0 * n, 0.0, "int8")


def active_counter():
    """The innermost active cost counter (a dispatch mode with a
    ``kernel_call`` method), or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if hasattr(mode, "kernel_call"):
            return mode
    return None


def reported(name: str, work: Callable[[], KernelWork], run: Callable[[], T]) -> T:
    """``run()`` as one call of kernel ``name``: under an active counter
    the counter records ``work()`` and runs ``run`` unseen; else ``run()``."""
    counter = active_counter()
    if counter is None:
        return run()
    with _disable_current_modes():      # the work's own arithmetic (tables) is not the step's
        w = work()
    return counter.kernel_call(name, w, run)
