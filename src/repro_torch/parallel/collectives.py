"""The collectives of tensor-parallel serving, over a ``TPMesh``'s group:
a SUM all-reduce (int32 code dots and row sums, float32 partial
products), a MAX all-reduce (float32 ranges), an all-gather along the
last dim (the vocab-split logits) and one along the first (the
expert-parallel MoE's output rows).  Nothing more, so gloo can carry them
on CUDA tensors as well as NCCL.  Each call waits for its result and is
counted in ``COUNTS`` (calls, and host seconds spent in them).

Inference only: a tensor that requires grad raises, since these calls
are not recorded by autograd.
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

import torch
import torch.distributed as dist

__all__ = ["COUNTS", "all_gather_first", "all_gather_last", "all_reduce_max", "all_reduce_sum",
           "max_range"]

COUNTS: Dict[str, float] = {"calls": 0, "host_s": 0.0}


def _timed(fn, t: torch.Tensor):
    if t.requires_grad:
        raise NotImplementedError("tensor-parallel collectives carry no gradient: "
                                  "training under a mesh is not ported yet")
    t0 = time.perf_counter()
    out = fn()
    COUNTS["calls"] += 1
    COUNTS["host_s"] += time.perf_counter() - t0
    return out


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the mesh's ranks, in place (exact on int32)."""
    _timed(lambda: dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group), t)
    return t


def all_reduce_max(t: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise max of ``t`` over the mesh's ranks, in place."""
    _timed(lambda: dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group), t)
    return t


def max_range(lo: torch.Tensor, hi: torch.Tensor, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (min, max) of every rank's (``lo``, ``hi``): one float32 MAX
    all-reduce of ``(-lo, hi)``, exact (negation and the casts of a
    float32, bfloat16 or float16 value to float32 and back round
    nothing)."""
    t = torch.stack([-lo, hi]).to(torch.float32)
    all_reduce_max(t, mesh)
    return (-t[0]).to(lo.dtype), t[1].to(hi.dtype)


def all_gather_last(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``t`` concatenated along the last dim, in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    _timed(lambda: dist.all_gather(parts, t, group=mesh.group), t)
    return torch.cat(parts, dim=-1)


def all_gather_first(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``t`` concatenated along the first dim, in rank order,
    bit for bit: the rows travel as their bytes (uint8), which every
    backend carries whatever ``t``'s dtype (gloo has no int16)."""
    t = t.contiguous()
    wire = t.view(torch.uint8)
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    _timed(lambda: dist.all_gather(parts, wire, group=mesh.group), t)
    return torch.cat(parts).view(t.dtype)
