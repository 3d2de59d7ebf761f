"""The collectives of the meshes (``launch/mesh.py``), over a mesh's
group.  Tensor-parallel serving: a SUM all-reduce (int32 code dots and
row sums, float32 partial products), a MAX all-reduce (float32 ranges),
an all-gather along the last dim (the vocab-split logits) and one along
the first (the expert-parallel MoE's output rows); these are inference
only: a tensor that requires grad raises, since they are not recorded by
autograd.  Data-parallel training (``parallel/fsdp.py``): ``gather_dim``,
an all-gather along any dim that autograd records, its backward the SUM
reduce-scatter of the cotangent; ``gather_value`` and ``owned_whole``, the
same split into a value and a gradient path, so that a cast's rounding of
the gradient can follow the ranks' sum (for a weight every rank holds
whole, a float32 SUM all-reduce of the cotangent); ``sum_rows``, the
ranks' sum of a MoE dispatch buffer whose rows each rank fills alone,
its backward the rank's own cotangent; and ``barrier``; the
remaining gradients' all-reduce, the ranges' MAX and the optimizer's
sums use the functions above on tensors that need no gradient.  Nothing
more, so gloo can carry them on CUDA tensors as well as NCCL.  Each call
waits for its result and is counted in ``COUNTS`` (calls, and host
seconds spent in them).
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

import torch
import torch.distributed as dist

__all__ = ["COUNTS", "all_gather_first", "all_gather_last", "all_reduce_max", "all_reduce_sum",
           "barrier", "gather_dim", "gather_value", "max_range", "owned_whole", "sum_rows"]

COUNTS: Dict[str, float] = {"calls": 0, "host_s": 0.0}


def _counted(fn):
    t0 = time.perf_counter()
    out = fn()
    COUNTS["calls"] += 1
    COUNTS["host_s"] += time.perf_counter() - t0
    return out


def _timed(fn, t: torch.Tensor):
    if t.requires_grad:
        raise NotImplementedError("these collectives carry no gradient: a tensor that "
                                  "requires grad crosses the ranks through gather_dim")
    return _counted(fn)


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


def _gather_along(part: torch.Tensor, pos: int, mesh) -> torch.Tensor:
    """Every rank's ``part`` concatenated along dim ``pos`` in rank order,
    contiguous as the whole tensor is."""
    part = part.contiguous()
    out = part.new_empty((mesh.size * part.shape[0], *part.shape[1:]))
    _counted(lambda: dist.all_gather_into_tensor(out, part, group=mesh.group))
    out = out.view(mesh.size, *part.shape).movedim(0, pos)       # (..., size, n_pos, ...)
    return out.reshape(*part.shape[:pos], -1, *part.shape[pos + 1:])


def _scatter_sum(grad: torch.Tensor, pos: int, mesh) -> torch.Tensor:
    """This rank's slice along dim ``pos`` of ``grad`` summed over the
    ranks (a reduce-scatter)."""
    shape = (*grad.shape[:pos], mesh.size, grad.shape[pos] // mesh.size, *grad.shape[pos + 1:])
    lead = grad.reshape(shape).movedim(pos, 0).contiguous()       # (size, *part)
    out = lead.new_empty(lead.shape[1:])
    _counted(lambda: dist.reduce_scatter_tensor(out, lead.view(-1, *lead.shape[2:]),
                                                op=dist.ReduceOp.SUM, group=mesh.group))
    return out


class _OwnedWhole(torch.autograd.Function):
    """A whole tensor computed from the ranks' gathered parts, whose
    cotangent reaches ``part`` summed over the ranks at its slice (a
    reduce-scatter), then rounded through ``round_to``.  With no split
    (``dim`` None, a weight every rank holds whole) the cotangent is
    summed over the ranks in float32 (an all-reduce), then rounded."""

    @staticmethod
    def forward(ctx, part, whole, dim, mesh, round_to):
        ctx.pos = None if dim is None else dim % part.dim()
        ctx.mesh, ctx.round_to = mesh, round_to
        return whole.view_as(whole)

    @staticmethod
    def backward(ctx, grad):
        if ctx.pos is None:
            out = grad.to(torch.float32, copy=True).contiguous()
            _counted(lambda: dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.mesh.group))
        else:
            out = _scatter_sum(grad, ctx.pos, ctx.mesh)
        if ctx.round_to is not None:
            out = out.to(ctx.round_to)
        return out.to(grad.dtype), None, None, None, None


def gather_value(part: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """``gather_dim``'s value, recorded by no autograd graph."""
    with torch.no_grad():
        return _gather_along(part.detach(), dim % part.dim(), mesh)


def owned_whole(part: torch.Tensor, whole: torch.Tensor, dim, mesh,
                round_to=None) -> torch.Tensor:
    """``whole`` (computed without a graph from ``gather_value(part)``, or
    from ``part`` itself where ``dim`` is None) as autograd sees it: its
    cotangent, summed over the ranks at ``part``'s slice (no collective in
    the forward; one reduce-scatter in the backward, or one float32
    all-reduce where ``dim`` is None), then rounded through ``round_to``
    where given, reaches ``part``.  So a cast's rounding of a gradient
    happens once, after the ranks' sum, as on one device."""
    return _OwnedWhole.apply(part, whole, dim, mesh, round_to)


def gather_dim(part: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """Every rank's ``part`` concatenated along ``dim`` in rank order, as
    autograd sees it: the gradient that reaches ``part`` is the sum over
    the ranks of the whole result's cotangent at ``part``'s slice."""
    return owned_whole(part, gather_value(part, dim, mesh), dim, mesh)


class _SumRows(torch.autograd.Function):
    """The ranks' sum of a tensor whose nonzero rows each rank fills
    alone, its cotangent passed back to the rank as it is."""

    @staticmethod
    def forward(ctx, t, mesh):
        out = t.detach().to(torch.float32, copy=True).contiguous()
        _counted(lambda: dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group))
        return out.to(t.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``t`` summed, where each row is nonzero on one rank at
    most (a MoE dispatch buffer, each rank's tokens at their global rows):
    one float32 SUM all-reduce, exact, since each element is one rank's
    value plus zeros.  As autograd sees it the cotangent that reaches
    ``t`` is this rank's own: each rank reads back only the rows it filled
    and the function after it is row by row, so the other ranks'
    cotangents at those rows are zeros, and no collective runs in the
    backward."""
    return _SumRows.apply(t, mesh)


def barrier(mesh) -> None:
    """Every rank of ``mesh`` waits here until all have arrived."""
    _counted(lambda: dist.barrier(group=mesh.group))
