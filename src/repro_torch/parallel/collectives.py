"""The collectives of the meshes (``launch/mesh.py``), over a mesh's
group.  Tensor-parallel serving: a SUM all-reduce (int32 code dots and
row sums, float32 partial products), a MAX all-reduce (float32 ranges),
an all-gather along the last dim (the vocab-split logits) and one along
the first (the expert-parallel MoE's output rows); these are inference
only: a tensor that requires grad raises, since they are not recorded by
autograd.  Data-parallel training (``parallel/fsdp.py``): ``gather_value``,
an all-gather along any dim that records no graph, and ``owned_whole``,
its gradient path: the SUM reduce-scatter of the cotangent, so that a
cast's rounding of the gradient can follow the ranks' sum (for a weight
every rank holds whole, a float32 SUM all-reduce of the cotangent);
``sum_rows``, the ranks' sum of a MoE dispatch buffer whose rows each
rank fills alone, its backward the rank's own cotangent; and ``barrier``; the
remaining gradients' all-reduce, the ranges' MAX and the optimizer's
sums use the functions above on tensors that need no gradient.
Training over a model axis (``launch.mesh.TrainMesh``) adds Megatron's
"f" (``model_input``: the identity, its backward a float32 SUM over the
model group) and "g" (``model_sum``: a float32 SUM, its backward the
identity), and ``gather_last``, a vocab-split head's gather whose backward
keeps the rank's own columns; over a pod axis ``owned_whole`` also sums a
split part's cotangent across the pods before it rounds.  Serving calls
the same three on tensors that need no gradient.  Nothing
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
           "barrier", "gather_last", "gather_value", "max_range", "model_input",
           "model_sum", "owned_whole", "sum_rows"]

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
                                  "requires grad crosses the ranks through owned_whole")
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


def _sum_f32(t: torch.Tensor, mesh) -> torch.Tensor:
    """A float32 copy of ``t`` summed over ``mesh``'s ranks (one all-reduce)."""
    out = t.detach().to(torch.float32, copy=True).contiguous()
    _counted(lambda: dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group))
    return out


class _OwnedWhole(torch.autograd.Function):
    """A whole tensor computed from the ranks' gathered parts, whose
    cotangent reaches ``part`` summed over the ranks at its slice (a
    reduce-scatter) and over ``pod``'s ranks, which hold the same part (an
    all-reduce), then rounded through ``round_to``.  With no split
    (``dim`` None, a weight every rank holds whole) the cotangent is
    summed over ``mesh``'s ranks in float32 (an all-reduce; none where
    ``mesh`` is None), then rounded."""

    @staticmethod
    def forward(ctx, part, whole, dim, mesh, round_to, pod):
        ctx.pos = None if dim is None else dim % part.dim()
        ctx.mesh, ctx.round_to, ctx.pod = mesh, round_to, pod
        return whole.view_as(whole)

    @staticmethod
    def backward(ctx, grad):
        if ctx.pos is not None:
            out = _scatter_sum(grad, ctx.pos, ctx.mesh)
            if ctx.pod is not None:
                out = _sum_f32(out, ctx.pod)
        elif ctx.mesh is not None:
            out = _sum_f32(grad, ctx.mesh)
        else:
            out = grad
        if ctx.round_to is not None:
            out = out.to(ctx.round_to)
        return out.to(grad.dtype), None, None, None, None, None


def gather_value(part: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """Every rank's ``part`` concatenated along ``dim`` in rank order,
    recorded by no autograd graph (``owned_whole`` gives it a gradient)."""
    with torch.no_grad():
        return _gather_along(part.detach(), dim % part.dim(), mesh)


def owned_whole(part: torch.Tensor, whole: torch.Tensor, dim, mesh,
                round_to=None, pod=None) -> torch.Tensor:
    """``whole`` (computed without a graph from ``gather_value(part)``, or
    from ``part`` itself where ``dim`` is None) as autograd sees it: its
    cotangent, summed over the ranks at ``part``'s slice (no collective in
    the forward; one reduce-scatter in the backward, and one float32
    all-reduce over ``pod`` where given; or one float32 all-reduce over
    ``mesh`` where ``dim`` is None), then rounded through ``round_to``
    where given, reaches ``part``.  So a cast's rounding of a gradient
    happens once, after the ranks' sum, as on one device."""
    return _OwnedWhole.apply(part, whole, dim, mesh, round_to, pod)


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


class _ModelInput(torch.autograd.Function):
    """Megatron's "f": the identity, its cotangent summed over the model
    group in float32."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _sum_f32(grad, ctx.mesh).to(grad.dtype), None


class _ModelSum(torch.autograd.Function):
    """Megatron's "g": the float32 sum over the model group, its cotangent
    passed back as it is."""

    @staticmethod
    def forward(ctx, t, mesh):
        return _sum_f32(t, mesh).to(t.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLast(torch.autograd.Function):
    """Every rank's columns in rank order; the cotangent that reaches the
    rank is its own columns' (no sum: every rank of the group holds the
    same rows and computes the same function of the whole)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.lo, ctx.n = mesh.rank * t.shape[-1], t.shape[-1]
        return all_gather_last(t.detach(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.lo:ctx.lo + ctx.n].contiguous(), None


def model_input(t: torch.Tensor, mesh) -> torch.Tensor:
    """The replicated input of a column split (Megatron's "f"): ``t`` as
    it is, its cotangent summed over ``mesh``'s ranks in float32 before
    any cast rounds it (one all-reduce in the backward, none forward)."""
    return _ModelInput.apply(t, mesh)


def model_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """A row split's partial products summed over ``mesh``'s ranks in
    float32 (Megatron's "g": one all-reduce forward, none backward)."""
    return _ModelSum.apply(t, mesh)


def gather_last(t: torch.Tensor, mesh) -> torch.Tensor:
    """A vocab-split head's columns gathered along the last dim (one
    all-gather), its backward the rank's own columns of the cotangent: a
    reduce-scatter (``owned_whole``'s) would multiply them by the group's
    size, since every rank of it computes the same loss."""
    return _GatherLast.apply(t, mesh)


def barrier(mesh) -> None:
    """Every rank of ``mesh`` waits here until all have arrived."""
    _counted(lambda: dist.barrier(group=mesh.group))
