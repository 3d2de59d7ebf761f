"""Shared layers.  Every projection routes through ``dense``, which applies
the approximate-multiplier pipeline when configured.  Under tensor
parallelism a weight is a ``Shard`` (``parallel/tp.shard_params``) and
``dense``, ``embed`` and ``gather_columns`` dispatch on its split, so the
model code calls them as it does unsharded.  Under data-parallel training
a weight is a ``DataPart`` (``parallel/fsdp.wrap``): ``unstack`` keeps
each layer's part, and ``dense`` and ``embed`` gather it whole where they
use it; a leaf read outside ``dense`` (the Mamba blocks' convolution and
scan parameters, a router) is read through ``whole``.  On a training
mesh with a model axis a ``DataPart`` may carry a split: once gathered it
computes as its ``Shard``, through the autograd-aware "f" and "g" and the
head's ``gather_last`` (``parallel/collectives.py``)."""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.approx import (
    ApproxConfig,
    DataPart,
    Gathered,
    QWeight,
    Shard,
    approx_dense,
    shard_info,
)
from repro_torch.parallel.collectives import gather_last, model_input, model_sum

__all__ = [
    "dense",
    "embed",
    "gather_columns",
    "init_dense",
    "rms_norm",
    "rotary",
    "apply_rope",
    "apply_m_rope",
    "sinusoidal_at",
    "sinusoidal_positions",
    "truncated_normal_init",
    "unstack",
    "whole",
]


def truncated_normal_init(shape, generator: Optional[torch.Generator], scale: float = 1.0,
                          device: Optional[torch.device] = None) -> torch.Tensor:
    """std = scale / sqrt(fan_in) times a standard normal truncated to
    [-2, 2] — the JAX package's init, drawn from a torch.Generator.  On the
    ``meta`` device (``generator`` None) only the shape is built: nothing
    is drawn."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * (scale / math.sqrt(fan_in))


def init_dense(d_in: int, d_out: int, generator: Optional[torch.Generator],
               device: Optional[torch.device] = None) -> torch.Tensor:
    return truncated_normal_init((d_in, d_out), generator, device=device)


def dense(x: torch.Tensor, w, cfg: ApproxConfig) -> torch.Tensor:
    """x (..., K) @ w (K, N) under the configured multiplier semantics;
    ``w`` may be a frozen ``QWeight`` (serving path) or a ``Shard``: a
    column split gives the rank's output columns (its input's cotangent
    summed over the ranks, "f"), a row split (``x`` the rank's K-part) the
    whole output, its float partial products summed over the ranks in
    float32 ("g").  A ``DataPart`` is gathered here (to its ``Shard`` where
    the model axis splits it); a ``Gathered`` piece computes as its float
    weight."""
    if isinstance(w, DataPart) and cfg.mode == "float":
        w = w.sharded(w.whole())
    if isinstance(w, Gathered) and cfg.mode == "float":
        w = w.w
    local = w.w if isinstance(w, Shard) else w
    if isinstance(local, QWeight) or cfg.mode != "float":
        return approx_dense(x, w, cfg).to(x.dtype)
    if isinstance(w, Shard) and w.split == "row":
        return model_sum(x.to(torch.float32) @ local.to(torch.float32), w.mesh).to(x.dtype)
    if isinstance(w, Shard) and w.split == "column":
        x = model_input(x, w.mesh)
    return x @ local.to(x.dtype)


def embed(tokens: torch.Tensor, table) -> torch.Tensor:
    """Rows of ``table`` (V, d) for ``tokens``, float32.  A vocab ``Shard``
    looks up the ids in the rank's rows, zeroes the others and sums over
    the ranks ("g"): exact, since each row is one rank's value plus zeros.
    A ``DataPart`` is gathered first (to its vocab ``Shard`` where the
    model axis splits it)."""
    if isinstance(table, DataPart):
        table = table.sharded(table.whole())
    if not isinstance(table, Shard):
        return F.embedding(tokens.long(), table)
    part, mesh = table.w, table.mesh
    lo = mesh.rank * part.shape[0]
    ids = tokens.long() - lo
    mine = (ids >= 0) & (ids < part.shape[0])
    rows = F.embedding(ids.clamp(0, part.shape[0] - 1), part)
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))
    return model_sum(rows, mesh)


def whole(w):
    """The tensor a leaf read outside ``dense`` computes with: a
    ``DataPart``'s whole weight (``DataPart.whole``: gathered, or for a
    replicated one the weight, each use's gradient summed over the ranks),
    anything else as it is."""
    return w.whole() if isinstance(w, DataPart) else w


def gather_columns(y: torch.Tensor, w) -> torch.Tensor:
    """``y`` = x @ ``w`` whole: the ranks' columns gathered in rank order
    where ``w`` is a column ``Shard`` (or a column-split ``DataPart``),
    each rank's cotangent its own columns', else ``y`` as it is."""
    info = shard_info(w)
    if info is not None and info[0] == "column":
        return gather_last(y, info[1])
    return y


def unstack(node, n: int):
    """A tree stacked on a leading axis of ``n`` (dicts of tensors,
    ``QWeight``s, ``Shard``s, ``DataPart``s and ``None`` leaves) as a list of ``n`` per-entry trees of
    views: the per-layer walk over stacked layers, and the per-expert walk
    over stacked experts.  A ``Shard`` stays a ``Shard`` of the same split
    (a layer of an expert ``Shard`` holds the rank's experts), and a
    ``DataPart`` a ``DataPart`` of the layer's part (the stacked axis never
    splits), gathered only where a layer uses it.  Under
    autograd the backward of ``unbind`` stacks the per-entry gradients
    once, where indexing would add one zero-padded full-size gradient per
    entry."""
    if isinstance(node, dict):
        per = {k: unstack(v, n) for k, v in node.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    if node is None:
        return [None] * n
    if isinstance(node, Shard):
        return [Shard(w, node.split, node.mesh) for w in unstack(node.w, n)]
    if isinstance(node, DataPart):
        return [node._replace(w=w) for w in node.w.unbind(0)]
    if isinstance(node, QWeight):
        fields = [t.unbind(0) if t.dim() > 0 else (t,) * n for t in node]
        return [QWeight(*(f[i] for f in fields)) for i in range(n)]
    return list(node.unbind(0))


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * gamma.to(x.dtype)


def rotary(positions: torch.Tensor, dim: int, theta: float = 10000.0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables, (..., dim//2)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def _rope_rotate(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(q, k, positions, theta: float = 10000.0):
    """q/k: (B, S, H, hd); positions: (B, S)."""
    cos, sin = rotary(positions, q.shape[-1], theta)       # (B, S, hd/2)
    cos = cos[:, :, None, :].to(q.dtype)
    sin = sin[:, :, None, :].to(q.dtype)
    return _rope_rotate(q, cos, sin), _rope_rotate(k, cos, sin)


def apply_m_rope(q, k, positions_thw: torch.Tensor, sections: Sequence[int],
                 theta: float = 1000000.0):
    """Qwen2-VL multimodal rope: ``positions_thw`` (B, 3, S) temporal,
    height and width position ids; ``sections`` split the rotary half
    (head_dim // 2) into three groups, each rotated by its own stream.
    With equal streams it is ``apply_rope``: the sections' frequencies
    concatenate to rope's."""
    hd = q.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"m_rope sections {tuple(sections)} do not sum to head_dim/2 "
                         f"= {hd // 2}")
    cos_parts, sin_parts, start = [], [], 0
    for i, sec in enumerate(sections):
        inv = 1.0 / (theta ** (torch.arange(start, start + sec, dtype=torch.float32,
                                            device=q.device) * 2.0 / hd))
        ang = positions_thw[:, i, :].to(torch.float32)[..., None] * inv
        cos_parts.append(torch.cos(ang))
        sin_parts.append(torch.sin(ang))
        start += sec
    cos = torch.cat(cos_parts, dim=-1)[:, :, None, :].to(q.dtype)
    sin = torch.cat(sin_parts, dim=-1)[:, :, None, :].to(q.dtype)
    return _rope_rotate(q, cos, sin), _rope_rotate(k, cos, sin)


def sinusoidal_at(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """(...,) int positions -> (..., dim) float32 sinusoidal embeddings,
    sin and cos interleaved (even columns sin, odd cos)."""
    inv = 1.0 / (10000 ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * inv              # (..., dim/2)
    out = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)     # (..., dim/2, 2)
    return out.reshape(*positions.shape, dim)


def sinusoidal_positions(seq_len: int, dim: int, offset: int = 0, *,
                         device=None) -> torch.Tensor:
    return sinusoidal_at(torch.arange(offset, offset + seq_len, device=device), dim)
