"""int8 gradient compression with error feedback (the JAX package's
``train/compression.py``): each gradient leaf plus its carried residual is
quantized to int8 with a per-leaf symmetric scale and dequantized; the
quantization residual is carried to the next step so the bias vanishes
over steps.  Under a training mesh each leaf is the rank's part of the
global gradient (``parallel/fsdp.py``): its scale comes from the max over
the ranks' parts, one MAX all-reduce over the mesh for all leaves (ranks
that hold the same part add nothing to a max), so every element is
quantized as the whole leaf's would be."""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.launch.mesh import train_axes
from repro_torch.parallel.collectives import all_reduce_max
from repro_torch.train.tree import leaves, tree_map, unflatten

__all__ = ["compress_decompress"]


def _q8(x: torch.Tensor, amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes of ``x`` on the symmetric scale of its leaf's ``amax``."""
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(grads: Any, err: Optional[Any], mesh=None) -> Tuple[Any, Any]:
    """Returns (decompressed grads, new error buffers); under a training
    ``mesh`` each leaf's scale spans the ranks' parts."""
    if err is None:
        err = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                       grads)
    gs, es = leaves(grads), leaves(err)
    amax = [(g.to(torch.float32) + e).abs().max() for g, e in zip(gs, es)]
    world = None if mesh is None else train_axes(mesh).world
    if world is not None:
        amax = list(all_reduce_max(torch.stack(amax), world).unbind())

    def one(g, e, a):
        gf = g.to(torch.float32) + e
        q, s = _q8(gf, a)
        deq = q.to(torch.float32) * s
        return deq.to(g.dtype), gf - deq

    pairs = [one(g, e, a) for g, e, a in zip(gs, es, amax)]
    return unflatten(grads, (p[0] for p in pairs)), unflatten(err, (p[1] for p in pairs))
