"""int8 gradient compression with error feedback (the JAX package's
``train/compression.py``): each gradient leaf plus its carried residual is
quantized to int8 with a per-leaf symmetric scale and dequantized; the
quantization residual is carried to the next step so the bias vanishes
over steps."""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.train.tree import tree_map

__all__ = ["compress_decompress"]


def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(grads: Any, err: Optional[Any]) -> Tuple[Any, Any]:
    """Returns (decompressed grads, new error buffers)."""
    if err is None:
        err = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                       grads)

    def one(g, e):
        gf = g.to(torch.float32) + e
        q, s = _q8(gf)
        deq = q.to(torch.float32) * s
        return deq.to(g.dtype), gf - deq

    pairs = tree_map(one, grads, err)       # leaves: (grad, error) tuples
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)
