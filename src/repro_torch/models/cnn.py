"""The paper's evaluation DNNs: LeNet, LeNet+, AlexNet, VGG16, ResNet-19.

Convolutions are lowered to im2col patches + ``dense``, so that every MAC
goes through the configured approximate multiplier (K1 in ``mode="kernel"``
on the card): the paper's platform semantics, approximate multipliers
inside the conv and FC arrays.  This is the JAX package's
``models/cnn.py`` in PyTorch, on the same layout: activations NHWC, conv
weights HWIO, patches flattened channel-slowest (``c*kh*kw + i*kw + j``) as
XLA's ``conv_general_dilated_patches`` flattens them, and ``"SAME"``
padding split as XLA splits it (the odd pixel goes high: a 3x3 stride-2
conv on an even map pads (0, 1)).  A model is a plain dict
``{"name", "layers": [per-layer param dicts], "defs": [layer defs]}``.

ResNet-19 follows the CIFAR variant common in the literature the paper draws
from: stem conv + 3 stages of basic blocks ({3,3,2} blocks, channels
128/256/512) + 2 FC layers = 19 weight layers, and 21 dense calls per
forward with the two projection shortcuts.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.approx import ApproxConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import dense, init_dense

__all__ = ["CNN_NAMES", "avg_pool", "batch_norm", "cnn_forward", "conv2d", "conv_patches",
           "init_cnn", "max_pool"]

CNN_NAMES = ("lenet", "lenet_plus", "alexnet", "vgg16", "resnet19")


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: out = ceil(size / stride),
    the total split low = total // 2, high = the rest."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_patches(x: torch.Tensor, kh: int, kw: int, stride: int, padding: str) -> torch.Tensor:
    """x (B, H, W, C) -> im2col patches (B, H', W', C*kh*kw), channel-slowest."""
    B, H, W, C = x.shape
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        (top, bottom), (left, right) = _same_pads(H, kh, stride), _same_pads(W, kw, stride)
        if top or bottom or left or right:
            xc = F.pad(xc, (left, right, top, bottom))
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r} is neither 'SAME' nor 'VALID'")
    Ho = (xc.shape[2] - kh) // stride + 1
    Wo = (xc.shape[3] - kw) // stride + 1
    cols = F.unfold(xc, (kh, kw), stride=stride)          # (B, C*kh*kw, Ho*Wo)
    return cols.transpose(1, 2).reshape(B, Ho, Wo, C * kh * kw)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int = 1,
           padding: str = "SAME", cfg: ApproxConfig) -> torch.Tensor:
    """x (B, H, W, C) * w (kh, kw, C, O) via im2col + approximate dense."""
    kh, kw, C, O = w.shape
    patches = conv_patches(x, kh, kw, stride, padding)
    wmat = w.permute(2, 0, 1, 3).reshape(C * kh * kw, O)
    return dense(patches, wmat, cfg) + b


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """VALID (floor) max pooling of NHWC ``x``."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """VALID (floor) mean pooling of NHWC ``x``."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1)


def batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Batch statistics always (no running stats), population variance."""
    mu = x.mean(dim=(0, 1, 2), keepdim=True)
    var = x.var(dim=(0, 1, 2), keepdim=True, correction=0)
    return gamma * (x - mu) * torch.rsqrt(var + eps) + beta


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _conv_init(kh: int, kw: int, c: int, o: int, gen: torch.Generator,
               dev: torch.device) -> torch.Tensor:
    """He init: a standard normal truncated to [-2, 2] times sqrt(2 / fan_in)."""
    t = torch.empty((kh, kw, c, o), dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * math.sqrt(2.0 / (kh * kw * c))


def _layer_defs(name: str, num_classes: int) -> List[tuple]:
    """Declarative layer list: (kind, args...)."""
    if name == "lenet":
        return [
            ("conv", 5, 6, 1, "SAME"), ("relu",), ("avgpool",),
            ("conv", 5, 16, 1, "VALID"), ("relu",), ("avgpool",),
            ("flatten",), ("fc", 120), ("relu",), ("fc", 84), ("relu",), ("fc", num_classes),
        ]
    if name == "lenet_plus":   # paper's LeNet+ (extra conv layer)
        return [
            ("conv", 5, 6, 1, "SAME"), ("relu",), ("avgpool",),
            ("conv", 5, 16, 1, "VALID"), ("relu",),
            ("conv", 3, 32, 1, "SAME"), ("relu",), ("avgpool",),
            ("flatten",), ("fc", 120), ("relu",), ("fc", 84), ("relu",), ("fc", num_classes),
        ]
    if name == "alexnet":      # CIFAR-adapted AlexNet
        return [
            ("conv", 3, 64, 1, "SAME"), ("relu",), ("maxpool",),
            ("conv", 3, 192, 1, "SAME"), ("relu",), ("maxpool",),
            ("conv", 3, 384, 1, "SAME"), ("relu",),
            ("conv", 3, 256, 1, "SAME"), ("relu",),
            ("conv", 3, 256, 1, "SAME"), ("relu",), ("maxpool",),
            ("flatten",), ("fc", 1024), ("relu",), ("fc", 512), ("relu",), ("fc", num_classes),
        ]
    if name == "vgg16":
        cfgs = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
                512, 512, 512, "M"]
        out: List[tuple] = []
        for c in cfgs:
            if c == "M":
                out.append(("maxpool",))
            else:
                out += [("conv", 3, c, 1, "SAME"), ("bn",), ("relu",)]
        out += [("flatten",), ("fc", 512), ("relu",), ("fc", 512), ("relu",), ("fc", num_classes)]
        return out
    if name == "resnet19":
        out = [("conv", 3, 128, 1, "SAME"), ("bn",), ("relu",)]
        for (blocks, ch, stride) in [(3, 128, 1), (3, 256, 2), (2, 512, 2)]:
            for b in range(blocks):
                out.append(("resblock", ch, stride if b == 0 else 1))
        out += [("gap",), ("fc", 256), ("relu",), ("fc", num_classes)]
        return out
    raise KeyError(name)


def init_cnn(name: str, seed: int = 0, *, in_shape=(32, 32, 3), num_classes: int = 10,
             device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Shape-inferring init from a seeded ``torch.Generator`` on ``device``
    (the CUDA device unless given; raises without one), with the JAX
    package's init: truncated-normal He init for convs, std 1/sqrt(fan_in)
    for FC weights, zero biases, unit BN scales.  The tests bring the JAX
    package's own weights across with ``bridge.cnn_from_numpy`` instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    zeros = lambda n: torch.zeros((n,), device=dev)
    ones = lambda n: torch.ones((n,), device=dev)
    defs = _layer_defs(name, num_classes)
    params: List[Dict[str, torch.Tensor]] = []
    h, w, c = in_shape
    for d in defs:
        kind = d[0]
        if kind == "conv":
            ksz, o, stride, pad = d[1], d[2], d[3], d[4]
            params.append({"w": _conv_init(ksz, ksz, c, o, gen, dev), "b": zeros(o)})
            h = h // stride if pad == "SAME" else (h - ksz) // stride + 1
            w = w // stride if pad == "SAME" else (w - ksz) // stride + 1
            c = o
        elif kind == "bn":
            params.append({"gamma": ones(c), "beta": zeros(c)})
        elif kind == "resblock":
            ch, stride = d[1], d[2]
            blk = {
                "w1": _conv_init(3, 3, c, ch, gen, dev), "b1": zeros(ch),
                "g1": ones(ch), "be1": zeros(ch),
                "w2": _conv_init(3, 3, ch, ch, gen, dev), "b2": zeros(ch),
                "g2": ones(ch), "be2": zeros(ch),
            }
            if stride != 1 or c != ch:
                blk["wp"] = _conv_init(1, 1, c, ch, gen, dev)
                blk["bp"] = zeros(ch)
            params.append(blk)
            h, w, c = h // stride, w // stride, ch
        elif kind in ("maxpool", "avgpool"):
            params.append({})
            h, w = h // 2, w // 2
        elif kind == "gap":
            params.append({})
            h = w = 1
        elif kind == "flatten":
            params.append({})
            c = h * w * c
            h = w = 1
        elif kind == "fc":
            o = d[1]
            params.append({"w": init_dense(c, o, gen, dev), "b": zeros(o)})
            c = o
        elif kind == "relu":
            params.append({})
        else:
            raise KeyError(kind)
    return {"name": name, "layers": params, "defs": defs}


def cnn_forward(model: Dict[str, Any], x: torch.Tensor, cfg: ApproxConfig) -> torch.Tensor:
    """x (B, H, W, C) float -> logits (B, classes)."""
    for d, p in zip(model["defs"], model["layers"]):
        kind = d[0]
        if kind == "conv":
            x = conv2d(x, p["w"], p["b"], stride=d[3], padding=d[4], cfg=cfg)
        elif kind == "bn":
            x = batch_norm(x, p["gamma"], p["beta"])
        elif kind == "relu":
            x = torch.relu(x)
        elif kind == "maxpool":
            x = max_pool(x)
        elif kind == "avgpool":
            x = avg_pool(x)
        elif kind == "gap":
            x = x.mean(dim=(1, 2))
        elif kind == "flatten":
            x = x.reshape(x.shape[0], -1)            # NHWC: (h, w, c) order
        elif kind == "fc":
            x = dense(x, p["w"], cfg) + p["b"]
        elif kind == "resblock":
            stride = d[2]
            h = conv2d(x, p["w1"], p["b1"], stride=stride, padding="SAME", cfg=cfg)
            h = torch.relu(batch_norm(h, p["g1"], p["be1"]))
            h = conv2d(h, p["w2"], p["b2"], stride=1, padding="SAME", cfg=cfg)
            h = batch_norm(h, p["g2"], p["be2"])
            sc = x
            if "wp" in p:
                sc = conv2d(x, p["wp"], p["bp"], stride=stride, padding="SAME", cfg=cfg)
            x = torch.relu(h + sc)
        else:
            raise KeyError(kind)
    return x
