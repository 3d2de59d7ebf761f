"""Optimizers (AdamW, SGD+momentum), the warmup-cosine schedule and
global-norm clipping, on parameter dicts.

Each update runs the JAX package's ``train/optim.py`` operations in its
order and dtypes (float32 moments, a float32 0-dim ``step``), so one step
agrees with it to float32 roundoff; ``torch.optim.AdamW`` orders its
operations differently.  Unlike the JAX package, ``apply_updates`` writes
the parameters and moments in place: at granite-3-2b's full width a second
copy of the float32 parameters and both moments (about 32 GB) would not fit
beside the first on one 80 GB card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.train.tree import leaves, tree_map

__all__ = [
    "OptConfig",
    "init_opt_state",
    "apply_updates",
    "global_norm",
    "clip_by_global_norm",
    "cosine_schedule",
]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"             # adamw | sgd
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    momentum: float = 0.9           # sgd
    clip_norm: float = 1.0          # 0 disables
    warmup_steps: int = 100
    total_steps: int = 10000


def cosine_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay; ``step`` an int32 0-dim tensor."""
    warm = torch.clamp(step.to(torch.float32) / float(max(cfg.warmup_steps, 1)), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps).to(torch.float32)
                    / float(max(cfg.total_steps - cfg.warmup_steps, 1)), 0, 1)
    return cfg.lr * warm * 0.5 * (1 + torch.cos(math.pi * t))


def init_opt_state(cfg: OptConfig, params: Any) -> Dict[str, Any]:
    dev = leaves(params)[0].device

    def zeros():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params)

    state: Dict[str, Any] = {"step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.kind == "adamw":
        state["m"] = zeros()
        state["v"] = zeros()
    elif cfg.kind == "sgd":
        state["m"] = zeros()
    else:
        raise ValueError(cfg.kind)
    return state


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(x.to(torch.float32).square().sum() for x in leaves(tree)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0)


def clip_by_global_norm(tree: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    gn = global_norm(tree)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda x: x * scale, tree), gn


@torch.no_grad()
def apply_updates(
    cfg: OptConfig, params: Any, grads: Any, state: Dict[str, Any]
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One optimizer step: clips ``grads`` by global norm, updates
    ``params`` and the moments in ``state`` in place, and returns
    ``(params, new_state, {"grad_norm", "lr"})``."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, cfg.clip_norm) if cfg.clip_norm > 0 else None
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    ps, gs, ms = leaves(params), leaves(grads), leaves(state["m"])

    def clipped(g):
        return g * scale if scale is not None else g

    if cfg.kind == "adamw":
        b1, b2 = cfg.beta1, cfg.beta2
        vs = leaves(state["v"])
        for g, m_, v_ in zip(gs, ms, vs):
            g = clipped(g).to(torch.float32)
            m_.mul_(b1).add_((1 - b1) * g)
            v_.mul_(b2).add_((1 - b2) * g.square())
        stepf = step.to(torch.float32)
        c1 = 1 - b1 ** stepf
        c2 = 1 - b2 ** stepf
        for p, m_, v_ in zip(ps, ms, vs):
            den = (v_ / c2).sqrt_().add_(cfg.eps)
            u = (m_ / c1).div_(den)
            del den
            u.add_(cfg.weight_decay * p.to(torch.float32))
            p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))
        new_state = {"step": step, "m": state["m"], "v": state["v"]}
    else:  # sgd + momentum
        for p, g, m_ in zip(ps, gs, ms):
            m_.mul_(cfg.momentum).add_(clipped(g).to(torch.float32))
            p.copy_((p.to(torch.float32) - lr * m_).to(p.dtype))
        new_state = {"step": step, "m": state["m"]}
    return params, new_state, {"grad_norm": gn, "lr": lr}
