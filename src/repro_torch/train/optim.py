"""Optimizers (AdamW, SGD+momentum), the warmup-cosine schedule and
global-norm clipping, on parameter dicts.

Each update runs the JAX package's ``train/optim.py`` operations in its
order and dtypes (float32 moments, also beside bfloat16 parameters, whose
update is computed in float32 and rounded once; a float32 0-dim ``step``),
so one step agrees with it to float32 roundoff; ``torch.optim.AdamW`` orders its
operations differently.  Unlike the JAX package, ``apply_updates`` writes
the parameters and moments in place: at granite-3-2b's full width a second
copy of the float32 parameters and both moments (about 32 GB) would not fit
beside the first on one 80 GB card.  It also walks each leaf in flat chunks
of at most ``LEAF_CHUNK`` elements, so its temporaries stay a few chunks
in size where a stacked weight's would be a few copies of the stack
(zamba2-2.7b's stacked ``in_proj`` is 5.8 GB); the update is elementwise,
so the chunks change no value.

Under a training mesh (``make_train_step(..., mesh=)``) the leaves are
the rank's parts (``parallel/fsdp.py``): the update stays elementwise on
them, and the global norm sums each leaf's squares over the ranks that
hold its other parts in one SUM all-reduce over the mesh, counting each
part once however many ranks replicate it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import train_axes
from repro_torch.parallel.collectives import all_reduce_sum
from repro_torch.train.tree import LEAF_CHUNK, leaves, tree_map

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


def global_norm(tree: Any, mesh=None, split: Optional[Sequence[Sequence[str]]] = None
                ) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in leaf order.  Under a
    training ``mesh`` each leaf's sum spans the ranks: ``split[i]`` names
    the axes (``"data"``, ``"model"``) whose ranks hold other parts of leaf
    i; of the ranks that hold the same part (along the other axes, the
    pods among them) the first alone counts it, and one all-reduce over
    the mesh adds them."""
    sq = [x.to(torch.float32).square().sum() for x in leaves(tree)]
    if mesh is not None:
        ax = train_axes(mesh)
        lines = {"data": ax.data, "model": ax.model, "pod": ax.pod}
        v = torch.stack(sq)
        counts = [all(a is None or a.rank == 0 or name in s for name, a in lines.items())
                  for s in split]
        if not all(counts):
            v = torch.where(torch.tensor(counts, device=v.device), v, 0.0)
        if ax.world is not None:
            v = all_reduce_sum(v, ax.world)
        sq = list(v.unbind())
    return torch.sqrt(sum(sq))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0)


def clip_by_global_norm(tree: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    gn = global_norm(tree)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda x: x * scale, tree), gn


def _chunks(*trees_leaves):
    """Corresponding flat chunks (views) of each leaf list's leaves, at most
    ``LEAF_CHUNK`` elements each; in-place ops on them write the leaves."""
    for ts in zip(*trees_leaves):
        flat = [t.view(-1) for t in ts]
        yield from zip(*(f.split(LEAF_CHUNK) for f in flat))


@torch.no_grad()
def apply_updates(
    cfg: OptConfig, params: Any, grads: Any, state: Dict[str, Any], *, mesh=None,
    split: Optional[Sequence[Sequence[str]]] = None,
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One optimizer step: clips ``grads`` by global norm, updates
    ``params`` and the moments in ``state`` in place, and returns
    ``(params, new_state, {"grad_norm", "lr"})``.  Under a training
    ``mesh`` the leaves are the rank's parts, ``split`` as
    ``global_norm``'s."""
    gn = global_norm(grads, mesh, split)
    scale = _clip_scale(gn, cfg.clip_norm) if cfg.clip_norm > 0 else None
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    ps, ms = leaves(params), leaves(state["m"])
    gs = [g.contiguous() for g in leaves(grads)]

    def clipped(g):
        # float32 first: a bfloat16 gradient times the float32 scale is a
        # float32 product, as in the JAX package
        g = g.to(torch.float32)
        return g * scale if scale is not None else g

    if cfg.kind == "adamw":
        b1, b2 = cfg.beta1, cfg.beta2
        vs = leaves(state["v"])
        for g, m_, v_ in _chunks(gs, ms, vs):
            g = clipped(g)
            m_.mul_(b1).add_((1 - b1) * g)
            v_.mul_(b2).add_((1 - b2) * g.square())
        stepf = step.to(torch.float32)
        c1 = 1 - b1 ** stepf
        c2 = 1 - b2 ** stepf
        for p, m_, v_ in _chunks(ps, ms, vs):
            den = (v_ / c2).sqrt_().add_(cfg.eps)
            u = (m_ / c1).div_(den)
            del den
            u.add_(cfg.weight_decay * p.to(torch.float32))
            p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))
        new_state = {"step": step, "m": state["m"], "v": state["v"]}
    else:  # sgd + momentum
        for p, g, m_ in _chunks(ps, gs, ms):
            m_.mul_(cfg.momentum).add_(clipped(g))
            p.copy_((p.to(torch.float32) - lr * m_).to(p.dtype))
        new_state = {"step": step, "m": state["m"]}
    return params, new_state, {"grad_norm": gn, "lr": lr}
