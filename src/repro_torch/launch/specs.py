"""Stand-ins on the ``meta`` device for every input of a step: the port's
own tensors, with every shape and dtype and no data, built by the same
functions that build the real ones (nothing is allocated or drawn).
The dry run counts against these (``launch/dryrun.py``).

The layouts are the port's: parameter trees as ``init_params`` builds
them (the JAX package's named tuples as dicts, frozen weights as
``QWeight``s), and the slot cache with its trash position (``max_len +
1`` positions per row, where the JAX package's has ``max_len``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.transformer import init_cache, init_params
from repro_torch.serve.engine import freeze_params
from repro_torch.train import optim as O

__all__ = ["input_specs", "params_specs", "cache_specs", "state_specs"]

META = torch.device("meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Batch inputs for the shape's kind: train and prefill take the full
    (B, S), decode one new token (B, 1); a model without token inputs
    (vlm, audio) takes embeddings (B, S, d) in the activation dtype, and
    multimodal rope its (B, 3, S) position ids; train adds the labels."""
    B, S = shape.global_batch, shape.seq_len
    s_in = 1 if shape.kind == "decode" else S
    specs: Dict[str, torch.Tensor] = {}
    if cfg.embed_input:
        specs["tokens"] = torch.empty((B, s_in), dtype=torch.int32, device=META)
    else:
        specs["embeddings"] = torch.empty((B, s_in, cfg.d_model), dtype=getattr(torch, cfg.dtype),
                                          device=META)
    if cfg.pos_embedding == "m_rope" and shape.kind != "decode":
        specs["positions_thw"] = torch.empty((B, 3, s_in), dtype=torch.int32, device=META)
    if shape.kind == "train":
        specs["labels"] = torch.empty((B, S), dtype=torch.int32, device=META)
    return specs


def params_specs(cfg: ModelConfig, *, frozen: bool = False) -> Dict[str, Any]:
    """The parameter tree on ``meta``; ``frozen``: the serving layout, its
    projection weights frozen to ``QWeight``s (``freeze_params``; float
    execution keeps them float)."""
    params = init_params(cfg, device=META)
    return freeze_params(cfg, params) if frozen else params


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The slot-layout decode cache of ``shape.global_batch`` rows of
    ``shape.seq_len`` positions, in the activation dtype."""
    return init_cache(cfg, shape.global_batch, shape.seq_len, getattr(torch, cfg.dtype),
                      device=META)


def state_specs(cfg: ModelConfig, opt_cfg: O.OptConfig) -> Dict[str, Any]:
    """A training state: parameters in ``cfg.param_dtype`` and the
    optimizer's float32 state."""
    p = params_specs(cfg)
    return {"params": p, "opt": O.init_opt_state(opt_cfg, p)}
