"""Model configuration: ``ModelConfig`` (exact public spec of each
registered architecture), the registry, and ``reduced_config`` (the
same-family CPU test variant with tiny dims).

This slice of the port registers the dense family only (granite-3-2b);
the fields of the other families arrive with their own slices.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.core.approx import ApproxConfig

__all__ = [
    "ModelConfig",
    "ARCH_REGISTRY",
    "register",
    "get_config",
    "reduced_config",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    rope_theta: float = 10000.0
    # --- the paper's feature ---
    approx: ApproxConfig = ApproxConfig(mode="float")
    # --- numerics ---
    dtype: str = "bfloat16"           # activation dtype
    remat: bool = True                # recompute each layer in the backward
    source: str = ""                  # citation tag

    def __post_init__(self):
        if self.family != "dense":
            raise ValueError(f"family {self.family!r}: this port serves the dense family only")
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """LM-head columns padded to a 512 multiple; padded columns are
        masked to -1e30 and embeddings stay at the true vocab."""
        return -(-self.vocab_size // 512) * 512


ARCH_REGISTRY: Dict[str, ModelConfig] = {}

_ARCH_MODULES = ("granite_3_2b",)


def register(cfg: ModelConfig) -> ModelConfig:
    ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def _load_all():
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get_config(name: str) -> ModelConfig:
    if not ARCH_REGISTRY:
        _load_all()
    key = name.replace("-", "_")
    for k, v in ARCH_REGISTRY.items():
        if k.replace("-", "_") == key:
            return v
    raise KeyError(f"unknown arch {name!r}; have {sorted(ARCH_REGISTRY)}")


def reduced_config(cfg: ModelConfig, **over) -> ModelConfig:
    """Tiny same-family variant for CPU tests (the JAX package's
    ``reduced_config`` widths: 2 layers, d 128, 4 heads, <= 2 KV heads,
    head_dim 32, d_ff 256, vocab <= 512, float32, no remat)."""
    kw = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=32,
        d_ff=256,
        vocab_size=min(cfg.vocab_size, 512),
        dtype="float32",
        remat=False,
    )
    kw.update(over)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
