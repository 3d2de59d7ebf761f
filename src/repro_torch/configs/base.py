"""Model configuration: ``ModelConfig`` (exact public spec of each
registered architecture), the registry, ``reduced_config`` (the
same-family CPU test variant with tiny dims), and the global shapes
(``SHAPES``: train_4k, prefill_32k, decode_32k, long_500k) that the dry
run counts.

Every family of the JAX package: dense, moe, ssm (Mamba-1), hybrid
(Mamba-2 with a weight-shared attention block), and the vlm and audio
backbones, whose frontends are stubs: they take embeddings (``embed_input``
False) and position them with multimodal rope (``m_rope``, over
``m_rope_sections`` of the rotary half) or sinusoids added to the input.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

from repro_torch.core.approx import ApproxConfig

__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "ARCH_REGISTRY",
    "FAMILIES",
    "register",
    "get_config",
    "list_archs",
    "reduced_config",
]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    # --- MoE ---
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared_ff: int = 0
    capacity_factor: float = 1.25
    # --- SSM ---
    ssm_state: int = 0
    d_inner: int = 0                  # 0 -> 2*d_model for ssm/hybrid
    dt_rank: int = 0                  # 0 -> ceil(d_model/16)
    conv_width: int = 4
    # --- hybrid (zamba2-style) ---
    attn_every: int = 0               # shared attn block after every k ssm layers
    # --- positions / input ---
    pos_embedding: str = "rope"       # rope | m_rope | sinusoidal
    rope_theta: float = 10000.0
    m_rope_sections: Tuple[int, ...] = ()
    # --- the paper's feature ---
    approx: ApproxConfig = ApproxConfig(mode="float")
    # --- numerics ---
    dtype: str = "bfloat16"           # activation dtype
    q_chunk: int = 512                # query chunk of prefill/training attention
    ssm_chunk: int = 256              # time chunk of the Mamba scans in forward
    remat: bool = True                # recompute each layer in the backward
    embed_input: bool = True          # False: the caller gives embeddings (vlm/audio stubs)
    # --- perf levers (the JAX package's) ---
    fuse_qkv: bool = False            # one quant+feature pass for q/k/v
    fuse_gate_up: bool = False        # one quant+feature pass for gate/up
    param_dtype: str = "float32"      # bf16 halves FSDP gather wire + memory
    source: str = ""                  # citation tag

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"family {self.family!r} not in {FAMILIES}")
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family in ("ssm", "hybrid"):
            if self.d_inner == 0:
                object.__setattr__(self, "d_inner", 2 * self.d_model)
            if self.dt_rank == 0:
                object.__setattr__(self, "dt_rank", -(-self.d_model // 16))

    @property
    def padded_vocab(self) -> int:
        """LM-head columns padded to a 512 multiple; padded columns are
        masked to -1e30 and embeddings stay at the true vocab."""
        return -(-self.vocab_size // 512) * 512

    @property
    def ssm_heads(self) -> int:
        """Mamba-2 head count (d_inner / 64-dim heads, zamba2 convention)."""
        return max(1, self.d_inner // 64)

    @property
    def supports_long_context(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def _attn_params(self) -> int:
        d = self.d_model
        return d * self.num_heads * self.head_dim * 2 + d * self.num_kv_heads * self.head_dim * 2

    def param_count(self) -> int:
        """Approximate parameter count (the N of MODEL_FLOPS = 6*N*D): the
        JAX package's arithmetic (true vocab, no norms, no conv/scan
        vectors but Mamba-1's ``a_log``)."""
        d, L = self.d_model, self.num_layers
        n = 0
        if self.embed_input:
            n += self.vocab_size * d
        n += self.vocab_size * d                       # lm head
        if self.family in ("dense", "moe", "vlm", "audio"):
            if self.family == "moe":
                ffn = self.moe_experts * 3 * d * self.d_ff + d * self.moe_experts
                ffn += 3 * d * self.moe_shared_ff
            else:
                ffn = 3 * d * self.d_ff
            n += L * (self._attn_params() + ffn)
        elif self.family == "ssm":
            di, N, dtr = self.d_inner, self.ssm_state, self.dt_rank
            n += L * (d * 2 * di + di * (dtr + 2 * N) + dtr * di + di * N + di * d)
        elif self.family == "hybrid":
            di, N, nh = self.d_inner, self.ssm_state, self.ssm_heads
            n += L * (d * (2 * di + 2 * N + nh) + di * d)
            n += self._attn_params() + 3 * d * self.d_ff   # shared block (once)
        return n

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k + shared experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.num_layers
        n = 2 * self.vocab_size * d
        ffn = self.moe_top_k * 3 * d * self.d_ff + 3 * d * self.moe_shared_ff \
            + d * self.moe_experts
        return n + L * (self._attn_params() + ffn)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_REGISTRY: Dict[str, ModelConfig] = {}

_ARCH_MODULES = (
    "yi_34b",
    "granite_3_2b",
    "deepseek_7b",
    "deepseek_coder_33b",
    "falcon_mamba_7b",
    "qwen2_moe_a2_7b",
    "grok_1_314b",
    "zamba2_2_7b",
    "qwen2_vl_2b",
    "musicgen_large",
)


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


def list_archs():
    if not ARCH_REGISTRY:
        _load_all()
    return sorted(ARCH_REGISTRY)


def reduced_config(cfg: ModelConfig, **over) -> ModelConfig:
    """Tiny same-family variant for CPU tests (the JAX package's
    ``reduced_config`` widths: 2 layers (a hybrid 4), d 128, 4 heads, <= 2
    KV heads, head_dim 32, d_ff 256, vocab <= 512, <= 4 experts top <= 2,
    shared expert ff 128, d_inner 256, dt_rank 8, ssm_state <= 16,
    attn_every 2, m_rope_sections (4, 6, 6), q_chunk 64, ssm_chunk 32,
    float32, no remat)."""
    kw = dict(
        num_layers=min(cfg.num_layers, 2 if cfg.family != "hybrid" else 4),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=32,
        d_ff=256,
        vocab_size=min(cfg.vocab_size, 512),
        moe_experts=min(cfg.moe_experts, 4),
        moe_top_k=min(cfg.moe_top_k, 2),
        moe_shared_ff=128 if cfg.moe_shared_ff else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        d_inner=256 if cfg.family in ("ssm", "hybrid") else 0,
        dt_rank=8 if cfg.family == "ssm" else 0,
        attn_every=2 if cfg.attn_every else 0,
        m_rope_sections=(4, 6, 6) if cfg.m_rope_sections else (),
        dtype="float32",
        q_chunk=64,
        ssm_chunk=32,
        remat=False,
    )
    kw.update(over)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
