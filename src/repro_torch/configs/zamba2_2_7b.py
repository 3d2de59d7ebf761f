"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240,
vocab=32000, ssm_state=64. Mamba-2 blocks + weight-shared attention block
applied every 6 layers (Zamba2 concatenates original embeddings into the
shared block; we apply it on the residual stream — noted simplification).
[arXiv:2411.15242; hf]."""
from repro_torch.configs.base import ModelConfig, register

register(
    ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=10240,
        vocab_size=32000,
        ssm_state=64,
        attn_every=6,
        source="arXiv:2411.15242; hf",
    )
)
