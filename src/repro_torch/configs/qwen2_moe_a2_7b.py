"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=151936, 60 routed experts top-4 + shared expert (4x1408=5632).
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.configs.base import ModelConfig, register

register(
    ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,
        vocab_size=151936,
        moe_experts=60,
        moe_top_k=4,
        moe_shared_ff=5632,
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    )
)
