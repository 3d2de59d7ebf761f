"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
M-RoPE, dynamic resolution [arXiv:2409.12191; hf]. Backbone only — the vision
frontend is a stub: the caller provides patch embeddings."""
from repro_torch.configs.base import ModelConfig, register

register(
    ModelConfig(
        name="qwen2-vl-2b",
        family="vlm",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        pos_embedding="m_rope",
        m_rope_sections=(16, 24, 24),   # head_dim=128 -> hd/2=64 split t/h/w
        rope_theta=1000000.0,
        embed_input=False,
        source="arXiv:2409.12191; hf",
    )
)
