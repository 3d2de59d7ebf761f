from repro_torch.kernels.paged_attention.ops import PagedAttentionShapeError, paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_plain

__all__ = ["paged_attention", "paged_attention_plain", "PagedAttentionShapeError"]
