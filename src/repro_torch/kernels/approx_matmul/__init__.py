from repro_torch.kernels.approx_matmul.ops import approx_matmul, feature_tables
from repro_torch.kernels.approx_matmul.ref import approx_matmul_plain

__all__ = ["approx_matmul", "approx_matmul_plain", "feature_tables"]
