from repro_torch.kernels.approx_matmul.ops import approx_matmul, feature_tables
from repro_torch.kernels.approx_matmul.ref import (approx_matmul_lut, approx_matmul_plain,
                                                   approx_mul_elementwise)

__all__ = ["approx_matmul", "approx_matmul_lut", "approx_matmul_plain", "approx_mul_elementwise",
           "feature_tables"]
