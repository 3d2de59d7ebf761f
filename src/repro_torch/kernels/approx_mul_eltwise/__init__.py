from repro_torch.kernels.approx_mul_eltwise.ops import (
    DESIGNS,
    UnsupportedMultiplierError,
    approx_mul_eltwise,
    lut_mismatches,
)
from repro_torch.kernels.approx_mul_eltwise.ref import approx_mul_eltwise_plain

__all__ = ["DESIGNS", "UnsupportedMultiplierError", "approx_mul_eltwise",
           "approx_mul_eltwise_plain", "lut_mismatches"]
