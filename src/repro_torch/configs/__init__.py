from repro_torch.configs.base import (
    ARCH_REGISTRY,
    ModelConfig,
    get_config,
    reduced_config,
)

__all__ = ["ModelConfig", "ARCH_REGISTRY", "get_config", "reduced_config"]
