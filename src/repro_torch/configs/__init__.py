from repro_torch.configs.base import (
    ARCH_REGISTRY,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
    list_archs,
    reduced_config,
)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCH_REGISTRY", "get_config",
           "list_archs", "reduced_config"]
