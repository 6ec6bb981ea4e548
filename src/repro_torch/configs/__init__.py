"""Architecture configs the port ships (lms-demo, granite-3-8b)."""

from repro_torch.configs.base import (
    ARCH_MODULES,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    RWKVConfig,
    SSMConfig,
    ShapeConfig,
    available_archs,
    get_config,
    reduce_for_smoke,
)

__all__ = [
    "ARCH_MODULES",
    "MLAConfig",
    "MoEConfig",
    "ModelConfig",
    "RWKVConfig",
    "SSMConfig",
    "ShapeConfig",
    "available_archs",
    "get_config",
    "reduce_for_smoke",
]
