"""Architecture configs the port ships (lms-demo, granite-3-8b, zamba2-7b)."""

from repro_torch.configs.base import (
    ARCH_MODULES,
    HybridConfig,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    RWKVConfig,
    SHAPES,
    SMOKE_SHAPE,
    SSMConfig,
    ShapeConfig,
    TrainConfig,
    available_archs,
    get_config,
    reduce_for_smoke,
)

__all__ = [
    "ARCH_MODULES",
    "HybridConfig",
    "MLAConfig",
    "MoEConfig",
    "ModelConfig",
    "RWKVConfig",
    "SHAPES",
    "SMOKE_SHAPE",
    "SSMConfig",
    "ShapeConfig",
    "TrainConfig",
    "available_archs",
    "get_config",
    "reduce_for_smoke",
]
