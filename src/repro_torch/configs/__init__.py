"""Architecture configs the port ships, the reference's 11: lms-demo,
granite-3-8b, phi3-medium-14b, yi-34b, nemotron-4-340b (dense GQA),
mixtral-8x7b (MoE with a sliding window), deepseek-v2-236b (MoE with MLA),
qwen2-vl-7b (VLM with M-RoPE), zamba2-7b (hybrid), rwkv6-1.6b (RWKV6) and
seamless-m4t-large-v2 (encoder-decoder)."""

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
    supports_shape,
)

# the reference's assigned pool, in its order (lms-demo is not in it)
ASSIGNED_ARCHS = [
    "seamless-m4t-large-v2",
    "rwkv6-1.6b",
    "deepseek-v2-236b",
    "mixtral-8x7b",
    "nemotron-4-340b",
    "granite-3-8b",
    "yi-34b",
    "phi3-medium-14b",
    "qwen2-vl-7b",
    "zamba2-7b",
]

__all__ = [
    "ARCH_MODULES",
    "ASSIGNED_ARCHS",
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
    "supports_shape",
]
