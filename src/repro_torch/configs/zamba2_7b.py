"""Zamba2-7B — hybrid Mamba2 backbone with shared attention blocks.

[arXiv:2411.15242]
81 Mamba2 layers d_model=3584, shared transformer blocks (32H MHA,
d_ff=14336) applied every 6 Mamba blocks with 2 alternating weight sets,
vocab=32000, ssm_state=64.
"""

from repro_torch.configs.base import (
    HybridConfig, ModelConfig, SSMConfig, register)


@register("zamba2-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=81,               # mamba2 blocks
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,             # shared blocks use MHA
        head_dim=112,
        d_ff=14336,
        vocab_size=32000,
        attention_type="gqa",
        rope_type="rope",
        rope_theta=10_000.0,
        mlp_type="swiglu",
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                      chunk_size=256, n_groups=1),
        hybrid=HybridConfig(attn_every=6, num_shared_blocks=2),
        source="arXiv:2411.15242 (Zamba2)",
    )
