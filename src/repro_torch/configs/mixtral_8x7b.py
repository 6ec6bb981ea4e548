"""Mixtral 8x7B — sparse MoE (8 experts, top-2) with sliding-window attention.

[arXiv:2401.04088; hf:mistralai/Mixtral-8x7B-v0.1]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, SWA window 4096.
"""

from repro_torch.configs.base import MoEConfig, ModelConfig, register


@register("mixtral-8x7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        attention_type="gqa",
        rope_type="rope",
        rope_theta=1_000_000.0,
        sliding_window=4096,
        mlp_type="swiglu",
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336,
                      capacity_factor=1.25),
        source="arXiv:2401.04088 (Mixtral of Experts); hf",
    )
