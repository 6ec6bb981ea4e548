"""Phi-3 Medium 14B — dense decoder, RoPE + SwiGLU + GQA (kv=10).

[arXiv:2404.14219]
40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
"""

from repro_torch.configs.base import ModelConfig, register


@register("phi3-medium-14b")
def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=10,
        head_dim=128,
        d_ff=17920,
        vocab_size=100352,
        attention_type="gqa",
        rope_type="rope",
        rope_theta=10_000.0,
        mlp_type="swiglu",
        source="arXiv:2404.14219 (Phi-3)",
    )
