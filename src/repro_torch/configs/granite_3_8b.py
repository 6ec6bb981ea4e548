"""IBM Granite-3 8B — dense llama-style decoder with GQA.

[hf:ibm-granite/granite-3.0-8b-base]
40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
"""

from repro_torch.configs.base import ModelConfig, register


@register("granite-3-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b",
        family="dense",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=12800,
        vocab_size=49155,
        attention_type="gqa",
        rope_type="rope",
        rope_theta=10_000.0,
        mlp_type="swiglu",
        tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-8b-base",
    )
