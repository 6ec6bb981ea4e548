"""Yi-34B — dense llama-architecture decoder with GQA.

[arXiv:2403.04652; hf:01-ai/Yi-34B]
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
"""

from repro_torch.configs.base import ModelConfig, register


@register("yi-34b")
def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b",
        family="dense",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64000,
        attention_type="gqa",
        rope_type="rope",
        rope_theta=5_000_000.0,
        mlp_type="swiglu",
        source="arXiv:2403.04652 (Yi); hf",
    )
