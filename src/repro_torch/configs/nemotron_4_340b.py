"""Nemotron-4 340B — dense decoder with GQA and squared-ReLU MLP.

[arXiv:2402.16819 (Nemotron-4 15B) / 2406.11704 (340B)]
96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000, squared-ReLU.
"""

from repro_torch.configs.base import ModelConfig, register


@register("nemotron-4-340b")
def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b",
        family="dense",
        num_layers=96,
        d_model=18432,
        num_heads=96,
        num_kv_heads=8,
        head_dim=192,
        d_ff=73728,
        vocab_size=256000,
        attention_type="gqa",
        rope_type="rope",
        rope_theta=10_000.0,
        mlp_type="relu2",            # squared-ReLU
        norm_type="layernorm",
        source="arXiv:2402.16819 / 2406.11704 (Nemotron-4)",
    )
