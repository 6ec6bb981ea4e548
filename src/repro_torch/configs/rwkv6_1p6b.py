"""RWKV6 "Finch" 1.6B — attention-free RNN with data-dependent decay.

[arXiv:2404.05892]
24L d_model=2048 d_ff=7168 vocab=65536, head_dim 64 (32 heads).
"""

from repro_torch.configs.base import ModelConfig, RWKVConfig, register


@register("rwkv6-1.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        num_layers=24,
        d_model=2048,
        num_heads=32,                # d_model / head_dim
        num_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab_size=65536,
        attention_type="none",
        rope_type="none",
        mlp_type="rwkv",             # RWKV channel-mix (relu^2 + receptance)
        rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32, gate_lora=64),
        source="arXiv:2404.05892 (RWKV-6 Finch)",
    )
