"""DeepSeek-V2 236B — MoE with Multi-head Latent Attention (MLA).

[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2]
60L d_model=5120 128H d_ff(expert)=1536 vocab=102400,
MoE: 2 shared + 160 routed experts, top-6; MLA kv_lora_rank=512,
q_lora_rank=1536, qk_nope=128, qk_rope=64, v_head=128.
Layer 0 uses a dense FFN (d_ff=12288).
"""

from repro_torch.configs.base import (
    MLAConfig, MoEConfig, ModelConfig, register)


@register("deepseek-v2-236b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        head_dim=192,                # qk_nope(128) + qk_rope(64)
        d_ff=12288,                  # dense layer-0 FFN width
        vocab_size=102400,
        attention_type="mla",
        rope_type="rope",
        rope_theta=10_000.0,
        mlp_type="swiglu",
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536,
                      num_shared_experts=2, d_ff_shared=2 * 1536,
                      capacity_factor=1.25,
                      num_dense_layers=1, d_ff_dense=12288),
        source="arXiv:2405.04434 (DeepSeek-V2); hf",
    )
