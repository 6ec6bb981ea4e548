"""Qwen2-VL 7B — VLM decoder backbone with M-RoPE and dynamic resolution.

[arXiv:2409.12191; hf:Qwen/Qwen2-VL-7B-Instruct]
28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

The vision frontend (ViT) is a STUB per the assignment: ``input_specs()``
supplies precomputed patch embeddings merged into the token stream, plus
3-component (t, h, w) M-RoPE position ids.
"""

from repro_torch.configs.base import ModelConfig, register


@register("qwen2-vl-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        attention_type="gqa",
        rope_type="mrope",
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),   # sums to head_dim/2 = 64
        mlp_type="swiglu",
        vlm_num_patches=1024,
        source="arXiv:2409.12191 (Qwen2-VL); hf",
    )
