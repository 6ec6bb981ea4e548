"""SeamlessM4T-Large v2 — encoder-decoder multimodal (audio) transformer.

[arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large]
24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206.

The audio frontend (w2v-BERT conformer feature extractor) is a STUB per the
assignment: ``input_specs()`` supplies precomputed frame embeddings of shape
(batch, src_len, d_model).  We model the text decoder + a transformer encoder
over those embeddings (24 encoder + 24 decoder layers).
"""

from repro_torch.configs.base import ModelConfig, register


@register("seamless-m4t-large-v2")
def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="encdec",
        num_layers=24,               # decoder layers
        num_encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,             # MHA (kv=16)
        d_ff=8192,
        vocab_size=256206,
        attention_type="gqa",
        rope_type="none",            # seamless uses learned/relative pos; the
                                     # backbone here uses none + cross-attn
        mlp_type="gelu",
        norm_type="layernorm",
        encdec_source_len=4096,
        source="arXiv:2308.11596 (SeamlessM4T v2); hf",
    )
