"""lms-demo — ~115M-parameter llama-style model used by the runnable examples.

Not an assigned architecture; this is the "miniMD proxy app" analogue for the
LIKWID Monitoring Stack examples (paper Fig. 3): a small model the end-to-end
example can actually train for a few hundred steps on CPU while the
monitoring stack observes it.
"""

from repro_torch.configs.base import ModelConfig, register


@register("lms-demo")
def config() -> ModelConfig:
    return ModelConfig(
        name="lms-demo",
        family="dense",
        num_layers=8,
        d_model=512,
        num_heads=8,
        num_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab_size=32000,
        vocab_pad_to=256,
        attention_type="gqa",
        rope_type="rope",
        mlp_type="swiglu",
        tie_embeddings=True,
        source="llama-style demo config (this repo)",
    )
