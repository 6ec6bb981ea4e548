"""Configuration system for the PyTorch port.

A copy of the JAX package's ``configs/base.py`` (the port imports nothing of
that package): :class:`ModelConfig` with its sub-configs, :class:`ShapeConfig`,
the registry and the smoke reduction.  The registry lists only the
architectures the port ships; other families arrive with their model code.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional


def _round_up(x: int, to: int) -> int:
    return ((x + to - 1) // to) * to


# --------------------------------------------------------------------------
# Sub-configs
# --------------------------------------------------------------------------


@dataclass
class MoEConfig:
    """Mixture-of-experts FFN configuration (sort-based capacity dispatch)."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0            # total shared-expert hidden width
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # Layers that use a dense FFN instead of MoE (e.g. DeepSeek layer 0).
    num_dense_layers: int = 0
    d_ff_dense: int = 0
    # Locality-aware dispatch: tokens are routed within ``dispatch_groups``
    # independent groups (launcher sets this to the DP shard count), so the
    # sort/scatter stays shard-local and only the expert-parallel exchange
    # crosses the mesh.  1 = single global dispatch.
    dispatch_groups: int = 1
    # "grouped" (GSPMD, default) | "a2a" (shard_map ragged all-to-all over
    # the EP axis — §Perf; single-pod meshes, E % tp == 0)
    impl: str = "grouped"


@dataclass
class SSMConfig:
    """Mamba2 (SSD) configuration."""

    state_dim: int = 64             # N
    head_dim: int = 64              # P
    expand: int = 2                 # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 256
    n_groups: int = 1               # B/C groups (GVA)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass
class RWKVConfig:
    """RWKV6 ("Finch") time-mix configuration."""

    head_dim: int = 64
    decay_lora: int = 64            # rank of the data-dependent decay LoRA
    mix_lora: int = 32              # rank of the token-shift mixing LoRA
    gate_lora: int = 64


@dataclass
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass
class HybridConfig:
    """Zamba2-style hybrid: Mamba2 backbone + shared attention blocks.

    ``attn_every`` Mamba blocks are followed by one application of a *shared*
    transformer block; ``num_shared_blocks`` distinct weight sets are rotated
    (Zamba2 uses 2 alternating shared blocks).
    """

    attn_every: int = 6
    num_shared_blocks: int = 2


# --------------------------------------------------------------------------
# Model config
# --------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclass
class ModelConfig:
    name: str
    family: str                     # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0               # 0 -> d_model // num_heads

    # --- attention ---
    attention_type: str = "gqa"     # gqa | mla | none
    rope_type: str = "rope"         # rope | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: tuple = (16, 24, 24)   # qwen2-vl M-RoPE (sums to head_dim/2)
    sliding_window: int = 0         # 0 -> full attention
    attn_logit_softcap: float = 0.0

    # --- mlp ---
    mlp_type: str = "swiglu"        # swiglu | gelu | relu2 | rwkv
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- optional subsystems ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    mla: Optional[MLAConfig] = None
    hybrid: Optional[HybridConfig] = None

    # --- encoder/decoder (encdec family) ---
    num_encoder_layers: int = 0
    # Source length used for cross-attention when decoding (frames already
    # encoded); the modality frontend is a stub per the assignment.
    encdec_source_len: int = 4096

    # --- vlm (qwen2-vl): number of stubbed patch-embedding positions ---
    vlm_num_patches: int = 1024

    # --- numerics / scaling ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    vocab_pad_to: int = 2048        # pad vocab so it shards over the TP axis

    # Citation / provenance string for the config (public literature).
    source: str = ""

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.head_dim == 0 and self.num_heads > 0:
            self.head_dim = self.d_model // self.num_heads

    # -- derived ----------------------------------------------------------

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_to)


# --------------------------------------------------------------------------
# Shapes
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_REGISTRY: dict[str, Any] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def available_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {available_archs()}")
    cfg = _REGISTRY[name]()
    if smoke:
        cfg = reduce_for_smoke(cfg)
    return cfg


_LOADED = False

ARCH_MODULES = [
    "granite_3_8b",
    "lms_demo",
    "zamba2_7b",
]


def _load_all():
    global _LOADED
    if _LOADED:
        return
    import importlib
    for mod in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True


# --------------------------------------------------------------------------
# Smoke reduction: same family, tiny dims
# --------------------------------------------------------------------------


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduce a config to a CPU-runnable variant of the same family."""
    c = dataclasses.replace(cfg)
    c.name = cfg.name + "-smoke"
    c.num_layers = min(cfg.num_layers, 2)
    c.d_model = 64
    c.num_heads = 4
    c.num_kv_heads = min(max(1, cfg.num_kv_heads * 4 // max(cfg.num_heads, 1)), 4)
    c.head_dim = 16
    c.d_ff = 128
    c.vocab_size = 512
    c.vocab_pad_to = 128
    c.encdec_source_len = 32
    c.vlm_num_patches = 8
    if cfg.family == "encdec":
        c.num_encoder_layers = 2
    if cfg.moe is not None:
        c.moe = dataclasses.replace(
            cfg.moe,
            num_experts=4,
            top_k=min(2, cfg.moe.top_k),
            capacity_factor=4.0,      # smoke: avoid drops so the decode-vs-
                                      # train parity checks stay meaningful
            d_ff_expert=64,
            d_ff_shared=64 if cfg.moe.num_shared_experts else 0,
            num_dense_layers=min(1, cfg.moe.num_dense_layers),
            d_ff_dense=128 if cfg.moe.num_dense_layers else 0,
        )
    if cfg.ssm is not None:
        c.ssm = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=16, chunk_size=16)
    if cfg.rwkv is not None:
        c.rwkv = dataclasses.replace(
            cfg.rwkv, head_dim=16, decay_lora=8, mix_lora=8, gate_lora=8)
    if cfg.hybrid is not None:
        c.hybrid = dataclasses.replace(cfg.hybrid, attn_every=1,
                                       num_shared_blocks=2)
        c.num_layers = 2
    if cfg.mla is not None:
        c.mla = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                          qk_nope_head_dim=16, qk_rope_head_dim=8,
                          v_head_dim=16)
        c.head_dim = 24   # nope+rope
    if cfg.sliding_window:
        c.sliding_window = 16
    if cfg.rope_type == "mrope":
        c.mrope_sections = (4, 2, 2)   # sums to head_dim/2 = 8
    return c
