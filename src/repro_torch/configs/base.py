"""Configuration system for the PyTorch port.

A copy of the JAX package's ``configs/base.py`` (the port imports nothing of
that package): :class:`ModelConfig` with its sub-configs and parameter
counts, :class:`ShapeConfig` with ``SHAPES`` and ``SMOKE_SHAPE``,
:class:`TrainConfig`, the registry and the smoke reduction.  ``MeshConfig``
and ``RunConfig`` wait for the distributed slice.  The registry lists all 11
of the reference's architectures.
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

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can decode at 500k context (assignment rule)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks), for 6ND math,
        term for term the reference's (so, as there, RWKV6's block count
        has 7 d x d matrices and the decay LoRA twice, and an enc-dec's
        cross-attention is counted with its encoder layers)."""
        d = self.d_model
        n = self.vocab_padded * d                       # embedding
        if not self.tie_embeddings:
            n += self.vocab_padded * d                  # lm head
        n += self._block_params() * self.num_layers
        if self.family == "encdec":
            n += self._block_params(cross=True) * self.num_encoder_layers
        if self.hybrid is not None:
            n += self._attn_params() * self.hybrid.num_shared_blocks
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed top-k experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        moe_layers = self.num_layers - m.num_dense_layers
        expert_p = 3 * d * m.d_ff_expert                # swiglu expert
        inactive = (m.num_experts - m.top_k) * expert_p * moe_layers
        return self.param_count() - inactive

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attention_type == "mla":
            a = self.mla
            qk_dim = a.qk_nope_head_dim + a.qk_rope_head_dim
            p = d * a.q_lora_rank + a.q_lora_rank * self.num_heads * qk_dim
            p += d * (a.kv_lora_rank + a.qk_rope_head_dim)
            p += a.kv_lora_rank * self.num_heads * (a.qk_nope_head_dim
                                                    + a.v_head_dim)
            p += self.num_heads * a.v_head_dim * d
            return p
        if self.attention_type == "none":
            return 0
        hd = self.head_dim
        return d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d

    def _mlp_params(self) -> int:
        d = self.d_model
        if self.moe is not None:
            m = self.moe
            p = m.num_experts * 3 * d * m.d_ff_expert
            p += d * m.num_experts                       # router
            if m.num_shared_experts:
                p += 3 * d * m.d_ff_shared
            return p
        mats = 3 if self.mlp_type == "swiglu" else 2
        return mats * d * self.d_ff

    def _ssm_params(self) -> int:
        if self.ssm is None:
            return 0
        d = self.d_model
        s = self.ssm
        di = s.d_inner(d)
        nh = s.num_heads(d)
        conv_dim = di + 2 * s.n_groups * s.state_dim
        p = d * (2 * di + 2 * s.n_groups * s.state_dim + nh)   # in_proj
        p += conv_dim * s.conv_width
        p += 2 * nh                                             # A_log, D
        p += di * d                                             # out_proj
        return p

    def _rwkv_params(self) -> int:
        if self.rwkv is None:
            return 0
        d = self.d_model
        r = self.rwkv
        p = 6 * d * d                                   # r, k, v, g, o, + 1
        p += 2 * (d * r.decay_lora + r.decay_lora * d)  # decay LoRA, twice
        p += d * r.mix_lora * 5 * 2                     # token-shift LoRAs
        p += 2 * d * self.d_ff                          # channel mix (k, v)
        p += d * d                                      # receptance
        return p

    def _block_params(self, cross: bool = False) -> int:
        if self.family == "ssm" and self.rwkv is not None:
            return self._rwkv_params()
        if self.family == "hybrid":
            return self._ssm_params()
        p = self._attn_params() + self._mlp_params()
        if cross:
            p += self._attn_params()
        return p


# --------------------------------------------------------------------------
# Shapes
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Assignment rule: long_500k only for sub-quadratic architectures."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False
    return True


# --------------------------------------------------------------------------
# Train / run config
# --------------------------------------------------------------------------


@dataclass
class TrainConfig:
    """The reference's training settings, field for field.  The port reads
    no ``scan_unroll`` (its layers run in a Python loop); ``grad_compression``
    acts only with a mesh that has a "pod" axis, and ``seq_parallel`` only
    with a live "model" axis, for the dense and GQA-MoE families (it raises
    for the others).  Every field is kept so a configuration passes between
    the two packages unchanged."""
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    optimizer: str = "adamw"        # adamw | adafactor
    num_microbatches: int = 1       # gradient accumulation
    remat_policy: str = "minimal"   # none | minimal | full
    grad_compression: str = "none"  # none | int8 | bf16  (DP all-reduce)
    attn_impl: str = "masked"       # masked | recursive | flash (§Perf)
    scan_unroll: int = 1            # layer-scan unroll factor
    grad_sync_dtype: str = "float32"  # float32 | bfloat16 DP reduction
    seq_parallel: bool = False      # Megatron-SP residual sharding (§Perf)
    seed: int = 0
    # LMS monitoring
    monitor: bool = True
    monitor_interval: int = 1       # emit metrics every N steps
    halt_on_straggler: bool = False  # straggler finding -> elastic restart
    # checkpointing
    ckpt_dir: str = ""
    ckpt_interval: int = 100
    ckpt_keep: int = 3


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
    "seamless_m4t_large_v2",
    "rwkv6_1p6b",
    "mixtral_8x7b",
    "nemotron_4_340b",
    "granite_3_8b",
    "yi_34b",
    "phi3_medium_14b",
    "lms_demo",
    "zamba2_7b",
    "deepseek_v2_236b",
    "qwen2_vl_7b",
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


SMOKE_SHAPE = ShapeConfig("smoke", seq_len=32, global_batch=2, kind="train")
