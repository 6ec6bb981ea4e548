"""Model assembly, dense family (port of ``repro.models.transformer``).

:func:`forward` runs a decoder-only dense LM in prefill or decode mode.  The
reference scans stacked layer parameters with ``jax.lax.scan``; here a loop
walks the leading layer axis.  Caches are stacked over layers like the
reference's and are written in place.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attn_specs, gqa_attention
from repro_torch.models.layers import (
    apply_mlp, apply_norm, embed_tokens, embedding_specs, lm_logits,
    mlp_specs, norm_specs, rope_table)
from repro_torch.models.params import (
    flatten, init_params, spec, stack_specs, unflatten)


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    if cfg.attention_type != "gqa":
        raise NotImplementedError(
            f"attention {cfg.attention_type!r} is not ported")
    if cfg.rope_type not in ("rope", "none"):
        raise NotImplementedError(f"rope {cfg.rope_type!r} is not ported")


def _attn_block_specs(cfg: ModelConfig):
    return {"ln1": norm_specs(cfg), "attn": attn_specs(cfg),
            "ln2": norm_specs(cfg), "mlp": mlp_specs(cfg)}


def model_specs(cfg: ModelConfig):
    """Full parameter-spec tree (stacked layers), dense family."""
    _check_supported(cfg)
    return {"embed": embedding_specs(cfg),
            "final_norm": norm_specs(cfg),
            "dense_layers": stack_specs(_attn_block_specs(cfg),
                                        cfg.num_layers)}


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16):
    """Spec tree of the decode caches (zero-init), stacked over layers.
    The cache is bf16 whatever the compute dtype, as in the reference."""
    _check_supported(cfg)
    kv = spec((batch, max_len, cfg.num_kv_heads, cfg.head_dim),
              ("batch", "cache_seq", "kv_heads", None), dtype, init="zeros")
    return {"dense": stack_specs({"k": kv, "v": kv}, cfg.num_layers)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Concrete zero caches matching :func:`forward`'s layout."""
    return init_params(cache_specs(cfg, batch, max_len, dtype),
                       device=device)


def _attn_block(p, x, cfg, *, rope, mode, cache, pos):
    """Pre-norm transformer block; returns (x, cache)."""
    h = apply_norm(p["ln1"], x, cfg)
    y, cache = gqa_attention(p["attn"], h, cfg, rope=rope, mode=mode,
                             cache=cache, pos=pos)
    x = x + y
    h = apply_norm(p["ln2"], x, cfg)
    x = x + apply_mlp(p["mlp"], h, cfg)
    return x, cache


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return unflatten({k: v[i] for k, v in flatten(tree).items()})


def forward(params, cfg: ModelConfig, *, tokens, mode="prefill", cache=None,
            pos=None):
    """Run the model.

    tokens: (B, S) int64.  decode: S is the number of new tokens (1).
    cache: stacked cache tree, written in place (prefill fills slots
    [0, S); decode writes slot ``pos``).
    pos: int — tokens already in the cache (decode only).
    Returns (logits, cache).
    """
    _check_supported(cfg)
    if mode == "decode" and (cache is None or pos is None):
        raise ValueError("decode needs a cache and pos")
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None, :]
    if pos is not None:
        positions = positions + pos

    x = embed_tokens(params["embed"], tokens, cfg)
    rope = None if cfg.rope_type == "none" else rope_table(
        positions, cfg.head_dim, cfg.rope_theta)

    layers = params["dense_layers"]
    n = layers["ln1"]["scale"].shape[0]
    for i in range(n):
        lc = None if cache is None else _layer(cache["dense"], i)
        x, _ = _attn_block(_layer(layers, i), x, cfg, rope=rope, mode=mode,
                           cache=lc, pos=pos)

    x = apply_norm(params["final_norm"], x, cfg)
    return lm_logits(params["embed"], x, cfg), cache


def init_model_params(cfg: ModelConfig, seed: int = 0, device=None,
                      compute_dtype: Any = None):
    """Initialize the model on ``device`` (default CUDA).  ``compute_dtype``
    (e.g. ``torch.bfloat16``) casts matrices and the embedding once as they
    are made; norm scales stay fp32."""
    return init_params(model_specs(cfg), seed, device=resolve_device(device),
                       compute_dtype=compute_dtype)
