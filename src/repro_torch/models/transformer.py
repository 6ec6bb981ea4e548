"""Model assembly, dense, MoE, VLM and hybrid families (port of
``repro.models.transformer``).

:func:`forward` runs a decoder-only dense or MoE LM (``dense_layers`` then
``moe_layers``, as the reference; GQA or MLA attention), a VLM decoder
(patch embeddings merged into the token stream, M-RoPE positions), or a
zamba2-style hybrid (Mamba2 backbone with shared attention blocks), in
train, prefill or decode mode.  The
reference scans stacked layer parameters with ``jax.lax.scan``; here a loop
walks the leading layer axes.  Caches are stacked over layers like the
reference's and are written in place; under a sliding window each layer's
KV cache holds ``min(max_len, window)`` slots.

Train mode rematerializes as the reference places ``jax.checkpoint``: each
dense or MoE block, each Mamba2 block of a hybrid group and each trailing
(``rem``) Mamba2 block is checkpointed under the policy; the hybrid's
shared attention blocks are not.  :func:`loss_fn` adds the MoE router's
aux term as the reference does.
"""

from __future__ import annotations

from functools import partial
from typing import Any

import torch
from torch.utils.checkpoint import (
    checkpoint, create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (
    attn_specs, gqa_attention, mla_attention, mla_specs)
from repro_torch.models.layers import (
    apply_mlp, apply_norm, cross_entropy, embed_tokens, embedding_specs,
    lm_logits, mlp_specs, mrope_table, norm_specs, rope_table)
from repro_torch.models.moe import apply_moe, moe_specs
from repro_torch.models.params import (
    flatten, fp32_leaves, init_params, spec, stack_specs, unflatten)
from repro_torch.models.ssm import (
    mamba2_block, mamba2_cache_specs, mamba2_specs)


def _check_supported(cfg: ModelConfig) -> None:
    ported = cfg.family in ("dense", "moe", "vlm") or (
        cfg.family == "hybrid" and cfg.moe is None
        and cfg.hybrid is not None and cfg.ssm is not None)
    if not ported:
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    if cfg.attention_type not in ("gqa", "mla"):
        raise NotImplementedError(
            f"attention {cfg.attention_type!r} is not ported")
    if cfg.rope_type not in ("rope", "mrope", "none"):
        raise NotImplementedError(f"rope {cfg.rope_type!r} is not ported")


def _attn_block_specs(cfg: ModelConfig, d_ff=None, moe_layer=False):
    attn = mla_specs(cfg) if cfg.attention_type == "mla" else attn_specs(cfg)
    out = {"ln1": norm_specs(cfg), "attn": attn, "ln2": norm_specs(cfg)}
    if moe_layer:
        out["moe"] = moe_specs(cfg)
    else:
        out["mlp"] = mlp_specs(cfg, d_ff=d_ff)
    return out


def _layer_plan(cfg: ModelConfig) -> dict:
    """How many layers of each kind, as stacked groups."""
    if cfg.family == "hybrid":
        n_groups = cfg.num_layers // cfg.hybrid.attn_every
        rem = cfg.num_layers - n_groups * cfg.hybrid.attn_every
        return {"hybrid_groups": n_groups, "hybrid_rem": rem}
    if cfg.moe is not None:
        return {"dense": cfg.moe.num_dense_layers,
                "moe": cfg.num_layers - cfg.moe.num_dense_layers}
    return {"dense": cfg.num_layers}


def model_specs(cfg: ModelConfig):
    """Full parameter-spec tree (stacked layers).

    hybrid: ``groups`` stacks ``attn_every`` Mamba2 blocks per group
    (axes groups x inner_layers), ``rem`` the Mamba2 blocks after the last
    group, ``shared`` the ``num_shared_blocks`` attention blocks."""
    _check_supported(cfg)
    plan = _layer_plan(cfg)
    out = {"embed": embedding_specs(cfg), "final_norm": norm_specs(cfg)}
    if cfg.family == "hybrid":
        mamba = {"ln": norm_specs(cfg), **mamba2_specs(cfg)}
        if plan["hybrid_groups"]:
            out["groups"] = stack_specs(
                stack_specs(mamba, cfg.hybrid.attn_every, "inner_layers"),
                plan["hybrid_groups"])
        if plan["hybrid_rem"]:
            out["rem"] = stack_specs(mamba, plan["hybrid_rem"])
        out["shared"] = stack_specs(_attn_block_specs(cfg),
                                    cfg.hybrid.num_shared_blocks)
        return out
    if plan.get("dense"):
        d_ff = cfg.moe.d_ff_dense if (cfg.moe is not None
                                      and cfg.moe.d_ff_dense) else None
        out["dense_layers"] = stack_specs(_attn_block_specs(cfg, d_ff=d_ff),
                                          plan["dense"])
    if plan.get("moe"):
        out["moe_layers"] = stack_specs(
            _attn_block_specs(cfg, moe_layer=True), plan["moe"])
    return out


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16):
    """Spec tree of the decode caches (zero-init), stacked over layers.

    The KV cache is ``dtype`` (bf16) whatever the compute dtype, and the
    SSM state fp32, as in the reference.  MLA caches the latent ``ckv``
    (B, max_len, kv_lora_rank) and ``krope`` (B, max_len,
    qk_rope_head_dim) in place of K and V.  The conv tail is kept in the
    compute dtype: the reference's prefill returns it in that dtype and
    decode carries it so (bf16 when serving in bf16); the port writes it in
    place, so it allocates that dtype up front."""
    _check_supported(cfg)
    plan = _layer_plan(cfg)
    kv_len = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len
    if cfg.attention_type == "mla":
        a = cfg.mla
        attn = {"ckv": spec((batch, max_len, a.kv_lora_rank),
                            ("batch", "cache_seq", None), dtype,
                            init="zeros"),
                "krope": spec((batch, max_len, a.qk_rope_head_dim),
                              ("batch", "cache_seq", None), dtype,
                              init="zeros")}
    else:
        kv = spec((batch, kv_len, cfg.num_kv_heads, cfg.head_dim),
                  ("batch", "cache_seq", "kv_heads", None), dtype,
                  init="zeros")
        attn = {"k": kv, "v": kv}
    if cfg.family != "hybrid":
        return {key: stack_specs(attn, plan[key])
                for key in ("dense", "moe") if plan.get(key)}
    mamba = mamba2_cache_specs(cfg, batch, getattr(torch, cfg.dtype))
    out = {}
    if plan["hybrid_groups"]:
        out["groups"] = stack_specs(
            stack_specs(mamba, cfg.hybrid.attn_every, "inner_layers"),
            plan["hybrid_groups"])
        out["shared_attn"] = stack_specs(attn, plan["hybrid_groups"])
    if plan["hybrid_rem"]:
        out["rem"] = stack_specs(mamba, plan["hybrid_rem"])
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Concrete zero caches matching :func:`forward`'s layout."""
    return init_params(cache_specs(cfg, batch, max_len, dtype),
                       device=device)


def _attn_block(p, x, cfg, *, rope, mode, cache, pos, attn_impl="masked",
                aux=None):
    """Pre-norm transformer block, its FFN an MLP or (with ``p["moe"]``)
    the MoE; returns (x, cache).  ``aux``: a dict the MoE statistics are
    added to (see :func:`forward`)."""
    h = apply_norm(p["ln1"], x, cfg)
    attention = mla_attention if cfg.attention_type == "mla" \
        else gqa_attention
    y, cache = attention(p["attn"], h, cfg, rope=rope, mode=mode,
                         cache=cache, pos=pos, attn_impl=attn_impl)
    x = x + y
    h = apply_norm(p["ln2"], x, cfg)
    if "moe" in p:
        y, stats = apply_moe(p["moe"], h, cfg)
        if aux is not None:
            _combine_aux(aux, stats)
    else:
        y = apply_mlp(p["mlp"], h, cfg)
    return x + y, cache


def _combine_aux(acc: dict, stats: dict) -> None:
    """The reference's layer reduction of the MoE statistics: aux loss and
    dropped fraction summed, max load the largest."""
    if not acc:
        acc.update(stats)
        return
    for k in ("moe_aux_loss", "moe_dropped_frac"):
        acc[k] = acc[k] + stats[k]
    acc["moe_max_load"] = torch.maximum(acc["moe_max_load"],
                                        stats["moe_max_load"])


def _mamba_block(p, x, cfg, *, mode, cache):
    """Pre-norm Mamba2 block; returns (x, cache)."""
    h = apply_norm(p["ln"], x, cfg)
    y, cache = mamba2_block({k: v for k, v in p.items() if k != "ln"}, h,
                            cfg, mode=mode, cache=cache)
    return x + y, cache


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return unflatten({k: v[i] for k, v in flatten(tree).items()})


def _unstack(tree) -> list:
    """Per-layer trees of a stacked tree, one ``unbind`` per leaf: its
    backward stacks the layers' gradients once, where indexing layer by
    layer would add a full-size gradient per layer."""
    cols = {k: v.unbind(0) for k, v in flatten(tree).items()}
    n = len(next(iter(cols.values())))
    return [unflatten({k: c[i] for k, c in cols.items()}) for i in range(n)]


REMAT_POLICIES = ("none", "minimal", "full")

# remat "minimal": the ops whose outputs are kept (x @ W lowers to a 2-D mm)
_minimal_remat = partial(create_selective_checkpoint_contexts,
                         [torch.ops.aten.mm.default,
                          torch.ops.aten.addmm.default])


def _checkpointed(fn, remat: str):
    """``fn`` rematerialized under the policy (``"none"``: ``fn`` itself)."""
    if remat == "none":
        return fn
    kw = {} if remat == "full" else {"context_fn": _minimal_remat}
    return partial(checkpoint, fn, use_reentrant=False, **kw)


def _train_layers(layers, x, cfg, *, rope, attn_impl, remat, aux=None):
    """Train-mode pass over stacked attention blocks, each checkpointed;
    the MoE statistics of each block come out of the checkpointed call and
    are combined into ``aux``."""
    def block(lp, x):
        stats = {}
        x = _attn_block(lp, x, cfg, rope=rope, mode="train", cache=None,
                        pos=None, attn_impl=attn_impl, aux=stats)[0]
        return x, stats

    run = _checkpointed(block, remat)
    for lp in _unstack(layers):
        x, stats = run(lp, x)
        if stats and aux is not None:
            _combine_aux(aux, stats)
    return x


def _depth(tree) -> int:
    """Size of the leading (stacked) axis of a tree."""
    return next(iter(flatten(tree).values())).shape[0]


def _hybrid_forward(params, x, cfg, *, rope, mode, cache, pos,
                    attn_impl="masked", remat="none"):
    """Mamba2 groups, each followed by a shared attention block (weights
    ``group % num_shared_blocks``), then the ``rem`` Mamba2 blocks."""
    nsb = cfg.hybrid.num_shared_blocks
    if mode == "train":
        def mamba(lp, x):
            return _mamba_block(lp, x, cfg, mode="train", cache=None)[0]
        run = _checkpointed(mamba, remat)
        if "groups" in params:
            shared = _unstack(params["shared"])
            for gi, gp in enumerate(_unstack(params["groups"])):
                for lp in _unstack(gp):
                    x = run(lp, x)
                x, _ = _attn_block(shared[gi % nsb], x, cfg, rope=rope,
                                   mode="train", cache=None, pos=None,
                                   attn_impl=attn_impl)
        for lp in _unstack(params["rem"]) if "rem" in params else []:
            x = run(lp, x)
        return x
    if "groups" in params:
        for gi in range(_depth(params["groups"])):
            gp = _layer(params["groups"], gi)
            gc = None if cache is None else _layer(cache["groups"], gi)
            for li in range(_depth(gp)):
                x, _ = _mamba_block(
                    _layer(gp, li), x, cfg, mode=mode,
                    cache=None if gc is None else _layer(gc, li))
            x, _ = _attn_block(
                _layer(params["shared"], gi % nsb), x, cfg, rope=rope,
                mode=mode, pos=pos,
                cache=None if cache is None else _layer(cache["shared_attn"],
                                                        gi))
    if "rem" in params:
        for li in range(_depth(params["rem"])):
            x, _ = _mamba_block(
                _layer(params["rem"], li), x, cfg, mode=mode,
                cache=None if cache is None else _layer(cache["rem"], li))
    return x


def _rope_for(cfg: ModelConfig, positions, extras):
    """The (cos, sin) tables of this pass: none without RoPE; at
    ``qk_rope_head_dim`` for MLA (only that part of a head rotates); from
    ``extras["mrope_pos"]`` (B, S, 3) for M-RoPE."""
    if cfg.rope_type == "none":
        return None
    hd = cfg.mla.qk_rope_head_dim if cfg.attention_type == "mla" \
        else cfg.head_dim
    if cfg.rope_type == "mrope":
        if "mrope_pos" not in extras:
            raise KeyError("mrope_pos: an M-RoPE model needs its (B, S, 3) "
                           "positions in extras")
        return mrope_table(extras["mrope_pos"], hd, cfg.rope_theta,
                           cfg.mrope_sections)
    return rope_table(positions, hd, cfg.rope_theta)


def _merge_patches(x, patches):
    """The VLM's patch embeddings (B, P, d) in place of tokens 1 .. P, as
    the reference merges them (cast to x's dtype)."""
    p_len = patches.shape[1]
    if p_len > x.shape[1] - 1:
        raise ValueError(f"{p_len} patches do not fit after the first of "
                         f"{x.shape[1]} tokens")
    return torch.cat([x[:, :1], patches.to(x.dtype), x[:, 1 + p_len:]],
                     dim=1)


def forward(params, cfg: ModelConfig, *, tokens, mode="prefill", cache=None,
            pos=None, extras=None, attn_impl="masked", remat="none",
            aux=None):
    """Run the model.

    tokens: (B, S) int64.  decode: S is the number of new tokens (1).
    mode: "train" | "prefill" | "decode".
    cache: stacked cache tree, written in place (prefill fills slots
    [0, S), or a ring's slots p mod window; decode writes slot ``pos``, or
    ``pos mod window``); None in train mode.
    pos: int — tokens already in the cache (decode only).
    extras: modality inputs, as the reference's: ``"patches"`` (B, P, d),
    merged in place of tokens 1 .. P by a VLM (P <= S - 1, else
    ``ValueError``), and ``"mrope_pos"`` (B, S, 3) int, the (t, h, w)
    positions an M-RoPE model's rope reads (which may differ from the cache
    slot ``pos``).
    attn_impl, remat: train mode only (see the module docstring).
    aux: optional dict, filled with the MoE statistics of this pass as the
    reference's forward returns them (``moe_aux_loss`` and
    ``moe_dropped_frac`` summed over the MoE layers, ``moe_max_load`` their
    largest); untouched by models without MoE layers.
    Returns (logits, cache).
    """
    _check_supported(cfg)
    if mode == "decode" and (cache is None or pos is None):
        raise ValueError("decode needs a cache and pos")
    if mode == "train" and remat not in REMAT_POLICIES:
        raise ValueError(f"remat {remat!r} (one of {REMAT_POLICIES})")
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None, :]
    if pos is not None:
        positions = positions + pos

    extras = extras or {}
    x = embed_tokens(params["embed"], tokens, cfg)
    if cfg.family == "vlm" and "patches" in extras:
        x = _merge_patches(x, extras["patches"])
    rope = _rope_for(cfg, positions, extras)

    if cfg.family == "hybrid":
        x = _hybrid_forward(params, x, cfg, rope=rope, mode=mode,
                            cache=cache, pos=pos, attn_impl=attn_impl,
                            remat=remat)
    elif mode == "train":
        for group in ("dense_layers", "moe_layers"):
            if group in params:
                x = _train_layers(params[group], x, cfg, rope=rope,
                                  attn_impl=attn_impl, remat=remat, aux=aux)
    else:
        for group, key in (("dense_layers", "dense"), ("moe_layers", "moe")):
            if group not in params:
                continue
            layers = params[group]
            for i in range(_depth(layers)):
                lc = None if cache is None else _layer(cache[key], i)
                x, _ = _attn_block(_layer(layers, i), x, cfg, rope=rope,
                                   mode=mode, cache=lc, pos=pos, aux=aux)

    x = apply_norm(params["final_norm"], x, cfg)
    return lm_logits(params["embed"], x, cfg), cache


def loss_fn(params, cfg: ModelConfig, batch, *, attn_impl="masked",
            remat="none"):
    """Next-token CE loss.  batch: {"tokens", "labels"} (B, S) int tensors
    on the params' device, and any extras (every other entry, e.g. a VLM's
    ``patches`` and ``mrope_pos``) for :func:`forward`; labels < 0 are
    masked out.  Returns (total,
    metrics): for a model with MoE layers the total adds ``0.01 *
    moe_aux_loss / num_layers`` to the loss and the metrics carry the MoE
    statistics beside ``loss``, as the reference's; otherwise the total is
    the loss and the metrics ``{"loss": loss}``."""
    aux = {}
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    logits, _ = forward(params, cfg, tokens=batch["tokens"], mode="train",
                        extras=extras, attn_impl=attn_impl, remat=remat,
                        aux=aux)
    labels = batch["labels"]
    loss = cross_entropy(logits, labels.clamp_min(0), cfg, mask=labels >= 0)
    if cfg.moe is None:
        return loss, {"loss": loss}
    total = loss + 0.01 * aux["moe_aux_loss"] / max(cfg.num_layers, 1)
    return total, {"loss": loss, **aux}


def init_model_params(cfg: ModelConfig, seed: int = 0, device=None,
                      compute_dtype: Any = None):
    """Initialize the model on ``device`` (default CUDA).  ``compute_dtype``
    (e.g. ``torch.bfloat16``) casts matrices and the embedding once as they
    are made; the leaves read in fp32 (``params.fp32_leaves(cfg)``) stay
    fp32."""
    return init_params(model_specs(cfg), seed, device=resolve_device(device),
                       compute_dtype=compute_dtype, keep=fp32_leaves(cfg))
