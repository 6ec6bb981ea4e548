"""Model assembly, every family of the reference (port of
``repro.models.transformer``).

:func:`forward` runs a decoder-only dense or MoE LM (``dense_layers`` then
``moe_layers``, as the reference; GQA or MLA attention), a VLM decoder
(patch embeddings merged into the token stream, M-RoPE positions), a
zamba2-style hybrid (Mamba2 backbone with shared attention blocks), RWKV6
(``layers`` of time-mix and channel-mix blocks) or an encoder-decoder (a
bidirectional encoder over ``extras["src_frames"]``, decoder blocks with
cross-attention, sinusoidal positions), in train, prefill or decode mode.
The reference scans stacked layer parameters with ``jax.lax.scan``; here a
loop walks the leading layer axes.  Caches are stacked over layers like the
reference's and are written in place; under a sliding window each layer's
KV cache holds ``min(max_len, window)`` slots.

A pass on a mesh with a live ``"model"`` axis (train, prefill or decode)
computes tensor-parallel for every family (``pc.tensor_parallel``, see
:mod:`repro_torch.parallel.sharding`); serving writes its cache piece as
the binding lays it out (a rank's KV heads, or its slots of every KV head
or of MLA's latent; a rank's heads of Mamba2's and RWKV6's states).  Each
pass runs the vocabulary-parallel embedding, each block's attention (and
cross-attention) over this rank's heads and its MLP over this rank's
columns (the MoE over its experts or their columns; a Mamba2 block and
RWKV6's time mix over this rank's heads, its channel mix over its
columns: :mod:`repro_torch.models.ssm`), each between the layout's
regions, and vocabulary-sharded logits; under sequence
parallelism (train mode) the residual stream between blocks, and the norms
on it, hold this rank's rows (a VLM rank merges the patches that fall in
them; an encoder-decoder's sinusoidal positions, of the tokens and of the
encoder's frames, are its rows'; its cross K/V read the encoder's whole
output).

A pass handed this rank's stored pieces of the params (``pc.pieces``: the
train step and the serve fns on a mesh) gathers each layer's leaves inside
that layer's call (``sharding.gathered``; in train mode inside the
checkpointed function, so the backward's recompute gathers them again and
the gathered leaves are not saved), and the leaves outside the layer stacks
(the embedding, once for both its uses; the final norms) once a pass; a
hybrid's shared attention blocks and an enc-dec's cross K/V projections,
used outside the checkpoints, are gathered where they are used.  Each
train-mode loop of layers takes its gathers through a
``sharding.LayerGathers``, which in the overlapped step issues them ahead
(the next layer's while a layer computes, the previous layer's while a
layer recomputes) and waits for them outside the checkpointed call.

Train mode rematerializes as the reference places ``jax.checkpoint``: each
dense or MoE block, each Mamba2 block of a hybrid group and each trailing
(``rem``) Mamba2 block, each RWKV6 block and each encoder and decoder block
is checkpointed under the policy; the hybrid's shared attention blocks are
not.  :func:`loss_fn` adds the MoE router's aux term as the reference does.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any

import torch
from torch.utils.checkpoint import (
    checkpoint, create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (
    attn_specs, cross_attention, cross_kv, gqa_attention, mla_attention,
    mla_specs)
from repro_torch.models.layers import (
    apply_mlp, apply_norm, cross_entropy, embed_tokens, embedding_specs,
    lm_logits, mlp_specs, mrope_table, norm_specs, rope_table)
from repro_torch.models.moe import apply_moe, moe_specs
from repro_torch.models.params import (
    flatten, fp32_leaves, init_params, spec, stack_specs, unflatten)
from repro_torch.models.ssm import (
    mamba2_block, mamba2_cache_specs, mamba2_specs, rwkv6_cache_specs,
    rwkv6_channel_mix, rwkv6_specs, rwkv6_time_mix)
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import (
    LayerGathers, gathered, recurrent_splits)


def _check_supported(cfg: ModelConfig) -> None:
    """Refuses what no shipped config uses and the port does not take: an
    RWKV6 (``family="ssm"``) without its ``rwkv`` config or with
    attention, a hybrid that is not Mamba2 with shared attention blocks, an
    encoder-decoder with MLA or MoE layers, and attention or RoPE kinds
    other than GQA / MLA and rope / mrope / none."""
    if cfg.family == "ssm":
        if cfg.rwkv is None or cfg.attention_type != "none":
            raise NotImplementedError(
                f"family 'ssm' is ported as RWKV6 only (an rwkv config, "
                f"attention_type 'none'), not with attention "
                f"{cfg.attention_type!r}")
        return
    ported = cfg.family in ("dense", "moe", "vlm") or (
        cfg.family == "hybrid" and cfg.moe is None
        and cfg.hybrid is not None and cfg.ssm is not None) or (
        cfg.family == "encdec" and cfg.moe is None
        and cfg.attention_type == "gqa")
    if not ported:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported in this form (hybrid: "
            f"Mamba2 with shared attention, no MoE; encdec: GQA, no MoE)")
    if cfg.attention_type not in ("gqa", "mla"):
        raise NotImplementedError(
            f"attention {cfg.attention_type!r} is not ported outside RWKV6")
    if cfg.rope_type not in ("rope", "mrope", "none"):
        raise NotImplementedError(f"rope {cfg.rope_type!r} is not ported")


def _attn_block_specs(cfg: ModelConfig, d_ff=None, moe_layer=False,
                      cross=False):
    attn = mla_specs(cfg) if cfg.attention_type == "mla" else attn_specs(cfg)
    out = {"ln1": norm_specs(cfg), "attn": attn, "ln2": norm_specs(cfg)}
    if cross:
        out["ln_cross"] = norm_specs(cfg)
        out["cross"] = attn_specs(cfg)
    if moe_layer:
        out["moe"] = moe_specs(cfg)
    else:
        out["mlp"] = mlp_specs(cfg, d_ff=d_ff)
    return out


def _dense_d_ff(cfg: ModelConfig):
    """The MLP width of a MoE model's dense layers (None: ``cfg.d_ff``)."""
    return cfg.moe.d_ff_dense if (cfg.moe is not None
                                  and cfg.moe.d_ff_dense) else None


def _layer_plan(cfg: ModelConfig) -> dict:
    """How many layers of each kind, as stacked groups."""
    if cfg.family == "ssm":                               # rwkv6
        return {"rwkv": cfg.num_layers}
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
    group, ``shared`` the ``num_shared_blocks`` attention blocks.  RWKV6:
    ``layers``.  encdec: ``encoder`` ({``layers``, ``final_norm``}) and
    ``dec_layers``, decoder blocks with a cross-attention sublayer."""
    _check_supported(cfg)
    plan = _layer_plan(cfg)
    out = {"embed": embedding_specs(cfg), "final_norm": norm_specs(cfg)}
    if cfg.family == "ssm":
        out["layers"] = stack_specs(rwkv6_specs(cfg), plan["rwkv"])
        return out
    if cfg.family == "encdec":
        out["encoder"] = {"layers": stack_specs(_attn_block_specs(cfg),
                                                cfg.num_encoder_layers),
                          "final_norm": norm_specs(cfg)}
        out["dec_layers"] = stack_specs(_attn_block_specs(cfg, cross=True),
                                        cfg.num_layers)
        return out
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
        out["dense_layers"] = stack_specs(
            _attn_block_specs(cfg, d_ff=_dense_d_ff(cfg)), plan["dense"])
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
    place, so it allocates that dtype up front.  So are RWKV6's token
    shifts; its WKV state is fp32.  An encoder-decoder's ``cross`` K/V
    (B, encdec_source_len, KV, D) are bf16 whatever ``dtype``: the
    reference's prefill casts them to bf16."""
    _check_supported(cfg)
    plan = _layer_plan(cfg)
    if cfg.family == "ssm":
        return stack_specs(rwkv6_cache_specs(cfg, batch,
                                             getattr(torch, cfg.dtype)),
                           plan["rwkv"])
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
    if cfg.family == "encdec":
        cross = spec((batch, cfg.encdec_source_len, cfg.num_kv_heads,
                      cfg.head_dim), ("batch", "cache_seq", "kv_heads", None),
                     torch.bfloat16, init="zeros")
        return {"self": stack_specs(attn, cfg.num_layers),
                "cross": stack_specs({"k": cross, "v": cross},
                                     cfg.num_layers)}
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
                aux=None, cross_kv_cache=None, bidirectional=False,
                pc=None, tp=None, d_ff=None):
    """Pre-norm transformer block, its FFN an MLP or (with ``p["moe"]``)
    the MoE; returns (x, cache).  ``aux``: a dict the MoE statistics are
    added to (see :func:`forward`).  ``cross_kv_cache``: the encoder's K/V
    of this decoder layer, attended after the self-attention.
    ``bidirectional``: self-attention without the causal mask (an
    encoder's).  ``pc``: the partition constraints, which the MoE reads.
    ``tp``: the pass's tensor-parallel layout (``d_ff`` the MLP's
    width): each sublayer enters and leaves it, split (this rank's heads or
    columns) where its leaves bind "model", else whole; the MoE takes the
    layout itself (its experts or their columns split, its routing whole:
    :func:`~repro_torch.models.moe.apply_moe`); attention's cache lies as
    ``tp.cache`` says (``"seq"``: this rank's slots of every KV head)."""
    enter, leave = _regions(tp)
    split, heads = _heads_of(cfg, tp)
    seq_split = (tp.mesh, tp.rank, tp.size) \
        if tp is not None and tp.cache == "seq" else None
    h = enter(apply_norm(p["ln1"], x, cfg), split)
    if cfg.attention_type == "mla":
        y, cache = mla_attention(p["attn"], h, cfg, rope=rope, mode=mode,
                                 cache=cache, pos=pos, attn_impl=attn_impl,
                                 heads=heads, seq_split=seq_split)
    else:
        y, cache = gqa_attention(
            p["attn"], h, cfg, rope=rope, mode=mode, cache=cache, pos=pos,
            attn_impl=attn_impl, bidirectional=bidirectional, heads=heads,
            seq_split=seq_split)
    x = x + leave(y, split)
    if cross_kv_cache is not None:
        h = enter(apply_norm(p["ln_cross"], x, cfg), split)
        x = x + leave(cross_attention(
            p["cross"], h, cross_kv_cache, cfg, heads=heads,
            seq_split=(tp.mesh, tp.rank, tp.size) if tp is not None
            and mode == "decode" and tp.cross == "seq" else None), split)
    h = apply_norm(p["ln2"], x, cfg)
    if "moe" in p:
        y, stats = apply_moe(p["moe"], h, cfg, pc=pc, tp=tp)
        if aux is not None:
            _combine_aux(aux, stats)
    else:
        split = tp is not None and tp.splits(
            mlp_specs(cfg, d_ff=d_ff)["w_up"])
        y = leave(apply_mlp(p["mlp"], enter(h, split), cfg), split)
    return x + y, cache


def _heads_of(cfg: ModelConfig, tp) -> tuple:
    """(split, heads) of an attention sublayer under the layout ``tp``:
    whether its query heads bind "model" (``wq``, or MLA's ``wq_b``; a
    cross-attention's alike), and this rank's (first, count) of them
    (None where they do not split)."""
    if tp is None:
        return False, None
    q = mla_specs(cfg)["wq_b"] if cfg.attention_type == "mla" \
        else attn_specs(cfg)["wq"]
    if not tp.splits(q):
        return False, None
    n = cfg.num_heads // tp.size
    return True, (tp.rank * n, n)


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


def _regions(tp):
    """(enter, leave) of a sublayer under the layout ``tp`` (the identity
    without one)."""
    if tp is None:
        return (lambda h, split: h), (lambda y, split: y)
    return tp.enter, tp.leave


def _rwkv_block(p, x, cfg, *, mode, cache, tp=None):
    """RWKV6 block: LayerNorm -> time mix, LayerNorm -> channel mix, each
    residual; returns (x, cache).  ``tp``: each mixer between the layout's
    regions, on the whole sequence (the token shift reads the row before),
    split where :func:`~repro_torch.parallel.sharding.recurrent_splits`
    says: the time mix's partial sums reduced on leaving; a split channel
    mix returns its output in the pass's layout itself."""
    enter, leave = _regions(tp)
    splits = recurrent_splits(cfg, tp.splits) if tp is not None else {}
    tm, cm = splits.get("time_mix", False), splits.get("channel_mix", False)
    ln_tm = {"scale": p["ln_tm_scale"], "bias": p["ln_tm_bias"]}
    ln_cm = {"scale": p["ln_cm_scale"], "bias": p["ln_cm_bias"]}
    lcfg = dataclasses.replace(cfg, norm_type="layernorm")
    y, cache = rwkv6_time_mix(p, enter(apply_norm(ln_tm, x, lcfg), tm), cfg,
                              mode=mode, cache=cache, tp=tp if tm else None)
    x = x + leave(y, tm)
    y, cache = rwkv6_channel_mix(p, enter(apply_norm(ln_cm, x, lcfg), cm),
                                 cfg, mode=mode, cache=cache,
                                 tp=tp if cm else None)
    if not cm:
        y = leave(y, False)        # computed whole: this pass's rows of it
    return x + y, cache


def _mamba_block(p, x, cfg, *, mode, cache, tp=None):
    """Pre-norm Mamba2 block; returns (x, cache).  ``tp``: the mixer
    between the layout's regions, on this rank's heads where ``in_proj``'s
    parts split (:func:`~repro_torch.parallel.sharding.recurrent_splits`),
    its row-parallel output reduced on leaving."""
    enter, leave = _regions(tp)
    split = tp is not None and recurrent_splits(cfg, tp.splits)["mamba2"]
    h = enter(apply_norm(p["ln"], x, cfg), split)
    y, cache = mamba2_block({k: v for k, v in p.items() if k != "ln"}, h,
                            cfg, mode=mode, cache=cache,
                            tp=tp if split else None)
    return x + leave(y, split), cache


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


def _train_layers(layers, x, cfg, *, prefix, rope, attn_impl, remat,
                  aux=None, cross=None, bidirectional=False, pc=None,
                  tp=None, d_ff=None):
    """Train-mode pass over stacked attention blocks (the params' subtree
    ``prefix``), each checkpointed, each gathering its layer's leaves
    inside its call (``sharding.LayerGathers``: where ``pc`` says the pass
    holds pieces; the recompute gathers them again); the MoE statistics of
    each block come out of the checkpointed call and are combined into
    ``aux``.  ``cross``: per layer, the encoder's K/V of a decoder block
    (made outside the checkpoints, as the reference);
    ``bidirectional``: an encoder's blocks; ``tp``, ``d_ff``: see
    :func:`_attn_block`."""
    per_layer = _unstack(layers)
    fetch = LayerGathers(pc, [(lp, prefix, 1, remat != "none")
                              for lp in per_layer])

    def block(lp, x, ckv, i):
        stats = {}
        lp = fetch(i, lp)
        x = _attn_block(lp, x, cfg, rope=rope, mode="train", cache=None,
                        pos=None, attn_impl=attn_impl, aux=stats,
                        cross_kv_cache=ckv, bidirectional=bidirectional,
                        pc=pc, tp=tp, d_ff=d_ff)[0]
        return x, stats

    run = _checkpointed(block, remat)
    for i, (lp, ckv) in enumerate(zip(per_layer,
                                      cross or [None] * len(per_layer))):
        x, stats = fetch.call(i, run, lp, x, ckv, i)
        if stats and aux is not None:
            _combine_aux(aux, stats)
    return x


def _depth(tree) -> int:
    """Size of the leading (stacked) axis of a tree."""
    return next(iter(flatten(tree).values())).shape[0]


def _hybrid_forward(params, x, cfg, *, rope, mode, cache, pos,
                    attn_impl="masked", remat="none", pc=None, tp=None):
    """Mamba2 groups, each followed by a shared attention block (weights
    ``group % num_shared_blocks``), then the ``rem`` Mamba2 blocks.  Each
    block gathers its layer's leaves in its call (``sharding.gathered``);
    a shared block, outside the checkpoints as in the reference, gathers
    its weights at each use, kept for the backward by autograd.  ``tp``:
    the pass's layout, for the Mamba2 blocks and the shared blocks alike
    (a shared block's cache piece holds this rank's KV heads)."""
    nsb = cfg.hybrid.num_shared_blocks

    def shared(gi):
        return gathered(_layer(params["shared"], gi % nsb), "shared", pc, 1)

    if mode == "train":
        # the pass's gathers in order: each group's Mamba2 layers
        # (checkpointed), its shared block (at its use), then ``rem``
        remat_on = remat != "none"
        entries = []
        for gi, gp in enumerate(_unstack(params["groups"])
                                if "groups" in params else []):
            entries += [(lp, "groups", 2, remat_on) for lp in _unstack(gp)]
            entries.append((_layer(params["shared"], gi % nsb), "shared", 1,
                            False))
        entries += [(lp, "rem", 1, remat_on) for lp in (
            _unstack(params["rem"]) if "rem" in params else [])]
        fetch = LayerGathers(pc, entries)

        def mamba(lp, x, i):
            return _mamba_block(fetch(i, lp), x, cfg, mode="train",
                                cache=None, tp=tp)[0]
        run = _checkpointed(mamba, remat)
        for i, (lp, prefix, _, _) in enumerate(entries):
            if prefix == "shared":
                x = fetch.call(i, lambda lp, x: _attn_block(
                    fetch(i, lp), x, cfg, rope=rope, mode="train",
                    cache=None, pos=None, attn_impl=attn_impl, pc=pc,
                    tp=tp)[0], lp, x)
            else:
                x = fetch.call(i, run, lp, x, i)
        return x
    if "groups" in params:
        for gi in range(_depth(params["groups"])):
            gp = _layer(params["groups"], gi)
            gc = None if cache is None else _layer(cache["groups"], gi)
            for li in range(_depth(gp)):
                x, _ = _mamba_block(
                    gathered(_layer(gp, li), "groups", pc, 2), x, cfg,
                    mode=mode, cache=None if gc is None else _layer(gc, li),
                    tp=tp)
            x, _ = _attn_block(
                shared(gi), x, cfg, rope=rope, mode=mode, pos=pos,
                cache=None if cache is None else _layer(cache["shared_attn"],
                                                        gi), pc=pc, tp=tp)
    if "rem" in params:
        for li in range(_depth(params["rem"])):
            x, _ = _mamba_block(
                gathered(_layer(params["rem"], li), "rem", pc, 1), x, cfg,
                mode=mode,
                cache=None if cache is None else _layer(cache["rem"], li),
                tp=tp)
    return x


def _rwkv_forward(params, x, cfg, *, mode, cache, remat="none", pc=None,
                  tp=None):
    """The RWKV6 blocks in order, each gathering its layer's leaves in its
    call (``sharding.gathered``); in train mode each checkpointed under the
    policy, in prefill and decode each writing its cache layer in place.
    ``tp``: the pass's layout (see :func:`_rwkv_block`)."""
    def block(lp, x, mode, cache):
        return _rwkv_block(gathered(lp, "layers", pc, 1), x, cfg, mode=mode,
                           cache=cache, tp=tp)[0]

    if mode == "train":
        per_layer = _unstack(params["layers"])
        fetch = LayerGathers(pc, [(lp, "layers", 1, remat != "none")
                                  for lp in per_layer])

        def train_block(lp, x, i):
            return _rwkv_block(fetch(i, lp), x, cfg, mode="train",
                               cache=None, tp=tp)[0]
        run = _checkpointed(train_block, remat)
        for i, lp in enumerate(per_layer):
            x = fetch.call(i, run, lp, x, i)
        return x
    for i in range(_depth(params["layers"])):
        x = block(_layer(params["layers"], i), x, mode,
                  None if cache is None else _layer(cache, i))
    return x


def _sinusoidal(positions, d: int):
    """Absolute sinusoidal position encoding (enc-dec family), fp32:
    positions (..., S) -> (..., S, d), sines then cosines."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _row_positions(positions, rows: int, tp):
    """The positions (..., S) of the rows a pass's activations hold: all
    of them, or under sequence parallelism this rank's ``rows``, which
    start at ``tp.rank * rows``."""
    if tp is None or not tp.sp:
        return positions
    lo = tp.rank * rows
    return positions[..., lo:lo + rows]


def encode(params, cfg: ModelConfig, src_frames, remat="none", pc=None,
           tp=None):
    """The encoder over the (stub) frame embeddings (B, S_src, d), cast to
    the compute dtype, with sinusoidal positions: bidirectional masked
    attention in every block (``mode="train"``, as the reference runs it,
    whether serving or training; checkpointed under ``remat``), then its
    final norm.  ``tp``: the pass's tensor-parallel layout (see
    :func:`_attn_block`); under sequence parallelism the encoder holds
    this rank's rows of the frames, at their own positions, as the
    reference's ``pc.tokens`` splits them.  Returns (B, S_src, d), or this
    rank's rows of it."""
    x = src_frames.to(getattr(torch, cfg.dtype))
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    if tp is not None:
        x = tp.local(x)
    x = x + _sinusoidal(_row_positions(pos, x.shape[1], tp),
                        cfg.d_model).to(x.dtype)
    x = _train_layers(params["encoder"]["layers"], x, cfg,
                      prefix="encoder/layers", rope=None, attn_impl="masked",
                      remat=remat, bidirectional=True, pc=pc, tp=tp)
    return apply_norm(gathered(params["encoder"]["final_norm"],
                               "encoder/final_norm", pc), x, cfg)


# the decoder leaves only the cross K/V read (encdec_cross_caches)
_CROSS_KV = ("wk", "wv")


def encdec_cross_caches(params, cfg: ModelConfig, enc_out, pc=None,
                        tp=None) -> list:
    """Per decoder layer, the cross K/V of the encoder's output in its
    dtype: [{"k", "v"} (B, S_src, KV, D)] (the reference stacks them).
    Made outside the checkpoints, so each layer's ``wk`` / ``wv``, gathered
    here (``sharding.gathered``), are kept for the backward by autograd.
    ``tp``: the K/V of this rank's KV heads (or, where those do not split,
    of every KV head) from the encoder's whole output, which the layout
    enters as a split sublayer's input (gathered under sequence
    parallelism; its gradient summed over "model": each rank's heads read
    all of it)."""
    if tp is not None:
        enc_out = tp.enter(enc_out, _heads_of(cfg, tp)[0])
    cross = params["dec_layers"]["cross"]
    per_layer = _unstack({k: cross[k] for k in _CROSS_KV})
    fetch = LayerGathers(pc, [(lp, "dec_layers/cross", 1, False)
                              for lp in per_layer])
    return [fetch.call(i, lambda lp: cross_kv(fetch(i, lp), enc_out, cfg),
                       lp) for i, lp in enumerate(per_layer)]


def _decoder_blocks(params) -> dict:
    """The decoder layers' leaves its blocks read: all but the cross K/V
    projections."""
    return unflatten({k: v for k, v in flatten(params["dec_layers"]).items()
                      if k not in {f"cross/{n}" for n in _CROSS_KV}})


def _encdec_forward(params, x, cfg, *, mode, cache, pos, extras,
                    attn_impl="masked", remat="none", pc=None, tp=None):
    """Train and prefill encode ``extras["src_frames"]`` and make the cross
    K/V (prefill also writes them into ``cache["cross"]``, in bf16 as the
    reference's prefill casts them); decode reads them from the cache.
    Then the decoder blocks: self-attention (its cache in ``cache["self"]``)
    and cross-attention.  ``tp``: the pass's layout, for the encoder, the
    cross K/V and the decoder alike (a rank's cache pieces hold its KV
    heads)."""
    if mode in ("train", "prefill"):
        if "src_frames" not in extras:
            raise KeyError("src_frames: an encoder-decoder needs its "
                           "(B, S_src, d) source frames in extras")
        enc = encode(params, cfg, extras["src_frames"],
                     remat=remat if mode == "train" else "none", pc=pc,
                     tp=tp)
        cross = encdec_cross_caches(params, cfg, enc, pc, tp)
        del enc
    else:
        cross = [_layer(cache["cross"], i)
                 for i in range(_depth(params["dec_layers"]))]
    dec = _decoder_blocks(params)
    if mode == "train":
        return _train_layers(dec, x, cfg, prefix="dec_layers", rope=None,
                             attn_impl=attn_impl, remat=remat, cross=cross,
                             pc=pc, tp=tp)
    for i in range(_depth(dec)):
        x, _ = _attn_block(gathered(_layer(dec, i), "dec_layers", pc, 1), x,
                           cfg, rope=None, mode=mode, pos=pos,
                           cache=None if cache is None
                           else _layer(cache["self"], i),
                           cross_kv_cache=cross[i], tp=tp)
        if mode == "prefill" and cache is not None:
            for key in ("k", "v"):
                piece = cache["cross"][key][i]
                # a "seq" piece holds this rank's frames
                lo = tp.rank * piece.shape[1] if tp is not None and \
                    tp.cross == "seq" else 0
                piece.copy_(cross[i][key][:, lo:lo + piece.shape[1]])
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


def _merge_patches(x, patches, start: int = 0, total=None):
    """The VLM's patch embeddings (B, P, d) in place of tokens 1 .. P, as
    the reference merges them (cast to x's dtype).  ``x`` holds the rows
    ``start`` .. ``start + x.shape[1]`` of a sequence of ``total`` tokens
    (default: all of it), so a sequence-parallel rank merges the patches
    that fall in its rows."""
    total = x.shape[1] if total is None else total
    p_len = patches.shape[1]
    if p_len > total - 1:
        raise ValueError(f"{p_len} patches do not fit after the first of "
                         f"{total} tokens")
    lo, hi = max(1, start), min(1 + p_len, start + x.shape[1])
    if lo >= hi:
        return x
    return torch.cat([x[:, :lo - start], patches[:, lo - 1:hi - 1].to(x.dtype),
                      x[:, hi - start:]], dim=1)


def _src_len(cfg: ModelConfig, extras: dict):
    """An encoder-decoder pass's source frames (None: not one, or none
    given: decode)."""
    if cfg.family != "encdec" or "src_frames" not in extras:
        return None
    return extras["src_frames"].shape[1]


def forward(params, cfg: ModelConfig, *, tokens, mode="prefill", cache=None,
            pos=None, extras=None, attn_impl="masked", remat="none",
            aux=None, pc=None):
    """Run the model.

    tokens: (B, S) int64.  decode: S is the number of new tokens (1).
    mode: "train" | "prefill" | "decode".
    cache: stacked cache tree, written in place (prefill fills slots
    [0, S), or a ring's slots p mod window; decode writes slot ``pos``, or
    ``pos mod window``); None in train mode.
    pos: int — tokens already in the cache (decode only).
    extras: modality inputs, as the reference's: ``"patches"`` (B, P, d),
    merged in place of tokens 1 .. P by a VLM (P <= S - 1, else
    ``ValueError``), ``"mrope_pos"`` (B, S, 3) int, the (t, h, w)
    positions an M-RoPE model's rope reads (which may differ from the cache
    slot ``pos``), and ``"src_frames"`` (B, S_src, d), the source an
    encoder-decoder encodes in train and prefill mode (decode reads the
    cross K/V from the cache).
    attn_impl, remat: train mode only (see the module docstring).
    aux: optional dict, filled with the MoE statistics of this pass as the
    reference's forward returns them (``moe_aux_loss`` and
    ``moe_dropped_frac`` summed over the MoE layers, ``moe_max_load`` their
    largest); untouched by models without MoE layers.
    pc: partition constraints (:mod:`repro_torch.parallel.sharding`); with
    a mesh, ``tokens`` are this rank's rows and the MoE layers dispatch
    over the mesh (:mod:`repro_torch.models.moe`).  With a live "model"
    axis the pass computes tensor-parallel in every mode
    (``pc.tensor_parallel``): the params are then this rank's pieces of
    the leaves that bind "model", the cache (prefill, decode) this rank's
    piece under ``pc``'s binding (``sharding.cache_shardings``), and the
    logits, where the vocabulary splits, this rank's columns of it
    (:func:`loss_fn` reduces them; ``serve.engine.gather_logits`` gathers
    them).
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
    tp = pc.tensor_parallel(cfg, s, mode, _src_len(cfg, extras)) \
        if pc is not None else None
    # the leaves outside the layer stacks: gathered once a pass (a tied
    # embedding once, read twice)
    embed = gathered(params["embed"], "embed", pc)
    x = embed_tokens(embed, tokens, cfg, tp=tp)
    if cfg.family == "vlm" and "patches" in extras:
        # under sequence parallelism x holds this rank's rows
        x = _merge_patches(x, extras["patches"],
                           tp.rank * x.shape[1] if tp and tp.sp else 0, s)
    if cfg.family == "encdec":
        # under sequence parallelism x holds this rank's rows
        x = x + _sinusoidal(_row_positions(positions, x.shape[1], tp),
                            cfg.d_model).to(x.dtype)
    rope = _rope_for(cfg, positions, extras)

    if cfg.family == "ssm":
        x = _rwkv_forward(params, x, cfg, mode=mode, cache=cache,
                          remat=remat, pc=pc, tp=tp)
    elif cfg.family == "encdec":
        x = _encdec_forward(params, x, cfg, mode=mode, cache=cache, pos=pos,
                            extras=extras, attn_impl=attn_impl, remat=remat,
                            pc=pc, tp=tp)
    elif cfg.family == "hybrid":
        x = _hybrid_forward(params, x, cfg, rope=rope, mode=mode,
                            cache=cache, pos=pos, attn_impl=attn_impl,
                            remat=remat, pc=pc, tp=tp)
    elif mode == "train":
        for group in ("dense_layers", "moe_layers"):
            if group in params:
                x = _train_layers(params[group], x, cfg, prefix=group,
                                  rope=rope, attn_impl=attn_impl,
                                  remat=remat, aux=aux, pc=pc, tp=tp,
                                  d_ff=_dense_d_ff(cfg))
    else:
        for group, key in (("dense_layers", "dense"), ("moe_layers", "moe")):
            if group not in params:
                continue
            layers = params[group]
            for i in range(_depth(layers)):
                lc = None if cache is None else _layer(cache[key], i)
                x, _ = _attn_block(gathered(_layer(layers, i), group, pc, 1),
                                   x, cfg, rope=rope, mode=mode, cache=lc,
                                   pos=pos, aux=aux, pc=pc, tp=tp,
                                   d_ff=_dense_d_ff(cfg))

    x = apply_norm(gathered(params["final_norm"], "final_norm", pc), x, cfg)
    return lm_logits(embed, x, cfg, tp=tp), cache


def loss_fn(params, cfg: ModelConfig, batch, *, pc=None, attn_impl="masked",
            remat="none"):
    """Next-token CE loss.  batch: {"tokens", "labels"} (B, S) int tensors
    on the params' device, and any extras (every other entry, e.g. a VLM's
    ``patches`` and ``mrope_pos``) for :func:`forward`; labels < 0 are
    masked out.  Returns (total,
    metrics): for a model with MoE layers the total adds ``0.01 *
    moe_aux_loss / num_layers`` to the loss and the metrics carry the MoE
    statistics beside ``loss``, as the reference's; otherwise the total is
    the loss and the metrics ``{"loss": loss}``.

    ``pc`` with a mesh whose data-parallel axes (``pc.dp_axes``) hold
    several ranks: ``batch`` is this rank's rows, and the returned loss and
    statistics are this rank's terms of the global batch's, whose mean over
    those ranks is the reference's value on the global batch (and whose
    gradients' mean is its gradient): the cross-entropy sums this rank's
    masked terms over the global count of valid labels (a mean of the
    ranks' own means would weigh a label by its rank's count), times the
    number of ranks.  Under tensor-parallel compute the cross-entropy is
    vocabulary-parallel, and every "model" rank returns the same loss."""
    aux = {}
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    logits, _ = forward(params, cfg, tokens=batch["tokens"], mode="train",
                        extras=extras, attn_impl=attn_impl, remat=remat,
                        aux=aux, pc=pc)
    labels = batch["labels"]
    mask = labels >= 0
    tp = pc.tensor_parallel(cfg, labels.shape[1], "train",
                            _src_len(cfg, extras)) if pc is not None else None
    axes = pc.dp_axes if pc is not None else ()
    if axes:
        count = comm.all_reduce(mask.sum().float(), pc.mesh, axes)
        loss = cross_entropy(logits, labels.clamp_min(0), cfg, mask=mask,
                             denominator=count.clamp_min(1.0)
                             / comm.group_size(pc.mesh, axes), tp=tp)
    else:
        loss = cross_entropy(logits, labels.clamp_min(0), cfg, mask=mask,
                             tp=tp)
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
