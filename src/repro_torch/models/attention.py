"""GQA and MLA attention: train, prefill and decode paths (port of
``repro.models.attention``).

* **train** runs, by ``attn_impl``: ``"masked"`` (the reference's default)
  plain :func:`full_attention`; ``"recursive"``
  :func:`recursive_causal_attention` for S >= 512 without a sliding window
  (else masked), as the reference does; ``"flash"`` the flash kernel,
  forward only: under grad it raises, as ``jax.grad`` through the
  reference's Pallas call fails.
* **prefill** runs the flash kernel through
  :func:`repro_torch.kernels.ops.flash_attention_bshd` (the plain version on
  the CPU).  The JAX package runs ``chunked_attention`` there; both compute
  the same causal online-softmax attention, except that the JAX path casts
  the probabilities to the compute dtype before the PV product.  A model
  with a logit softcap prefills through the plain :func:`chunked_attention`
  instead, as the reference does (its kernel takes no cap).
* **decode** attends one query token over every cache slot with plain
  :func:`full_attention` and ``kv_valid = pos + 1`` masking, as the
  reference does (it is not a kernel there either).
* **sliding window** (``cfg.sliding_window``) masks keys more than
  ``window - 1`` positions back in every mode.  A cache of exactly
  ``window`` slots is a ring: prefill leaves the last ``window`` positions
  in slots ``p mod window``, decode writes slot ``pos mod window`` and
  rebuilds each slot's absolute position (:func:`_ring_slots`), so the
  causal, window and ``kp >= 0`` masks stay exact.

* **on a mesh** (prefill and decode under tensor-parallel compute,
  :func:`gqa_attention`'s ``heads``): a rank projects its query heads and
  either its own KV heads, which its cache piece holds (the reference's
  in-place ``"dus"`` write), or every KV head, of which its cache piece
  holds a slice of the slots (``seq_split``): prefill writes the slots the
  rank holds, ring slots included; decode's new token is written by the
  rank that holds its slot (the reference's ``"onehot"`` write is local
  too), the queries are gathered over "model", each rank computes every
  head's partial (m, l, acc) over its slots with the one-device masks, and
  the partials are gathered and merged (:func:`_decode_seq_split`).  MLA
  (:func:`mla_attention`'s ``heads``) splits its heads alike, with its
  latent projections and norms whole on every rank; its latent cache has no
  head dimension, so on a mesh it is whole or split by its slots, whose
  decode merges the partials in the latent space
  (:func:`_mla_decode_seq_split`).  A cross-attention takes this rank's
  query heads and its KV heads of the encoder's K/V.

* **MLA** (DeepSeek-V2, :func:`mla_attention`) caches the normalized
  latent ``ckv`` (``kv_lora_rank`` wide) and the shared rotated ``krope``
  (``qk_rope_head_dim``) instead of per-head K/V.  Train and prefill
  decompress them to per-head K (nope + rope) and V; prefill runs the
  flash kernel with a V narrower than Q and K.  Decode absorbs ``wkv_b``
  into the query and the output, so it attends in the latent space.

* **logit softcap** (``cfg.attn_logit_softcap``): scores become
  ``cap * tanh(scores / cap)`` before the mask in every plain path (masked,
  recursive, chunked, decode); train mode never runs flash on a capped
  model, as the reference.  ``mla_attention`` ignores the cap, as the
  reference's does.
* **bidirectional** GQA (an encoder's) drops the causal mask;
  **cross-attention** (:func:`cross_attention`) attends a decoder's
  queries over the encoder's K/V (:func:`cross_kv`) with the plain
  non-causal :func:`full_attention`, as the reference.

Shapes: x (B, S, d); q (B, S, H, D); k/v (B, S, KV, D); H = KV * G.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_norm, apply_rope
from repro_torch.models.params import spec
from repro_torch.parallel import comm

NEG_INF = -2.0 ** 30   # large-but-finite; keeps softmax NaN-free on empty rows


def attn_specs(cfg: ModelConfig, num_kv_heads: Optional[int] = None):
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    kv = num_kv_heads or cfg.num_kv_heads
    return {
        "wq": spec((d, h, hd), ("embed", "heads", None)),
        "wk": spec((d, kv, hd), ("embed", "kv_heads", None)),
        "wv": spec((d, kv, hd), ("embed", "kv_heads", None)),
        "wo": spec((h, hd, d), ("heads", None, "embed")),
    }


def mla_specs(cfg: ModelConfig):
    a = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = a.qk_nope_head_dim + a.qk_rope_head_dim
    return {
        "wq_a": spec((d, a.q_lora_rank), ("embed", "q_lora")),
        "q_norm": spec((a.q_lora_rank,), ("q_lora",), init="ones"),
        "wq_b": spec((a.q_lora_rank, h, qk), ("q_lora", "heads", None)),
        "wkv_a": spec((d, a.kv_lora_rank + a.qk_rope_head_dim),
                      ("embed", "kv_lora")),
        "kv_norm": spec((a.kv_lora_rank,), ("kv_lora",), init="ones"),
        "wkv_b": spec((a.kv_lora_rank, h, a.qk_nope_head_dim + a.v_head_dim),
                      ("kv_lora", "heads", None)),
        "wo": spec((h, a.v_head_dim, d), ("heads", None, "embed")),
    }


def _mask_bias(q_pos, k_pos, *, causal: bool, window: int,
               kv_valid: Optional[int] = None) -> torch.Tensor:
    """Additive bias (0 / NEG_INF), fp32, of shape (Sq, Sk) from positions."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    ok = torch.ones((qp.shape[0], kp.shape[1]), dtype=torch.bool,
                    device=qp.device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    if kv_valid is not None:
        ok &= kp < kv_valid
    ok &= kp >= 0
    zero = torch.zeros((), dtype=torch.float32, device=qp.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _softcap(scores, cap: float):
    """``cap * tanh(scores / cap)``; the scores themselves without a cap."""
    if cap and cap > 0.0:
        return cap * torch.tanh(scores / cap)
    return scores


def _group(q, num_kv):
    """(B, Sq, H, D) -> (B, KV, G, Sq, D)."""
    b, s, h, dd = q.shape
    return q.reshape(b, s, num_kv, h // num_kv, dd).permute(0, 2, 3, 1, 4)


def _ungroup(o):
    """(B, KV, G, Sq, D) -> (B, Sq, H, D)."""
    b, kv, g, s, dd = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, kv * g, dd)


def full_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                   kv_valid=None, softcap=0.0, k_pos=None):
    """Plain masked attention; scores and softmax in fp32, probabilities
    cast to q's dtype for the PV product.  q_offset: absolute position of
    q[0] (decode: pos).  kv_valid: number of valid cache slots.  softcap:
    the logit cap (0: none).  k_pos: absolute position of each key (a ring
    cache's slots), default 0 .. Sk - 1."""
    b, sq, h, dd = q.shape
    kvh = k.shape[2]
    qg = _group(q, kvh).float()                           # (B,KV,G,Sq,D)
    kk = k.transpose(1, 2).float()                        # (B,KV,Sk,D)
    vv = v.transpose(1, 2)
    # bf16 products are exact in fp32, so upcasting first gives the
    # reference's fp32-accumulated scores
    scores = _softcap(torch.einsum("bkgqd,bksd->bkgqs", qg, kk)
                      * (1.0 / math.sqrt(dd)), softcap)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    if k_pos is None:
        k_pos = torch.arange(k.shape[1], device=q.device)
    scores = scores + _mask_bias(q_pos, k_pos, causal=causal, window=window,
                                 kv_valid=kv_valid)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, vv)
    return _ungroup(out)


def chunked_attention(q, k, v, *, causal=True, window=0, chunk_k=1024,
                      softcap=0.0):
    """K-chunked online-softmax attention (the reference's prefill path):
    the (Sq, Sk) scores exist one (Sq, chunk_k) slab at a time; fp32
    scores, m, l and acc, probabilities cast to q's dtype for the PV
    product.  A chunk that does not divide Sk shrinks to gcd(Sk, chunk_k),
    as the reference's.  The port prefills a model with a softcap here."""
    b, sq, h, dd = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    if sk % chunk_k != 0:
        chunk_k = math.gcd(sk, chunk_k) or sk
    qg = _group(q, kvh).float()                           # (B,KV,G,Sq,D)
    kk = k.transpose(1, 2).float()                        # (B,KV,Sk,D)
    vv = v.transpose(1, 2)
    q_pos = torch.arange(sq, device=q.device)
    scale = 1.0 / math.sqrt(dd)
    g = h // kvh
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, dv), dtype=torch.float32,
                      device=q.device)
    for j0 in range(0, sk, chunk_k):
        s = _softcap(torch.einsum("bkgqd,bksd->bkgqs", qg,
                                  kk[:, :, j0:j0 + chunk_k]) * scale, softcap)
        k_pos = j0 + torch.arange(chunk_k, device=q.device)
        s = s + _mask_bias(q_pos, k_pos, causal=causal, window=window)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bksd->bkgqd", p.to(q.dtype),
            vv[:, :, j0:j0 + chunk_k]).float()
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return _ungroup(out.to(q.dtype))


def merge_partial(parts):
    """Merge (m, l, acc) partial-softmax triples (the recursive causal
    decomposition)."""
    m = parts[0][0]
    for p in parts[1:]:
        m = torch.maximum(m, p[0])
    l = sum(torch.exp(pm - m) * pl for pm, pl, _ in parts)
    acc = sum(torch.exp(pm - m)[..., None] * pa for pm, _, pa in parts)
    return m, l, acc


def _partial_full(q, k, v, *, causal, q_offset, k_offset, softcap=0.0):
    """Un-normalized attention stats (m, l, acc) of q against a k/v slice
    (:func:`_partial_stats`), causal at the given offsets."""
    bias = None
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        bias = _mask_bias(q_pos, k_pos, causal=True, window=0)
    return _partial_stats(q, k, v, bias, softcap)


def _partial_stats(q, k, v, bias=None, softcap=0.0):
    """(m, l, acc) of q against a k/v slice: fp32 scores plus the additive
    ``bias`` (None: none), probabilities cast to q's dtype for the PV
    product.  A slice with every key masked gives m = NEG_INF, which
    :func:`merge_partial` weighs by 0 beside any valid one."""
    b, sq, h, dd = q.shape
    kvh = k.shape[2]
    qg = _group(q, kvh).float()
    kk = k.transpose(1, 2).float()
    vv = v.transpose(1, 2)
    s = _softcap(torch.einsum("bkgqd,bksd->bkgqs", qg, kk)
                 * (1.0 / math.sqrt(dd)), softcap)
    if bias is not None:
        s = s + bias
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqs,bksd->bkgqd", p.to(q.dtype), vv).float()
    return m, l, acc


def recursive_causal_attention(q, k, v, *, levels=3, softcap=0.0,
                               q_offset=0, k_offset=0):
    """FLOP-exact causal attention via recursive block decomposition:
    causal(S) = causal(lower half) + dense(q_hi x k_lo) + causal(upper
    half), down to ``levels`` or 128 rows."""
    def stats(q, k, v, level, q_off, k_off):
        sq = q.shape[1]
        if level == 0 or sq <= 128 or sq % 2:
            return _partial_full(q, k, v, causal=True, q_offset=q_off,
                                 k_offset=k_off, softcap=softcap)
        half = sq // 2
        q_lo, q_hi = q[:, :half], q[:, half:]
        k_lo, k_hi = k[:, :half], k[:, half:]
        v_lo, v_hi = v[:, :half], v[:, half:]
        m1, l1, a1 = stats(q_lo, k_lo, v_lo, level - 1, q_off, k_off)
        # strictly-lower dense rectangle: q_hi attends all of k_lo, unmasked
        m2, l2, a2 = _partial_full(q_hi, k_lo, v_lo, causal=False,
                                   q_offset=0, k_offset=0, softcap=softcap)
        m3, l3, a3 = stats(q_hi, k_hi, v_hi, level - 1, q_off + half,
                           k_off + half)
        m_hi, l_hi, a_hi = merge_partial([(m2, l2, a2), (m3, l3, a3)])
        return (torch.cat([m1, m_hi], dim=-1), torch.cat([l1, l_hi], dim=-1),
                torch.cat([a1, a_hi], dim=-2))

    m, l, acc = stats(q, k, v, levels, q_offset, k_offset)
    out = acc / l.clamp_min(1e-30)[..., None]
    return _ungroup(out.to(q.dtype))


def _ring_slots(pos: int, window: int, device=None) -> torch.Tensor:
    """Absolute positions held by each ring-buffer slot when ``pos`` tokens
    have been written: slot s holds the largest p < pos with p = s (mod
    window); negative -> never written (masked by ``kp >= 0``)."""
    s = torch.arange(window, device=device)
    return pos - 1 - torch.remainder(pos - 1 - s, window)


def _ring_fill(cache_arr, new, window: int) -> None:
    """Prefill of a ring cache, in place: positions s - window .. s - 1 of
    ``new`` (B, s, ...) go to slots p mod window (two slice copies)."""
    s = new.shape[1]
    r = s % window
    tail = new[:, s - window:].to(cache_arr.dtype)
    cache_arr[:, r:] = tail[:, :window - r]
    cache_arr[:, :r] = tail[:, window - r:]


def _cache_write(cache_arr, new, slot: int):
    """Decode cache write at ``slot``, in place (the reference's "dus"
    branch; a PyTorch cache is a mutable buffer, so no copy is made)."""
    cache_arr[:, slot:slot + new.shape[1]] = new.to(cache_arr.dtype)
    return cache_arr


ATTN_IMPLS = ("masked", "recursive", "flash")


def _kv_heads_for(h0: int, n: int, group: int):
    """The KV heads query heads ``h0 .. h0 + n - 1`` read (``group`` query
    heads a KV head): (first, count, index), ``index`` None where the
    heads read them in groups of equal size, else, per query head, its KV
    head among the ``count`` (K and V are then expanded to one a query
    head)."""
    ids = [(h0 + j) // group for j in range(n)]
    kv0, count = ids[0], ids[-1] - ids[0] + 1
    if n % count == 0 and ids == [kv0 + j // (n // count) for j in range(n)]:
        return kv0, count, None
    return kv0, count, torch.tensor([i - kv0 for i in ids])


def gqa_attention(p, x, cfg: ModelConfig, *, rope=None, mode="prefill",
                  cache=None, pos=None, attn_impl="masked",
                  bidirectional=False, heads=None, seq_split=None):
    """Full GQA attention block.

    mode: "train" | "prefill" | "decode".
    attn_impl (train): "masked" | "recursive" | "flash"; a model with a
    logit softcap never runs flash in train mode, and "recursive" runs only
    causal attention without a window, as the reference.
    bidirectional: no causal mask (an encoder's blocks).
    rope: (cos, sin) tables matching x's sequence positions, or None.
    cache: {"k", "v"} (B, cache_len, KV, D) buffers, written in place;
    cache_len = min(max_len, window) under a sliding window (a ring when it
    equals the window).
    pos: number of tokens already in the cache (decode).
    heads: (first, count), this rank's query heads under tensor-parallel
    compute: ``wq`` and ``wo`` are its pieces of ``count`` heads, ``wk``
    and ``wv`` its pieces of the KV heads where those split too (the
    cache then holds its KV heads), else the whole leaves, of which only
    the KV heads its query heads read are projected (the ``kv_heads``
    fallback), and, where there is a cache, every KV head, which that
    cache holds.  ``out`` is then this rank's partial sum of the output
    projection.
    seq_split: (mesh, rank, size) where the cache holds this rank's
    ``1 / size`` of the slots of every KV head (serving's ``"seq"``
    layout, :func:`_decode_seq_split`); prefill writes the slots this rank
    holds.
    Returns (out, cache).
    """
    dt = x.dtype
    b, s, d = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wk, wv, sel = p["wk"], p["wv"], None
    if heads is not None:
        h0, h = heads
        if wk.shape[1] == kvh:
            sel = _kv_heads_for(h0, h, cfg.num_heads // cfg.num_kv_heads)
            if cache is None:
                # only the KV heads this rank's query heads read
                kv0, kvh, idx = sel
                wk, wv = wk[:, kv0:kv0 + kvh], wv[:, kv0:kv0 + kvh]
                sel = (0, kvh, idx)
        else:
            kvh = wk.shape[1]
    q = (x @ p["wq"].to(dt).reshape(d, h * hd)).view(b, s, h, hd)
    k = (x @ wk.to(dt).reshape(d, kvh * hd)).view(b, s, kvh, hd)
    v = (x @ wv.to(dt).reshape(d, kvh * hd)).view(b, s, kvh, hd)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    window = cfg.sliding_window
    cap = cfg.attn_logit_softcap
    causal = not bidirectional
    if mode == "train":
        k, v = _read_heads(k, sel), _read_heads(v, sel)
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} (one of {ATTN_IMPLS})")
        if attn_impl == "flash" and not cap:
            if torch.is_grad_enabled() and q.requires_grad:
                raise NotImplementedError(
                    "the flash kernel is forward-only (as the reference's "
                    "Pallas kernel, which jax.grad cannot differentiate); "
                    "train with attn_impl='masked' or 'recursive'")
            out = ops.flash_attention_bshd(q, k, v, causal=causal,
                                           window=window)
        elif attn_impl == "recursive" and causal and s >= 512 \
                and not window:
            # the reference computes the recursive path and then replaces
            # it with the masked one under a window; only the latter runs
            out = recursive_causal_attention(q, k, v, softcap=cap)
        else:
            out = full_attention(q, k, v, causal=causal, window=window,
                                 softcap=cap)
    elif mode == "prefill":
        ka, va = _read_heads(k, sel), _read_heads(v, sel)
        if cap:
            # the reference's prefill path; its kernel takes no cap
            out = chunked_attention(q, ka, va, causal=causal, window=window,
                                    softcap=cap)
        else:
            out = ops.flash_attention_bshd(q, ka, va, causal=causal,
                                           window=window)
        del ka, va
        if cache is not None:
            # prefill attends to the unrounded k/v; the cache keeps its dtype
            lo = 0 if seq_split is None else \
                seq_split[1] * cache["k"].shape[1]
            for key, new in (("k", k), ("v", v)):
                _prefill_write(cache[key], new, window, lo)
    elif mode == "decode":
        if cache is None or pos is None:
            raise ValueError("decode needs a cache and pos")
        if seq_split is not None:
            out = _decode_seq_split(q, k, v, cache, pos, window, cap,
                                    seq_split, heads)
        elif window and cache["k"].shape[1] == window:
            slot = pos % window
            ck = _read_heads(_cache_write(cache["k"], k, slot), sel)
            cv = _read_heads(_cache_write(cache["v"], v, slot), sel)
            out = full_attention(q, ck.to(dt), cv.to(dt), causal=True,
                                 window=window, q_offset=pos, softcap=cap,
                                 k_pos=_ring_slots(pos + 1, window,
                                                   q.device))
        else:
            ck = _read_heads(_cache_write(cache["k"], k, pos), sel)
            cv = _read_heads(_cache_write(cache["v"], v, pos), sel)
            out = full_attention(q, ck.to(dt), cv.to(dt), causal=False,
                                 window=window, kv_valid=pos + 1,
                                 q_offset=pos, softcap=cap)
    else:
        raise ValueError(f"mode {mode!r} is not one of train | prefill | "
                         f"decode")

    y = out.reshape(b, s, h * hd) @ p["wo"].to(dt).reshape(h * hd, d)
    return y, cache


def _read_heads(t, sel):
    """The KV heads (dim 2) that this rank's query heads read: ``sel`` =
    (first, count, index) from :func:`_kv_heads_for` (``index``: each query
    head's KV head among them, K and V then expanded to one a query head);
    ``t`` itself for None."""
    if sel is None:
        return t
    kv0, count, idx = sel
    if kv0 != 0 or count != t.shape[2]:
        t = t[:, :, kv0:kv0 + count]
    return t if idx is None else t[:, :, idx.to(t.device)]


def _prefill_write(arr, new, window: int, lo: int = 0) -> None:
    """Prefill's cache write, in place, of the global slots ``lo ..
    lo + arr.shape[1]`` of a cache: position p in slot p,
    or, where a window shorter than the prompt makes the cache a ring,
    slot p mod window for the last ``window`` positions."""
    s = new.shape[1]
    m = arr.shape[1]
    if window and window < s:
        if lo == 0 and m == window:
            _ring_fill(arr, new, window)
            return
        # the slots' positions after s tokens, all written (p >= s - window)
        slots = _ring_slots(s, window, new.device)[lo:lo + m]
        arr.copy_(new[:, slots].to(arr.dtype))
        return
    hi = min(lo + m, s)
    if hi > lo:
        arr[:, :hi - lo] = new[:, lo:hi].to(arr.dtype)


def _decode_seq_split(q, k, v, cache, pos: int, window: int, cap: float,
                      split, heads):
    """Decode over a cache that holds this rank's slots of every KV head
    (``split`` = (mesh, rank, size); ``k``, ``v`` (B, 1, KV, D) every KV
    head of the new token): the rank holding the new token's slot writes
    it (the reference's ``"onehot"`` write is local there too); the
    queries (B, 1, H, D) are gathered over "model" (``heads``: this rank's
    (first, count); None where every rank computes every head); each rank
    computes the partial (m, l, acc) of every query head over its slots,
    with the masks of the one-device decode (the slots' absolute positions,
    the ring's included); the partials are gathered over "model" and
    merged (:func:`_merge_over_model`), and the rank keeps its heads."""
    mesh, rank, size = split
    dt = q.dtype
    n = cache["k"].shape[1]
    lo = rank * n
    ring = bool(window) and n * size == window
    slot = pos % window if ring else pos
    if lo <= slot < lo + n:
        _cache_write(cache["k"], k, slot - lo)
        _cache_write(cache["v"], v, slot - lo)
    if ring:
        k_pos = _ring_slots(pos + 1, window, q.device)[lo:lo + n]
    else:
        k_pos = lo + torch.arange(n, device=q.device)
    q_pos = pos + torch.arange(q.shape[1], device=q.device)
    part = _partial_stats(_all_heads(q, mesh, heads), cache["k"].to(dt),
                          cache["v"].to(dt),
                          _mask_bias(q_pos, k_pos, causal=ring,
                                     window=window,
                                     kv_valid=None if ring else pos + 1),
                          cap)
    return _merged_heads(part, mesh, heads, dt)


def _merged_heads(part, mesh, heads, dt):
    """The grouped partials (m, l, acc) of every query head merged over
    "model" (:func:`_merge_over_model`) and normalised: this rank's heads
    of the output (B, Sq, H, D) in ``dt``."""
    m, l, acc = _merge_over_model(part, mesh)
    return _own_heads(_ungroup((acc / l.clamp_min(1e-30)[..., None]).to(dt)),
                      heads)


def _all_heads(t, mesh, heads):
    """Every "model" rank's heads (dim 2) of ``t`` gathered (``heads``
    None: ``t`` holds every head already)."""
    if heads is None:
        return t
    with comm.purpose("query_gather"):
        return comm.all_gather(t.contiguous(), mesh, "model", 2)


def _own_heads(out, heads):
    """This rank's heads (dim 2) of an output over every head."""
    return out if heads is None else out[:, :, heads[0]:heads[0] + heads[1]]


def _merge_over_model(part, mesh):
    """Every "model" rank's partial (m, l, acc), gathered and merged
    (:func:`merge_partial`)."""
    with comm.purpose("partial_merge"):
        m, l, acc = (comm.all_gather(t.contiguous()[None], mesh, "model", 0)
                     for t in part)
    return merge_partial(list(zip(m.unbind(0), l.unbind(0),
                                  acc.unbind(0))))


def cross_attention(p, x, kv_cache, cfg: ModelConfig, heads=None,
                    seq_split=None):
    """A decoder's cross-attention over the encoder's K/V (``cross_kv``;
    (B, S_src, KV, D), cast to x's dtype): plain non-causal
    :func:`full_attention` with no cap, as the reference's.  ``heads``:
    (first, count), this rank's query heads under tensor-parallel compute
    (``wq`` and ``wo`` its pieces, ``out`` this rank's partial sum of the
    output projection); the K/V hold this rank's KV heads where those
    split (``wk`` pieces), else every KV head, of which it reads those its
    query heads read.  ``seq_split``: (mesh, rank, size) where the K/V (a
    decode's cross cache) hold this rank's source frames of every KV head:
    the queries are gathered over "model", each rank's partial (m, l, acc)
    over its frames merged (:func:`_merge_over_model`)."""
    dt = x.dtype
    b, s, d = x.shape
    h, hd = cfg.num_heads if heads is None else heads[1], cfg.head_dim
    q = (x @ p["wq"].to(dt).reshape(d, h * hd)).view(b, s, h, hd)
    k, v = kv_cache["k"].to(dt), kv_cache["v"].to(dt)
    if seq_split is not None:
        mesh = seq_split[0]
        out = _merged_heads(_partial_stats(_all_heads(q, mesh, heads), k, v),
                            mesh, heads, dt)
    else:
        # K/V of every KV head: the ones this rank's query heads read
        sel = None if heads is None or k.shape[2] != cfg.num_kv_heads \
            else _kv_heads_for(heads[0], heads[1],
                               cfg.num_heads // cfg.num_kv_heads)
        out = full_attention(q, _read_heads(k, sel), _read_heads(v, sel),
                             causal=False, window=0)
    return out.reshape(b, s, h * hd) @ p["wo"].to(dt).reshape(h * hd, d)


def cross_kv(p, enc_out, cfg: ModelConfig):
    """The cross-attention K/V of one decoder layer from the encoder's
    output (B, S_src, d), in its dtype: {"k", "v"} (B, S_src, KV, D), KV
    the heads of ``wk`` (this rank's piece of them under tensor-parallel
    compute where the KV heads split)."""
    dt = enc_out.dtype
    b, s, d = enc_out.shape
    kvh, hd = p["wk"].shape[1], cfg.head_dim
    k = (enc_out @ p["wk"].to(dt).reshape(d, kvh * hd)).view(b, s, kvh, hd)
    v = (enc_out @ p["wv"].to(dt).reshape(d, kvh * hd)).view(b, s, kvh, hd)
    return {"k": k, "v": v}


def mla_attention(p, x, cfg: ModelConfig, *, rope, mode="prefill",
                  cache=None, pos=None, attn_impl="masked", heads=None,
                  seq_split=None):
    """Multi-head Latent Attention (DeepSeek-V2).

    mode: "train" | "prefill" | "decode".
    attn_impl (train): "recursive" runs :func:`recursive_causal_attention`
    for S >= 512; anything else the masked :func:`full_attention` (the
    reference ignores "flash" here, and so does the port).
    rope: (cos, sin) tables of width ``qk_rope_head_dim // 2``.
    cache: {"ckv" (B, max_len, kv_lora_rank), "krope" (B, max_len,
    qk_rope_head_dim)}, written in place.
    pos: number of tokens already in the cache (decode).
    heads: (first, count), this rank's heads under tensor-parallel
    compute: ``wq_b``, ``wkv_b`` and ``wo`` are its pieces of ``count``
    heads; ``wq_a``, ``wkv_a`` and the two latent norms run whole on the
    entered input (every rank writes the same latent cache); ``out`` is
    then this rank's partial sum of the output projection.
    seq_split: (mesh, rank, size) where the cache holds this rank's
    ``1 / size`` of the slots (serving's ``"seq"`` layout): prefill writes
    the slots it holds, decode runs :func:`_mla_decode_seq_split`.
    Returns (out, cache).

    Decode attends in the latent space: q_eff = q_nope w_k (per head, into
    the kv_lora space), scores = q_eff ckv^T + q_rope krope^T in fp32,
    the softmax over the valid slots, o = (probs ckv) w_v.

    ``cfg.attn_logit_softcap`` is not read: the reference's MLA ignores it.
    """
    a = cfg.mla
    dt = x.dtype
    b, s, d = x.shape
    h = cfg.num_heads if heads is None else heads[1]
    nope, rdim, r = a.qk_nope_head_dim, a.qk_rope_head_dim, a.kv_lora_rank
    cos, sin = rope

    q_lat = apply_norm({"scale": p["q_norm"]}, x @ p["wq_a"].to(dt), cfg,
                       eps=1e-6)
    q = (q_lat @ p["wq_b"].to(dt).reshape(a.q_lora_rank, -1)).view(
        b, s, h, nope + rdim)
    q_nope, q_rope = q[..., :nope], apply_rope(q[..., nope:], cos, sin)

    kv_a = x @ p["wkv_a"].to(dt)                           # (B, S, r + rope)
    c_kv = apply_norm({"scale": p["kv_norm"]}, kv_a[..., :r], cfg, eps=1e-6)
    k_rope = apply_rope(kv_a[..., None, r:], cos, sin)[..., 0, :]  # shared

    wkv_b = p["wkv_b"].to(dt)                              # (r, H, nope + v)
    w_k, w_v = wkv_b[..., :nope], wkv_b[..., nope:]

    if mode in ("train", "prefill"):
        k_nope = torch.einsum("bsr,rhk->bshk", c_kv, w_k)
        v = torch.einsum("bsr,rhk->bshk", c_kv, w_v)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, rdim)],
                      dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        if mode == "train":
            if attn_impl not in ATTN_IMPLS:
                raise ValueError(f"attn_impl {attn_impl!r} (one of "
                                 f"{ATTN_IMPLS})")
            if attn_impl == "recursive" and s >= 512:
                out = recursive_causal_attention(qq, k, v)
            else:
                out = full_attention(qq, k, v, causal=True)
        else:
            out = ops.flash_attention_bshd(qq, k, v, causal=True)
            if cache is not None:
                lo = 0 if seq_split is None else \
                    seq_split[1] * cache["ckv"].shape[1]
                _prefill_write(cache["ckv"], c_kv, 0, lo)
                _prefill_write(cache["krope"], k_rope, 0, lo)
    elif mode == "decode":
        if cache is None or pos is None:
            raise ValueError("decode needs a cache and pos")
        q_eff = torch.einsum("bshk,rhk->bshr", q_nope, w_k)
        if seq_split is not None:
            o_lat = _mla_decode_seq_split(q_eff, q_rope, c_kv, k_rope, cache,
                                          pos, nope + rdim, seq_split, heads)
        else:
            ckv = _cache_write(cache["ckv"], c_kv, pos).to(dt)
            krope = _cache_write(cache["krope"], k_rope, pos).to(dt)
            probs = torch.softmax(_mla_scores(q_eff, q_rope, ckv, krope,
                                              nope + rdim, pos, 0),
                                  dim=-1).to(dt)
            o_lat = torch.einsum("bhst,btr->bshr", probs, ckv)
        out = torch.einsum("bshr,rhk->bshk", o_lat, w_v)
    else:
        raise ValueError(f"mode {mode!r} is not one of train | prefill | "
                         f"decode")

    y = out.reshape(b, s, h * a.v_head_dim) @ \
        p["wo"].to(dt).reshape(h * a.v_head_dim, d)
    return y, cache


def _mla_scores(q_eff, q_rope, ckv, krope, qk: int, pos: int, lo: int):
    """MLA decode's scores (B, H, S, T) in fp32 of the queries at ``pos``
    .. against the latent slots ``lo`` .. ``lo + T - 1``: (q_eff ckv^T +
    q_rope krope^T) / sqrt(qk), the slots past the last query masked (bf16
    products are exact in fp32: the reference's fp32-accumulated
    scores)."""
    scores = (torch.einsum("bshr,btr->bhst", q_eff.float(), ckv.float())
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             krope.float())) / math.sqrt(qk)
    return scores + _mask_bias(
        pos + torch.arange(q_eff.shape[1], device=ckv.device),
        lo + torch.arange(ckv.shape[1], device=ckv.device), causal=False,
        window=0, kv_valid=pos + 1)


def _mla_decode_seq_split(q_eff, q_rope, c_kv, k_rope, cache, pos: int,
                          qk: int, split, heads):
    """MLA's absorbed decode over a latent cache that holds this rank's
    slots (``split`` = (mesh, rank, size)), as :func:`_decode_seq_split`
    for GQA: the rank holding the new token's slot writes ``c_kv`` /
    ``k_rope``; ``q_eff`` (B, 1, H, r) and ``q_rope`` are gathered over
    "model" (``heads``: this rank's (first, count); None where every rank
    computes every head); each rank computes every head's partial (m, l,
    acc) over its slots in the latent space (acc (B, H, 1, r)), masked on
    the slots' absolute positions; the partials are merged
    (:func:`_merge_over_model`) and the rank keeps its heads' latent
    output (B, 1, h, r), which ``w_v`` and the row-parallel ``wo`` take."""
    mesh, rank, _ = split
    dt = q_eff.dtype
    n = cache["ckv"].shape[1]
    lo = rank * n
    if lo <= pos < lo + n:
        _cache_write(cache["ckv"], c_kv, pos - lo)
        _cache_write(cache["krope"], k_rope, pos - lo)
    ckv, krope = cache["ckv"].to(dt), cache["krope"].to(dt)
    scores = _mla_scores(_all_heads(q_eff, mesh, heads),
                         _all_heads(q_rope, mesh, heads), ckv, krope, qk,
                         pos, lo)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    part = (m, p.sum(dim=-1),
            torch.einsum("bhst,btr->bhsr", p.to(dt), ckv).float())
    m, l, acc = _merge_over_model(part, mesh)
    return _own_heads(
        (acc / l.clamp_min(1e-30)[..., None]).to(dt).transpose(1, 2), heads)
