"""Mamba2 (SSD) and RWKV6 sequence mixers (port of ``repro.models.ssm``).

Train and prefill run the chunked SSD scan through the kernel wrapper
:func:`repro_torch.kernels.ops.ssd_chunked_kernel` (the plain sequential
recurrence on the CPU), which under grad differentiates through the SSD
backward kernel; prefill starts from the cache's state and keeps the final
state, train starts from zeros and drops it, as the reference does.  Decode
is the plain recurrent update, as in the reference (it is not a kernel
there either).  Caches are written in place.

RWKV6 ("Finch") runs no kernel, in the reference as here: train and
prefill run the chunked WKV recurrence :func:`wkv6_chunked` in plain
PyTorch with an fp32 state (from the cache's state in prefill), decode
steps the recurrence token by token.  Its chunk shrinks to gcd(L, chunk)
when the chunk does not divide L, as the reference's does, so the two
compute the same sums.

Under tensor parallelism (a ``tp`` layout, :mod:`repro_torch.parallel.sharding`)
each mixer runs on this rank's heads: Mamba2 on its narrow ``in_proj``
piece ``[z_r | x_r | BC_r | dt_r]`` (its conv on ``[x_r | BC_r]``, then B
and C gathered over "model", the SSD scan on its heads, the gated norm with
its statistic summed over "model", a row-parallel ``out_proj``); RWKV6's
time mix on its heads (the token shift and the ddlerp whole, on the entered
input; ``w0`` and ``decay_w2`` cut to its channels), its channel mix on its
hidden and output columns (the row-parallel value's partial sums
reduce-scattered over columns, gated by its column-split receptance, then
gathered, or exchanged for a rank's rows under sequence parallelism).  The caller enters and leaves the layout around each mixer.

Numerical-safety invariant, as in the reference: the decays are
exponentials of differences of cumulative log-decays with the larger index
first, so no ``exp`` sees a positive argument.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rmsnorm_gated
from repro_torch.models.params import spec
from repro_torch.parallel import comm


def mamba2_specs(cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.num_heads(d)
    gn = s.n_groups * s.state_dim
    conv_dim = di + 2 * gn
    return {
        # in_proj -> [z (di), x (di), B (gn), C (gn), dt (nh)]; a rank's
        # piece is the same chunk of each part: [z_r | x_r | BC_r | dt_r]
        "in_proj": spec((d, 2 * di + 2 * gn + nh), ("embed", "inner"),
                        segments=(di, di, 2 * gn, nh)),
        "conv_w": spec((s.conv_width, conv_dim), (None, "inner"), scale=0.5,
                       segments=(di, 2 * gn)),
        "conv_b": spec((conv_dim,), ("inner",), init="zeros",
                       segments=(di, 2 * gn)),
        "dt_bias": spec((nh,), ("ssm_heads",), init="zeros"),
        "A_log": spec((nh,), ("ssm_heads",), init="constant", value=0.0),
        "D": spec((nh,), ("ssm_heads",), init="ones"),
        "norm_scale": spec((di,), ("inner",), init="ones"),
        "out_proj": spec((di, d), ("inner", "embed")),
    }


def _causal_conv(xbc, w, b, init_state=None):
    """Depth-wise causal conv1d.  xbc: (B, L, C); w: (W, C); b: (C,).

    init_state: (B, W-1, C) tail of the previous segment or None for zero
    history.  Written as the reference's sum of shifted products (no cuDNN
    convolution, so no TF32).  Returns (silu(y + b), new_state)."""
    bsz, l, c = xbc.shape
    width = w.shape[0]
    if init_state is None:
        init_state = xbc.new_zeros((bsz, width - 1, c))
    ext = torch.cat([init_state.to(xbc.dtype), xbc], dim=1)   # (B, W-1+L, C)
    y = sum(ext[:, i:i + l] * w[i][None, None, :] for i in range(width))
    new_state = ext[:, -(width - 1):] if width > 1 else init_state
    return F.silu(y + b[None, None, :]), new_state


def mamba2_cache_specs(cfg: ModelConfig, batch: int,
                       conv_dtype=torch.float32):
    """Spec of one layer's decode cache, zero-init (the counterpart of the
    reference's ``mamba2_init_cache``): the conv tail (B, W-1, conv_dim)
    and the fp32 SSM state in the model's layout (B, H, P, N)."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    conv_dim = di + 2 * s.n_groups * s.state_dim
    return {"conv": spec((batch, s.conv_width - 1, conv_dim),
                         ("batch", None, "inner"), conv_dtype, init="zeros",
                         segments=(di, conv_dim - di)),
            "ssm": spec((batch, s.num_heads(cfg.d_model), s.head_dim,
                         s.state_dim), ("batch", "ssm_heads", None, None),
                        torch.float32, init="zeros")}


def mamba2_block(p, x, cfg: ModelConfig, *, mode="prefill", cache=None,
                 tp=None):
    """Mamba2 mixer.  x: (B, L, d) -> (y, cache).

    train: the chunked scan from zeros with zero conv history, no cache.
    prefill: the chunked scan from the cache's SSM state (zeros when there
    is no cache) and zero conv history; writes the conv tail and the final
    state into the cache.  decode: the recurrent update of the cached
    state, one step per token, written back in place.

    ``tp``: this rank's heads of ``tp.size`` (the params and cache are its
    pieces: ``in_proj`` ``[z_r | x_r | BC_r | dt_r]``, the conv ``[x_r |
    BC_r]``; one B / C group, read by every head:
    ``sharding.recurrent_splits``); y is then this rank's partial sums of
    the row-parallel ``out_proj``, which the caller reduces.
    """
    s = cfg.ssm
    dt_ = x.dtype
    bsz, l, d = x.shape
    di = s.d_inner(d)
    nh = s.num_heads(d)
    g, n = s.n_groups, s.state_dim
    gn = g * n
    ranks = tp.size if tp is not None else 1
    di_l, nh_l, bc_l = di // ranks, nh // ranks, 2 * gn // ranks

    zxbcdt = x @ p["in_proj"].to(dt_)
    z = zxbcdt[..., :di_l]
    xbc = zxbcdt[..., di_l:2 * di_l + bc_l]
    dt_raw = zxbcdt[..., -nh_l:]

    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        xbc, conv_state = _causal_conv(xbc, p["conv_w"].to(dt_),
                                       p["conv_b"].to(dt_), cache["conv"])
    elif mode in ("train", "prefill"):
        if mode == "train" and cache is not None:
            raise ValueError("train mode takes no cache")
        xbc, conv_state = _causal_conv(xbc, p["conv_w"].to(dt_),
                                       p["conv_b"].to(dt_), None)
    else:
        raise ValueError(f"mode {mode!r} (train | prefill | decode)")

    xin = xbc[..., :di_l]
    bc = xbc[..., di_l:]
    if tp is not None:
        # every head reads B and C: each rank's use is a partial sum of
        # their gradient
        bc = comm.gather_shared_columns(bc, tp.mesh)
    b_mat = bc[..., :gn].reshape(bsz, l, g, n)
    c_mat = bc[..., gn:].reshape(bsz, l, g, n)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())      # (B,L,H)
    a_neg = -torch.exp(p["A_log"].float())                      # (H,) < 0
    xh = xin.reshape(bsz, l, nh_l, s.head_dim)

    if mode == "decode":
        # recurrent: h' = exp(dt*A) h + (dt * B) x ; y = C . h'
        hpg = nh_l // g
        bh = b_mat.float().repeat_interleave(hpg, dim=2)        # (B,L,H,N)
        ch = c_mat.float().repeat_interleave(hpg, dim=2)
        ssm = cache["ssm"]                                      # (B,H,P,N)
        da = torch.exp(dt * a_neg)                              # (B,L,H)
        y_steps = []
        for t in range(l):                                      # l is 1
            upd = dt[:, t, :, None, None] * xh[:, t].float()[..., None] \
                * bh[:, t, :, None, :]
            ssm = ssm * da[:, t, :, None, None] + upd
            y_steps.append(torch.einsum("bhpn,bhn->bhp", ssm, ch[:, t]))
        y = torch.stack(y_steps, dim=1).to(dt_)                 # (B,L,H,P)
        new_state = ssm
    else:
        xdt = xh * dt[..., None].to(dt_)
        init = cache["ssm"] if cache is not None else None
        y, new_state = ops.ssd_chunked_kernel(xdt, dt * a_neg, b_mat, c_mat,
                                              init)
    if cache is not None:
        cache["conv"].copy_(conv_state)
        cache["ssm"].copy_(new_state)

    y = y + xh * p["D"].to(dt_)[None, None, :, None]
    y = y.reshape(bsz, l, di_l)
    y = rmsnorm_gated(p["norm_scale"], y, z, eps=cfg.norm_eps, tp=tp,
                      width=di)
    return y @ p["out_proj"].to(dt_), cache


# ==========================================================================
# RWKV6 ("Finch"): data-dependent per-channel decay
# ==========================================================================


def rwkv6_specs(cfg: ModelConfig):
    r = cfg.rwkv
    d = cfg.d_model
    nh = d // r.head_dim
    return {
        # sublayer LayerNorms (RWKV uses LN, not RMSNorm)
        "ln_tm_scale": spec((d,), ("norm",), init="ones"),
        "ln_tm_bias": spec((d,), ("norm",), init="zeros"),
        "ln_cm_scale": spec((d,), ("norm",), init="ones"),
        "ln_cm_bias": spec((d,), ("norm",), init="zeros"),
        # token-shift ddlerp: base mus + shared low-rank mixer
        "mu_x": spec((d,), ("embed",), init="zeros"),
        "mu_rkvwg": spec((5, d), (None, "embed"), init="zeros"),
        "mix_w1": spec((d, 5 * r.mix_lora), ("embed", None), scale=0.02),
        "mix_w2": spec((5, r.mix_lora, d), (None, None, "embed"), scale=0.02),
        # projections
        "wr": spec((d, d), ("embed", "inner")),
        "wk": spec((d, d), ("embed", "inner")),
        "wv": spec((d, d), ("embed", "inner")),
        "wg": spec((d, d), ("embed", "inner")),
        "wo": spec((d, d), ("inner", "embed")),
        # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(xw W1) W2))
        "w0": spec((d,), ("embed",), init="constant", value=-0.7),
        "decay_w1": spec((d, r.decay_lora), ("embed", None), scale=0.02),
        "decay_w2": spec((r.decay_lora, d), (None, "embed"), scale=0.02),
        "bonus_u": spec((nh, r.head_dim), ("ssm_heads", None), scale=0.5),
        # per-head group norm
        "ln_x_scale": spec((d,), ("inner",), init="ones"),
        "ln_x_bias": spec((d,), ("inner",), init="zeros"),
        # channel mix
        "cm_mu_k": spec((d,), ("embed",), init="zeros"),
        "cm_mu_r": spec((d,), ("embed",), init="zeros"),
        "cm_wk": spec((d, cfg.d_ff), ("embed", "mlp")),
        "cm_wv": spec((cfg.d_ff, d), ("mlp", "embed")),
        "cm_wr": spec((d, d), ("embed", "inner")),
    }


def rwkv6_cache_specs(cfg: ModelConfig, batch: int,
                      shift_dtype=torch.float32):
    """Spec of one layer's decode cache, zero-init (the counterpart of the
    reference's ``rwkv6_init_cache``): the last token of each sublayer's
    input (``shift_tm``, ``shift_cm``) and the fp32 WKV state (B, H, D,
    D).  The shifts are kept in the compute dtype: the reference's prefill
    returns them in that dtype and decode carries them so; the port writes
    them in place, so it allocates that dtype up front."""
    d = cfg.d_model
    hd = cfg.rwkv.head_dim
    shift = spec((batch, d), ("batch", "embed"), shift_dtype, init="zeros")
    return {"shift_tm": shift, "shift_cm": shift,
            "wkv": spec((batch, d // hd, hd, hd),
                        ("batch", "ssm_heads", None, None), torch.float32,
                        init="zeros")}


def _token_shift(x, last=None):
    """x_{t-1}, with the previous segment's final token (or 0) at t = 0."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    else:
        last = last[:, None] if last.dim() == 2 else last
    return torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)


class _WKVIntra(torch.autograd.Function):
    """The within-chunk scores of :func:`wkv6_chunked`,
    A_ij = sum_d r_id k_jd exp(lp_excl_id - lp_jd) for j < i (0 on and
    above the diagonal), from fp32 (B, nc, C, H, D) inputs -> (B, nc, C, C,
    H).  The reference builds the (B, nc, C, C, H, D) exponent whole (4.3 GB
    a layer at 8 x 2048 tokens, chunk 32, 32 heads of 64); here one query
    row i at a time meets the keys before it, in the forward and again in
    the backward, which saves only the inputs.  The same sums, and every
    exponent <= 0 as there."""

    @staticmethod
    def _row(rc, kc, lp_excl, lp, i):
        e = torch.exp(lp_excl[:, :, i:i + 1] - lp[:, :, :i])  # (B,nc,i,H,D)
        return e, kc[:, :, :i] * e

    @staticmethod
    def forward(ctx, rc, kc, lp_excl, lp):
        ctx.save_for_backward(rc, kc, lp_excl, lp)
        b, nc, c, h, _ = rc.shape
        out = rc.new_zeros((b, nc, c, c, h))
        for i in range(1, c):
            _, ke = _WKVIntra._row(rc, kc, lp_excl, lp, i)
            out[:, :, i, :i] = (rc[:, :, i:i + 1] * ke).sum(-1)
        return out

    @staticmethod
    def backward(ctx, da):
        rc, kc, lp_excl, lp = ctx.saved_tensors
        dr, dk = torch.zeros_like(rc), torch.zeros_like(kc)
        dlpe, dlp = torch.zeros_like(lp_excl), torch.zeros_like(lp)
        for i in range(1, rc.shape[2]):
            e, ke = _WKVIntra._row(rc, kc, lp_excl, lp, i)
            g = da[:, :, i, :i, :, None]                       # (B,nc,i,H,1)
            gr = g * rc[:, :, i:i + 1]
            dr[:, :, i] = (g * ke).sum(2)
            dk[:, :, :i] += gr * e
            dexpo = gr * ke                                    # d/d exponent
            dlpe[:, :, i] = dexpo.sum(2)
            dlp[:, :, :i] -= dexpo
        return dr, dk, dlpe, dlp


def wkv6_chunked(r, k, v, logw, u, *, chunk: int, init_state=None):
    """Chunked WKV6.

    r/k/v: (B, L, H, D); logw: (B, L, H, D) (log decay, <= 0); u: (H, D)
    bonus.  State S: (B, H, D, D) with S_{t+1} = diag(w_t) S_t + k_t v_t^T
    and o_t = r_t . S_t + (r_t . (u * k_t)) v_t.  When ``chunk`` does not
    divide L the chunk is gcd(L, chunk), as in the reference.  Sums in
    fp32.  Returns (o (B, L, H, D) in r's dtype, final state fp32)."""
    bsz, l, h, dh = r.shape
    if l % chunk != 0:
        chunk = math.gcd(l, chunk) or l
    nc = l // chunk

    def to_chunks(t):
        return t.float().reshape(bsz, nc, chunk, h, dh)

    rc, kc, vc, wc = map(to_chunks, (r, k, v, logw))
    lp = torch.cumsum(wc, dim=2)                           # inclusive
    lp_excl = lp - wc                                      # sum_{s<t}
    lp_end = lp[:, :, -1]                                  # (B,nc,H,D)

    # within a chunk: the strictly lower scores and the bonus diagonal
    a_intra = _WKVIntra.apply(rc, kc, lp_excl, lp)         # (B,nc,Ci,Cj,H)
    a_diag = torch.einsum("bzihd,bzihd,hd->bzih", rc, kc, u.float())
    eye = torch.eye(chunk, dtype=a_intra.dtype, device=r.device)
    a_full = a_intra + a_diag[:, :, :, None, :] * eye[None, None, :, :, None]
    y_intra = torch.einsum("bzijh,bzjhd->bzihd", a_full, vc)

    # each chunk's state contribution: sum_j diag(exp(lp_end - lp_j)) k v^T
    k_dec = kc * torch.exp(lp_end[:, :, None] - lp)        # <= 1
    s_chunk = torch.einsum("bzjhd,bzjhe->bzhde", k_dec, vc)

    # across chunks, in order
    s = torch.zeros((bsz, h, dh, dh), dtype=torch.float32, device=r.device) \
        if init_state is None else init_state.float()
    decay = torch.exp(lp_end)
    prev = []
    for z in range(nc):
        prev.append(s)
        s = s * decay[:, z][..., None] + s_chunk[:, z]
    prev_states = torch.stack(prev, dim=1)                 # (B,nc,H,D,D)

    # the state's output: r_i decayed from the chunk's start
    r_dec = rc * torch.exp(lp_excl)                        # <= 1
    y_inter = torch.einsum("bzihd,bzhde->bzihe", r_dec, prev_states)

    y = (y_intra + y_inter).reshape(bsz, l, h, dh)
    return y.to(r.dtype), s


def _rwkv_groupnorm(x, scale, bias, nh, eps=64e-5):
    """Per-head LayerNorm over head_dim (RWKV's ln_x), in fp32."""
    bsz, l, d = x.shape
    xh = x.reshape(bsz, l, nh, d // nh).float()
    mu = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, correction=0)
    y = (xh - mu) * torch.rsqrt(var + eps)
    return y.reshape(bsz, l, d) * scale.float() + bias.float()


def rwkv6_time_mix(p, x, cfg: ModelConfig, *, mode="prefill", cache=None,
                   chunk: int = 32, tp=None):
    """RWKV6 time mix.  x: (B, L, d) -> (y, cache).

    train: the chunked recurrence from a zero state and a zero shift.
    prefill: from the cache's state and shift (zeros without a cache);
    writes the last token and the final state into the cache.  decode: the
    recurrence token by token from the cached state, written back in
    place.

    ``tp``: this rank's heads of ``tp.size``, on the whole sequence ``x``
    (the token shift must see every row): ``wr`` / ``wk`` / ``wv`` /
    ``wg`` / ``bonus_u`` / ``ln_x_*`` and the WKV state are its pieces,
    ``w0`` and ``decay_w2`` whole, cut here to its channels; y is its
    partial sums of the row-parallel ``wo``, which the caller reduces."""
    r_cfg = cfg.rwkv
    dt_ = x.dtype
    bsz, l, d = x.shape
    hd = r_cfg.head_dim
    ranks = tp.size if tp is not None else 1
    dl = d // ranks                                    # this rank's channels
    lo = tp.rank * dl if tp is not None else 0
    nh = dl // hd
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r} (train | prefill | decode)")
    if mode == "decode" and cache is None:
        raise ValueError("decode needs a cache")

    last = cache["shift_tm"] if cache is not None else None
    sx = _token_shift(x, last) - x

    # ddlerp mixing coefficients
    xxx = x + sx * p["mu_x"].to(dt_)
    mix = torch.tanh(xxx @ p["mix_w1"].to(dt_))
    mix = mix.reshape(bsz, l, 5, r_cfg.mix_lora)
    mus = torch.einsum("blfm,fmd->blfd", mix, p["mix_w2"].to(dt_))
    mus = mus + p["mu_rkvwg"].to(dt_)[None, None]
    xr, xk, xv, xw, xg = (x + sx * mus[:, :, i] for i in range(5))

    r = (xr @ p["wr"].to(dt_)).reshape(bsz, l, nh, hd)
    k = (xk @ p["wk"].to(dt_)).reshape(bsz, l, nh, hd)
    v = (xv @ p["wv"].to(dt_)).reshape(bsz, l, nh, hd)
    g = F.silu(xg @ p["wg"].to(dt_))

    w_raw = p["w0"][lo:lo + dl].float() + \
        torch.tanh(xw @ p["decay_w1"].to(dt_)).float() @ \
        p["decay_w2"][:, lo:lo + dl].float()
    logw = -torch.exp(torch.clamp(w_raw, -20.0, 10.0))     # <= 0
    logw = logw.reshape(bsz, l, nh, hd)
    u = p["bonus_u"].float()

    if mode == "decode":
        s = cache["wkv"]                                    # (B,H,D,D)
        outs = []
        for t in range(l):
            rt, kt, vt = r[:, t].float(), k[:, t].float(), v[:, t].float()
            kv = torch.einsum("bhd,bhe->bhde", kt, vt)
            outs.append(torch.einsum("bhd,bhde->bhe", rt,
                                     s + u[..., None] * kv))
            s = s * torch.exp(logw[:, t])[..., None] + kv
        y = torch.stack(outs, dim=1)                        # (B,L,H,D) fp32
    else:
        init = cache["wkv"] if cache is not None else None
        y, s = wkv6_chunked(r, k, v, logw, u, chunk=chunk, init_state=init)
    if cache is not None:
        cache["shift_tm"].copy_(x[:, -1])
        cache["wkv"].copy_(s)

    y = _rwkv_groupnorm(y.reshape(bsz, l, dl).float(), p["ln_x_scale"],
                        p["ln_x_bias"], nh)
    y = (y * g.float()).to(dt_)
    return y @ p["wo"].to(dt_), cache


def rwkv6_channel_mix(p, x, cfg: ModelConfig, *, mode="prefill",
                      cache=None, tp=None):
    """RWKV6 channel mix (relu^2 key, sigmoid receptance); with a cache,
    from its shift, and the last token written back in place.

    ``tp``: on this rank's columns of ``tp.size``, from the whole sequence
    ``x``: ``cm_wk``'s hidden columns, the row-parallel ``cm_wv``'s partial
    sums reduce-scattered to this rank's output columns, gated by its
    columns of the receptance (``cm_wr``), then returned in the pass's
    layout: gathered whole on every rank (its gradient is whole on every
    rank too, so the gather's backward keeps this rank's columns), or
    under sequence parallelism exchanged for this rank's rows."""
    dt_ = x.dtype
    last = cache["shift_cm"] if cache is not None else None
    sx = _token_shift(x, last) - x
    xk = x + sx * p["cm_mu_k"].to(dt_)
    xr = x + sx * p["cm_mu_r"].to(dt_)
    k = torch.relu(xk @ p["cm_wk"].to(dt_)).square()
    v = k @ p["cm_wv"].to(dt_)
    if tp is not None:
        v = comm.scatter_columns(v, tp.mesh)
    out = torch.sigmoid(xr @ p["cm_wr"].to(dt_)) * v
    if tp is not None:
        out = comm.columns_to_rows(out, tp.mesh) if tp.sp else \
            comm.gather_columns(out, tp.mesh)
    if cache is not None:
        cache["shift_cm"].copy_(x[:, -1])
    return out, cache
