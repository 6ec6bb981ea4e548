"""Mamba2 (SSD) sequence mixer (port of the Mamba2 half of
``repro.models.ssm``; RWKV6 is not ported yet).

Train and prefill run the chunked SSD scan through the kernel wrapper
:func:`repro_torch.kernels.ops.ssd_chunked_kernel` (the plain sequential
recurrence on the CPU), which under grad differentiates through the SSD
backward kernel; prefill starts from the cache's state and keeps the final
state, train starts from zeros and drops it, as the reference does.  Decode
is the plain recurrent update, as in the reference (it is not a kernel
there either).  Caches are written in place.

Numerical-safety invariant, as in the reference: the decays are
exponentials of differences of cumulative log-decays with the larger index
first, so no ``exp`` sees a positive argument.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rmsnorm_gated
from repro_torch.models.params import spec


def mamba2_specs(cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.num_heads(d)
    gn = s.n_groups * s.state_dim
    conv_dim = di + 2 * gn
    return {
        # in_proj -> [z (di), x (di), B (gn), C (gn), dt (nh)]
        "in_proj": spec((d, 2 * di + 2 * gn + nh), ("embed", "inner")),
        "conv_w": spec((s.conv_width, conv_dim), (None, "inner"), scale=0.5),
        "conv_b": spec((conv_dim,), ("inner",), init="zeros"),
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
                         ("batch", None, "inner"), conv_dtype, init="zeros"),
            "ssm": spec((batch, s.num_heads(cfg.d_model), s.head_dim,
                         s.state_dim), ("batch", "ssm_heads", None, None),
                        torch.float32, init="zeros")}


def mamba2_block(p, x, cfg: ModelConfig, *, mode="prefill", cache=None):
    """Mamba2 mixer.  x: (B, L, d) -> (y, cache).

    train: the chunked scan from zeros with zero conv history, no cache.
    prefill: the chunked scan from the cache's SSM state (zeros when there
    is no cache) and zero conv history; writes the conv tail and the final
    state into the cache.  decode: the recurrent update of the cached
    state, one step per token, written back in place.
    """
    s = cfg.ssm
    dt_ = x.dtype
    bsz, l, d = x.shape
    di = s.d_inner(d)
    nh = s.num_heads(d)
    g, n = s.n_groups, s.state_dim
    gn = g * n

    zxbcdt = x @ p["in_proj"].to(dt_)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * gn]
    dt_raw = zxbcdt[..., -nh:]

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

    xin = xbc[..., :di]
    b_mat = xbc[..., di:di + gn].reshape(bsz, l, g, n)
    c_mat = xbc[..., di + gn:].reshape(bsz, l, g, n)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())      # (B,L,H)
    a_neg = -torch.exp(p["A_log"].float())                      # (H,) < 0
    xh = xin.reshape(bsz, l, nh, s.head_dim)

    if mode == "decode":
        # recurrent: h' = exp(dt*A) h + (dt * B) x ; y = C . h'
        hpg = nh // g
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
    y = y.reshape(bsz, l, di)
    y = rmsnorm_gated(p["norm_scale"], y, z, eps=cfg.norm_eps)
    return y @ p["out_proj"].to(dt_), cache
