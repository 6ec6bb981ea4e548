"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

Straightforward dense math, no blocking, written independently of the
kernels.  The kernel wrappers call these for tensors on the CPU, and
``chip_smoke.py`` holds each kernel against them on the card.
"""

from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, S, D); k/v: (B, KV, S, D) -> (B, H, S, D).  fp32 softmax,
    probabilities kept in fp32 for the PV product."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    scores = (q.float() @ kf.transpose(-1, -2)) / math.sqrt(d)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    # at most two (B, H, S, S) fp32 tensors live at once
    scores.masked_fill_(~ok, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    del scores
    # rows with no valid key -> zeros
    probs = torch.nan_to_num(probs, nan=0.0)
    return (probs @ vf).to(q.dtype)


def rmsnorm_ref(x, scale, *, eps: float = 1e-5):
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_ref(x, scale, dy, *, eps: float = 1e-5):
    """Gradient of :func:`rmsnorm_ref` in fp32, from the closed form: with
    g = dy * scale and r = rsqrt(mean(x^2) + eps) per row,
    dx = r g - x r^3 mean(x g) and dscale = sum over rows of dy x r.
    Returns (dx in x's dtype, dscale (d,) fp32)."""
    d = x.shape[-1]
    xf, dyf = x.float(), dy.float()
    g = dyf * scale.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    dx = r * g - xf * r.pow(3) * (xf * g).mean(dim=-1, keepdim=True)
    dscale = (dyf * xf * r).reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dscale


def ssd_ref(x, a, b, c, init_state=None):
    """Sequential SSD recurrence (the definitional form).

    x: (B, H, L, P), already multiplied by dt; a: (B, H, L) log decays
    (<= 0); b/c: (B, G, L, N), head h reading group h // (H / G);
    init_state: (B, H, P, N) or None for zeros.  Per step
    S_t = exp(a_t) S_{t-1} + x_t b_t^T and y_t = S_t c_t, all in fp32.
    Returns (y (B, H, L, P) in x's dtype, final state (B, H, P, N) fp32).
    """
    bsz, h, l, p = x.shape
    g, n = b.shape[1], b.shape[-1]
    bf = b.float().repeat_interleave(h // g, dim=1)
    cf = c.float().repeat_interleave(h // g, dim=1)
    xf, af = x.float(), a.float()
    s = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device) \
        if init_state is None else init_state.float().clone()
    ys = []
    for t in range(l):
        s = s * torch.exp(af[:, :, t])[..., None, None] + \
            xf[:, :, t, :, None] * bf[:, :, t, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", s, cf[:, :, t]))
    return torch.stack(ys, dim=2).to(x.dtype), s
