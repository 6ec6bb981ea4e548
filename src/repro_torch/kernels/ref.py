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
    scores = scores.masked_fill(~ok, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    # rows with no valid key -> zeros
    probs = torch.nan_to_num(probs, nan=0.0)
    return (probs @ vf).to(q.dtype)


def rmsnorm_ref(x, scale, *, eps: float = 1e-5):
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)
