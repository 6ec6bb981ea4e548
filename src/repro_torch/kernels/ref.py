"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

Straightforward dense math, no blocking, written independently of the
kernels.  The kernel wrappers call these for tensors on the CPU, and
``chip_smoke.py`` holds each kernel against them on the card.  The SSD
backward's plain version takes autograd's gradients through
:func:`ssd_chunked_ref`, the port's copy of the reference's chunked form.
:func:`wkv6_ref` stands for no kernel: it is the sequential oracle of
RWKV6's chunked WKV recurrence, which runs in plain PyTorch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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


def rmsnorm_split_ref(x, scale, *, width: int, reduce, eps: float = 1e-5):
    """:func:`rmsnorm_ref` of rows of which x holds d of ``width`` columns:
    the fp32 sums of squares over x's columns, ``reduce``d to the whole
    row's, then the norm by their mean over ``width``.  Returns (y in x's
    dtype, the reduced sums (n,) fp32)."""
    xf = x.float()
    ss = reduce(xf.square().sum(dim=-1).reshape(-1).contiguous())
    r = torch.rsqrt(ss.reshape(x.shape[:-1])[..., None] / width + eps)
    return (xf * r * scale.float()).to(x.dtype), ss


def rmsnorm_split_bwd_ref(x, scale, dy, ss, *, width: int, reduce,
                          eps: float = 1e-5):
    """Gradient of :func:`rmsnorm_split_ref` from its reduced sums ``ss``:
    with g = dy * scale, the row dots of x and g ``reduce``d to the whole
    row's, dx = r g - x r^3 dot / width and dscale = sum over rows of
    dy x r.  Returns (dx in x's dtype, dscale (d,) fp32)."""
    d = x.shape[-1]
    xf, dyf = x.float(), dy.float()
    g = dyf * scale.float()
    dot = reduce((xf * g).sum(dim=-1).reshape(-1).contiguous())
    shape = x.shape[:-1] + (1,)
    r = torch.rsqrt(ss.reshape(shape) / width + eps)
    dx = r * g - xf * r.pow(3) * dot.reshape(shape) / width
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


def ssd_chunked_ref(x, a, b, c, init_state=None, *, chunk: int = 64):
    """Chunked SSD scan in fp32 (the port's copy of the reference's
    ``models.ssm.ssd_chunked``, Mamba2 alg. 1), in the kernel's layout.

    Arguments and results as :func:`ssd_ref`.  Within a chunk the
    decay-masked ``C B^T`` product applied to x; between chunks a carried
    state.  A ragged L is padded with zero steps (x, a, b and c zero: they
    add nothing and decay nothing) where the reference shrinks its chunk to
    ``gcd(L, chunk)``; the result is the same function.  Differentiable:
    autograd through it keeps one (B, H, P, N) state a chunk, not a step.
    """
    bsz, h, l, p = x.shape
    g, n = b.shape[1], b.shape[-1]
    nc = -(-l // chunk)
    pad = nc * chunk - l

    def chunks(t, dims):          # (B, *, L[, D]) fp32 -> (B, H, nc, C[, D])
        t = F.pad(t.float(), (0, 0, 0, pad) if dims else (0, pad))
        if t.shape[1] != h:
            t = t.repeat_interleave(h // g, dim=1)
        return t.reshape(bsz, h, nc, chunk, *t.shape[3:])

    xc, bc, cc = chunks(x, 1), chunks(b, 1), chunks(c, 1)
    acs = chunks(a, 0).cumsum(dim=-1)                     # (B, H, nc, C)
    total = acs[..., -1]                                  # (B, H, nc)
    # exponents acs_i - acs_j below the diagonal, -inf above it, and the
    # constant 0 on it: the same function, but no gradient flows into acs
    # through the diagonal, whose terms would cancel between acs_i and acs_j
    below = torch.ones((chunk, chunk), dtype=torch.bool,
                       device=x.device).tril(-1)
    seg = (acs[..., :, None] - acs[..., None, :]).masked_fill(
        ~below, float("-inf")).masked_fill(
            torch.eye(chunk, dtype=torch.bool, device=x.device), 0.0)
    y = ((cc @ bc.transpose(-1, -2)) * torch.exp(seg)) @ xc   # within chunks
    decay_to_end = torch.exp(total[..., None] - acs)
    states = (xc * decay_to_end[..., None]).transpose(-1, -2) @ bc
    s = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device) \
        if init_state is None else init_state.float()
    starts = []
    for k in range(nc):                                   # chunk-start states
        starts.append(s)
        s = s * torch.exp(total[:, :, k])[..., None, None] + states[:, :, k]
    prev = torch.stack(starts, dim=2)                     # (B, H, nc, P, N)
    y = y + (cc @ prev.transpose(-1, -2)) * torch.exp(acs)[..., None]
    return y.reshape(bsz, h, nc * chunk, p)[:, :, :l].to(x.dtype), s


def ssd_bwd_ref(x, a, b, c, dy, init_state=None, dstate=None):
    """Gradient of the SSD scan (:func:`ssd_ref`'s function) for the output
    gradient ``dy`` (x's shape) and, optionally, the final state's gradient
    ``dstate`` (B, H, P, N), taken by autograd through
    :func:`ssd_chunked_ref` in fp32 from the inputs widened to fp32.

    Returns (dx in x's dtype, da (B, H, L) fp32, db and dc (B, G, L, N) in
    b's dtype, each summed over the heads of its group, d_init (B, H, P, N)
    fp32, or None without ``init_state``)."""
    leaves = [t.detach().float().requires_grad_() for t in (x, a, b, c)]
    init = None if init_state is None else \
        init_state.detach().float().requires_grad_()
    with torch.enable_grad():
        y, state = ssd_chunked_ref(*leaves, init)
        outs, grads = [y], [dy.float()]
        if dstate is not None:
            outs.append(state)
            grads.append(dstate.float())
        got = torch.autograd.grad(
            outs, leaves + ([] if init is None else [init]), grads)
    dx, da, db, dc = got[:4]
    return (dx.to(x.dtype), da, db.to(b.dtype), dc.to(c.dtype),
            got[4] if init is not None else None)


def wkv6_ref(r, k, v, logw, u, init_state=None):
    """Sequential RWKV6 WKV recurrence, the oracle of
    ``models.ssm.wkv6_chunked`` (a copy of the reference's ``wkv6_ref``,
    not a kernel: RWKV6 runs none).

    r/k/v: (B, L, H, D); logw: (B, L, H, D); u: (H, D); init_state:
    (B, H, D, D) or None for zeros.  Per step, in fp32,
    o_t = r_t . (S_t + diag(u) k_t v_t^T) and
    S_{t+1} = diag(w_t) S_t + k_t v_t^T.  Returns (o (B, L, H, D) fp32, the
    final state (B, H, D, D) fp32; the reference returns None there)."""
    bsz, l, h, dh = r.shape
    uf = u.float()[..., None]
    s = torch.zeros((bsz, h, dh, dh), dtype=torch.float32,
                    device=r.device) if init_state is None \
        else init_state.float().clone()
    outs = []
    for t in range(l):
        rt, kt, vt, wt = (x[:, t].float() for x in (r, k, v, logw))
        kv = torch.einsum("bhd,bhe->bhde", kt, vt)
        outs.append(torch.einsum("bhd,bhde->bhe", rt, s + uf * kv))
        s = s * torch.exp(wt)[..., None] + kv
    return torch.stack(outs, dim=1), s
