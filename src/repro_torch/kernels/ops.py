"""Model-layout adapters over the kernels (port of ``repro.kernels.ops``).

Models keep activations as (B, S, H, D); the flash and SSD kernels index
(B, H, S, D).  :func:`flash_attention_bshd` and :func:`ssd_chunked_kernel`
hand the kernels transposed views (they take strides), so no copy is made
on the card.

Marker instrumentation: :func:`set_kernel_markers` installs any object with
``.region(name, counters=)`` (e.g. ``repro.core``'s ``MarkerSession``, or
``launch.cost_analysis``'s step counter, which counts each call as one
operation of these flops and bytes), and every wrapper call becomes a
``kernel:<name>`` region seeded with the call's analytic flops/bytes; a
session with ``.hold(nbytes)`` is also told the call's scratch (the SSD
backward's states and partials).  ``torch.cuda.synchronize()`` runs inside the region
so its wall time is the kernel's.  Calls made while a CUDA graph is being
captured are not instrumented (a sync is illegal there); uninstrumented
calls pay one ``None`` check.

Gradients: :func:`fused_rmsnorm` under grad goes through
:class:`RMSNormFunction`, whose forward is the RMSNorm kernel and whose
backward is the RMSNorm backward kernel (a ``kernel:rmsnorm_backward``
region); :func:`ssd_chunked_kernel` under grad through
:class:`SSDFunction`, forward the SSD scan kernel, backward the SSD
backward kernel (``kernel:ssd_scan_backward``);
:func:`fused_rmsnorm_split` (a row split over "model": the statistic summed
over the ranks) under grad through :class:`RMSNormSplitFunction`, the
statistic-from-outside kernels forward and backward
(``kernel:rmsnorm_split``, ``kernel:rmsnorm_split_backward``).  The Pallas
kernels have no
backward: the reference differentiates its jnp forms where the port calls
these kernels.  The flash wrapper has none (train-mode flash is
forward-only in both packages).
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

import repro_torch.kernels.flash_attention as _fa
import repro_torch.kernels.rmsnorm as _rms
import repro_torch.kernels.ssd as _ssd

_markers = None


def set_kernel_markers(session):
    """Install (or clear, with ``None``) the marker session used by the
    kernel wrappers; returns the previous session."""
    global _markers
    prev = _markers
    _markers = session
    return prev


def launch_counts() -> dict:
    """Kernel launches per kernel since the last reset."""
    return {"flash_attention": _fa.launches, "rmsnorm": _rms.launches,
            "rmsnorm_backward": _rms.bwd_launches,
            "rmsnorm_split": _rms.split_launches,
            "rmsnorm_split_backward": _rms.split_bwd_launches,
            "ssd_scan": _ssd.launches, "ssd_scan_backward": _ssd.bwd_launches}


def reset_launch_counts() -> None:
    _fa.launches = 0
    _rms.launches = 0
    _rms.bwd_launches = 0
    _rms.split_launches = 0
    _rms.split_bwd_launches = 0
    _ssd.launches = 0
    _ssd.bwd_launches = 0


def _region(name: str, t: torch.Tensor, costs_fn, held_fn=None):
    """(session, its region) of one kernel call, or (None, a null context)
    when nothing is installed.  ``held_fn``: the call's scratch bytes, told
    to a session that counts memory (``.hold``) before the region opens."""
    m = _markers
    if m is None or (t.is_cuda and torch.cuda.is_current_stream_capturing()):
        return None, nullcontext()
    if held_fn is not None and hasattr(m, "hold"):
        m.hold(held_fn())
    return m, m.region(f"kernel:{name}", counters=costs_fn())


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0):
    """q, k: (B, S, H | KV, Dqk); v: (B, S, KV, Dv) with Dv <= Dqk ->
    (B, S, H, Dv).

    A V narrower than Q and K (MLA: Dqk 192, Dv 128) is zero-padded to Dqk
    for the kernel's one head dim, and the output's first Dv columns are
    returned: the padding's columns of P V are zeros, and the softmax scale
    stays 1/sqrt(Dqk).  The same adapter runs on the CPU, around the plain
    version."""
    dqk, dv = q.shape[-1], v.shape[-1]
    if dv > dqk:
        raise ValueError(f"v's head dim {dv} is wider than q's and k's "
                         f"{dqk}")
    if dv < dqk:
        v = torch.nn.functional.pad(v, (0, dqk - dv))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    m, region = _region(
        "flash_attention", q,
        lambda: _fa.cost_estimate(qt.shape, kt.shape[1], q.element_size(),
                                  causal=causal, window=window, dv=dv))
    with region:
        o = _fa.flash_attention(qt, kt, vt, causal=causal, window=window)
        if m is not None:
            _sync(o)
    return o.transpose(1, 2)[..., :dv]


def _rmsnorm(x, scale, eps: float):
    if _markers is None:
        return _rms.rmsnorm(x, scale, eps=eps)
    m, region = _region(
        "rmsnorm", x, lambda: _rms.cost_estimate(x.shape, x.element_size()))
    with region:
        y = _rms.rmsnorm(x, scale, eps=eps)
        if m is not None:
            _sync(y)
    return y


class RMSNormFunction(torch.autograd.Function):
    """RMSNorm with the kernel's gradient: forward = the RMSNorm kernel,
    backward = the RMSNorm backward kernel (their plain versions on the
    CPU).  Saves x and scale; r is recomputed in the backward."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        # the kernel reads dy's rows through their stride; only another
        # dtype, or a layout it cannot read (an expanded gradient), is copied
        if dy.dtype != x.dtype or (dy.is_cuda and _rms.rows(dy) is None):
            dy = dy.to(x.dtype).contiguous()
        m, region = _region(
            "rmsnorm_backward", x,
            lambda: _rms.bwd_cost_estimate(x.shape, x.element_size()))
        with region:
            dx, dscale = _rms.rmsnorm_bwd(x, scale, dy, eps=ctx.eps)
            if m is not None:
                _sync(dx)
        return dx, dscale, None


def fused_rmsnorm(x, scale, *, eps: float = 1e-5):
    """RMSNorm over the last dim.  Under grad (grad mode on and x or scale
    requiring it) through :class:`RMSNormFunction`; otherwise, as when
    serving under ``inference_mode``, one direct forward call."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNormFunction.apply(x, scale, eps)
    return _rmsnorm(x, scale, eps)


def _model_sum(mesh):
    """The ``reduce`` of the statistic-from-outside kernels: an all-reduce
    over "model", reported as ``"norm_stat"``."""
    from repro_torch.parallel import comm

    def reduce(t):
        with comm.purpose("norm_stat"):
            return comm.all_reduce(t, mesh, (comm.MODEL,))
    return reduce


def _rmsnorm_split(x, scale, eps: float, width: int, mesh):
    m, region = _region(
        "rmsnorm_split", x,
        lambda: _rms.split_cost_estimate(x.shape, x.element_size()))
    with region:
        y, ss = _rms.rmsnorm_split(x, scale, width=width,
                                   reduce=_model_sum(mesh), eps=eps)
        if m is not None:
            _sync(y)
    return y, ss


class RMSNormSplitFunction(torch.autograd.Function):
    """RMSNorm of rows whose ``width`` columns are split over "model" (this
    rank's are x's), with the statistic summed over the ranks: forward and
    backward the statistic-from-outside kernels (their plain versions on
    the CPU), each with its all-reduce of one fp32 a row between its two
    kernels.  One Function, so a checkpoint's recompute repeats the same
    collectives in the same order on every rank.  Saves x, scale and the
    forward's reduced sums."""

    @staticmethod
    def forward(ctx, x, scale, eps, width, mesh):
        y, ss = _rmsnorm_split(x, scale, eps, width, mesh)
        ctx.save_for_backward(x, scale, ss)
        ctx.eps, ctx.width, ctx.mesh = eps, width, mesh
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, ss = ctx.saved_tensors
        if dy.dtype != x.dtype or (dy.is_cuda and _rms.rows(dy) is None):
            dy = dy.to(x.dtype).contiguous()
        m, region = _region(
            "rmsnorm_split_backward", x,
            lambda: _rms.split_bwd_cost_estimate(x.shape, x.element_size()))
        with region:
            dx, dscale = _rms.rmsnorm_split_bwd(
                x, scale, dy, ss, width=ctx.width,
                reduce=_model_sum(ctx.mesh), eps=ctx.eps)
            if m is not None:
                _sync(dx)
        return dx, dscale, None, None, None


def fused_rmsnorm_split(x, scale, *, width: int, mesh, eps: float = 1e-5):
    """RMSNorm over rows of ``width`` columns of which ``x`` (..., d)
    holds this rank's d, the rest on the other ranks of ``mesh``'s
    "model" axis (``scale``: this rank's d), normalised by the whole row's
    mean square.  Under grad through :class:`RMSNormSplitFunction`;
    otherwise one direct call of the forward."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNormSplitFunction.apply(x, scale, eps, width, mesh)
    return _rmsnorm_split(x, scale, eps, width, mesh)[0]


def _ssd_scan(x, a, b, c, init_state):
    """The scan on model-layout tensors (see :func:`ssd_chunked_kernel`)."""
    xt = x.transpose(1, 2)
    bt, ct = b.transpose(1, 2), c.transpose(1, 2)
    m, region = _region(
        "ssd_scan", x,
        lambda: _ssd.cost_estimate(xt.shape, bt.shape[1], bt.shape[-1],
                                   x.element_size(),
                                   init_state=init_state is not None))
    with region:
        y, state = _ssd.ssd_scan(xt, a.transpose(1, 2), bt, ct, init_state)
        if m is not None:
            _sync(y)
    return y.transpose(1, 2), state


class SSDFunction(torch.autograd.Function):
    """The SSD scan with the kernels' gradient: forward = the SSD scan
    kernel, backward = the SSD backward kernel (their plain versions on the
    CPU; shapes only on meta tensors, whose flops ``FlopCounterMode`` takes
    from the cost model).  Model layout:
    x (B, L, H, P), a (B, L, H), b/c (B, L, G, N).  Saves the inputs; the
    chunk-start states are recomputed in the backward."""

    @staticmethod
    def forward(ctx, x, a, b, c, init_state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, a, b, c, init_state)
        return _ssd_scan(x, a, b, c, init_state)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, a, b, c, init_state = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype)
        xt = x.transpose(1, 2)
        bt = b.transpose(1, 2)
        m, region = _region(
            "ssd_scan_backward", x,
            lambda: _ssd.bwd_cost_estimate(
                xt.shape, bt.shape[1], bt.shape[-1], x.element_size(),
                init_state=init_state is not None),
            lambda: _ssd.held_bytes(xt.shape, x.dtype, bt.shape[1],
                                    bt.shape[-1]))
        with region:
            dx, da, db, dc, d_init = _ssd.ssd_scan_bwd(
                xt, a.transpose(1, 2), bt, c.transpose(1, 2),
                dy.contiguous().transpose(1, 2), init_state,
                None if dstate is None else dstate.contiguous())
            if m is not None:
                _sync(dx)
        return (dx.transpose(1, 2), da.transpose(1, 2), db.transpose(1, 2),
                dc.transpose(1, 2), d_init)


def ssd_chunked_kernel(x, dt_log_decay, b_mat, c_mat, init_state=None):
    """Kernel-backed counterpart of ``models.ssm.ssd_chunked``.

    x: (B, L, H, P), already multiplied by dt; dt_log_decay: (B, L, H) fp32;
    b/c: (B, L, G, N) with G dividing H (G == H is the pre-broadcast
    layout), head h reading group h // (H / G); init_state: (B, H, P, N)
    or None.  The kernel reads the groups through strides, so no head copy
    is made.  Returns (y (B, L, H, P), final state (B, H, P, N) fp32).
    Under grad (grad mode on and an input requiring it) through
    :class:`SSDFunction`; otherwise, as when serving under
    ``inference_mode``, one direct call of the scan.
    """
    args = (x, dt_log_decay, b_mat, c_mat, init_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args):
        return SSDFunction.apply(*args)
    return _ssd_scan(*args)
