"""Model-layout adapters over the kernels (port of ``repro.kernels.ops``).

Models keep activations as (B, S, H, D); the flash kernel indexes
(B, H, S, D).  :func:`flash_attention_bshd` hands the kernel transposed views
(it takes strides), so no copy is made on the card.

Marker instrumentation: :func:`set_kernel_markers` installs any object with
``.region(name, counters=)`` (e.g. ``repro.core``'s ``MarkerSession``), and
every wrapper call becomes a ``kernel:<name>`` region seeded with the call's
analytic flops/bytes.  ``torch.cuda.synchronize()`` runs inside the region
so its wall time is the kernel's.  Calls made while a CUDA graph is being
captured are not instrumented (a sync is illegal there); uninstrumented
calls pay one ``None`` check.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

import repro_torch.kernels.flash_attention as _fa
import repro_torch.kernels.rmsnorm as _rms

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
    return {"flash_attention": _fa.launches, "rmsnorm": _rms.launches}


def reset_launch_counts() -> None:
    _fa.launches = 0
    _rms.launches = 0


def _region(name: str, t: torch.Tensor, costs_fn):
    m = _markers
    if m is None or (t.is_cuda and torch.cuda.is_current_stream_capturing()):
        return None, nullcontext()
    return m, m.region(f"kernel:{name}", counters=costs_fn())


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, D); k/v: (B, S, KV, D) -> (B, S, H, D)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    m, region = _region(
        "flash_attention", q,
        lambda: _fa.cost_estimate(qt.shape, kt.shape[1], q.element_size(),
                                  causal=causal, window=window))
    with region:
        o = _fa.flash_attention(qt, kt, vt, causal=causal, window=window)
        if m is not None:
            _sync(o)
    return o.transpose(1, 2)


def fused_rmsnorm(x, scale, *, eps: float = 1e-5):
    m, region = _region(
        "rmsnorm", x, lambda: _rms.cost_estimate(x.shape, x.element_size()))
    with region:
        y = _rms.rmsnorm(x, scale, eps=eps)
        if m is not None:
            _sync(y)
    return y
