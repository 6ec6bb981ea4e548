"""Shims for PyTorch API drift (counterpart of ``repro.compat``).

``repro.compat`` shims two JAX APIs that moved between versions:
``shard_map`` (and its ``check_rep`` / ``check_vma`` and ``auto`` /
``axis_names`` kwargs) and Pallas-TPU's ``TPUCompilerParams`` /
``CompilerParams``.  Neither has a torch counterpart: the port has no
Pallas, and no ``shard_map``: its distributed code runs one process a rank
over ``torch.distributed`` (``repro_torch.parallel``).

The port's one version-sensitive call is the raw CUDA stream of a device,
which the RMSNorm wrappers read on every launch.  The private
``torch._C._cuda_getCurrentRawStream(index)`` answers without building a
``torch.cuda.Stream``; where a torch lacks it, :func:`current_raw_stream`
is ``torch.cuda.current_stream(index).cuda_stream``, the public spelling
the flash and SSD wrappers use.  Both give the same handle; this is an API
shim, not a device fallback.
"""

from __future__ import annotations

import torch


def _resolve_raw_stream():
    fn = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if fn is not None:
        return fn

    def current_raw_stream(device_index: int) -> int:
        return torch.cuda.current_stream(device_index).cuda_stream
    return current_raw_stream


# current_raw_stream(device_index) -> the device's current CUDA stream handle
current_raw_stream = _resolve_raw_stream()

__all__ = ["current_raw_stream"]
