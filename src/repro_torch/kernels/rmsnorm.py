"""Fused RMSNorm for Hopper: wrappers, plain versions and cost models.

Port of ``repro.kernels.rmsnorm`` (the Pallas ``_rmsnorm_kernel``):
``y = x * rsqrt(mean(x^2) + eps) * scale`` in fp32, stored in x's dtype.  The
CUDA kernels are in ``csrc/rmsnorm.cu``: the forward, and the backward the
port owes it because the model calls the kernel where the reference computes
the norm in jnp (:func:`rmsnorm_bwd`; ``ops.RMSNormFunction`` pairs the two
for autograd).  On a CPU tensor each wrapper computes the plain version
(:mod:`repro_torch.kernels.ref`); on a CUDA tensor it launches the kernel or
raises.

The CUDA path is kept short on the host, since a decode step calls it once
per norm on a few rows: the C entry points are resolved once, the stream is
read raw (``compat.current_raw_stream``, no ``torch.cuda.Stream`` object),
and the alignment and ``d`` checks run in C, which answers
``BAD_LAYOUT``.
"""

from __future__ import annotations

import torch

from repro_torch.compat import current_raw_stream
from repro_torch.kernels import ref
from repro_torch.kernels.build import check, load_library

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BAD_LAYOUT = -1                          # the C entry points' layout refusal
BLOCKS_PER_SM = 4                        # backward: rows of dscale scratch

launches = 0                              # forward kernel launches since reset
bwd_launches = 0                          # backward launches since reset

_entry = {}                               # C entry point by name
_sm_count = {}                            # SMs by device index


def _fn(name: str):
    fn = _entry.get(name)
    if fn is None:
        fn = _entry[name] = getattr(load_library(), name)
    return fn


def _layout_error(x) -> ValueError:
    vec = 16 // x.element_size()
    return ValueError(f"kernel needs contiguous 16-byte aligned rows with "
                      f"d % {vec} == 0; got shape {tuple(x.shape)}, "
                      f"strides {x.stride()}")


def _check(x, scale) -> int:
    """Shared argument checks; returns the dtype code for a CUDA ``x``
    (``-1`` for a CPU ``x``, which takes the plain version, or a meta
    ``x``, whose plain version only carries shapes through a flop count)."""
    d = x.shape[-1]
    if scale.dim() != 1 or scale.shape[0] != d:
        raise ValueError(f"scale {tuple(scale.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32, got {scale.dtype}")
    if not x.is_cuda:
        if x.device != scale.device:
            raise ValueError("x and scale must be on one device")
        if x.device.type not in ("cpu", "meta"):
            raise ValueError(f"unsupported device {x.device}")
        return -1
    if not scale.is_cuda or x.get_device() != scale.get_device():
        raise ValueError("x and scale must be on one device")
    code = DTYPE_CODES.get(x.dtype)
    if code is None:
        raise ValueError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise _layout_error(x)
    return code


def _raise(err: int, x, what: str) -> None:
    if err == BAD_LAYOUT:
        raise _layout_error(x)
    check(err, what)


def rmsnorm(x, scale, *, eps: float = 1e-5):
    """x: (..., d) bf16/fp32; scale: (d,) fp32.  Fused RMSNorm over d."""
    global launches
    code = _check(x, scale)
    if code < 0:
        return ref.rmsnorm_ref(x, scale, eps=eps)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    d = x.shape[-1]
    dev = x.get_device()
    err = _fn("repro_rmsnorm")(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), code, x.numel() // d,
        d, eps, current_raw_stream(dev))
    if err:
        _raise(err, x, "rmsnorm")
    launches += 1
    return y


def bwd_blocks(n: int, d: int, sms: int) -> int:
    """Blocks of the backward's row kernel (= rows of its dscale scratch):
    enough to fill the card, no more than there are row slots."""
    slots = 8 if d <= 1024 else 1        # row slots a block (csrc row_block)
    return max(1, min(-(-n // slots), BLOCKS_PER_SM * sms))


def rmsnorm_bwd(x, scale, dy, *, eps: float = 1e-5):
    """Gradient of :func:`rmsnorm` at ``x`` for the output gradient ``dy``
    (x's shape and dtype).  Returns (dx in x's dtype, dscale (d,) fp32)."""
    global bwd_launches
    code = _check(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if code < 0:
        return ref.rmsnorm_bwd_ref(x, scale, dy, eps=eps)
    if not dy.is_contiguous():
        raise _layout_error(dy)
    d = x.shape[-1]
    dx = torch.empty_like(x)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    n = x.numel() // d if d else 0
    if n == 0:
        return dx, dscale.zero_()
    dev = x.get_device()
    sms = _sm_count.get(dev)
    if sms is None:
        sms = _sm_count[dev] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = bwd_blocks(n, d, sms)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    err = _fn("repro_rmsnorm_bwd")(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), dscale.data_ptr(), code, n, d, eps, blocks,
        current_raw_stream(dev))
    if err:
        _raise(err, x, "rmsnorm_bwd")
    bwd_launches += 1
    return dx, dscale


def cost_estimate(x_shape, itemsize: int) -> dict:
    """Per-call ``{flops, bytes}``: ~4 fp32 ops per element (square,
    accumulate, rsqrt-scale, gain) against one read and one write of x plus
    the fp32 scale vector."""
    numel = 1
    for dim in x_shape:
        numel *= int(dim)
    d = int(x_shape[-1])
    return {"flops": 4.0 * numel,
            "bytes": float(2 * numel * itemsize + 4 * d)}


def bwd_cost_estimate(x_shape, itemsize: int) -> dict:
    """Backward ``{flops, bytes}`` of the function: ~10 fp32 ops per element
    (dy * scale, the two row sums, dx, the dscale sum) against one read of
    x and dy and one write of dx, plus the scale read and the dscale write.
    The kernel's fp32 scratch of per-block sums is its own cost, not the
    function's, and is not counted."""
    numel = 1
    for dim in x_shape:
        numel *= int(dim)
    d = int(x_shape[-1])
    return {"flops": 10.0 * numel,
            "bytes": float(3 * numel * itemsize + 8 * d)}
