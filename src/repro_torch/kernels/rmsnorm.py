"""Fused RMSNorm for Hopper: wrapper, plain version and cost model.

Port of ``repro.kernels.rmsnorm`` (the Pallas ``_rmsnorm_kernel``):
``y = x * rsqrt(mean(x^2) + eps) * scale`` in fp32, stored in x's dtype.  The
CUDA kernel is ``csrc/rmsnorm.cu``.  On a CPU tensor :func:`rmsnorm` computes
the plain version (:func:`repro_torch.kernels.ref.rmsnorm_ref`); on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check, load_library

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0                              # kernel launches since reset


def rmsnorm(x, scale, *, eps: float = 1e-5):
    """x: (..., d) bf16/fp32; scale: (d,) fp32.  Fused RMSNorm over d."""
    global launches
    d = x.shape[-1]
    if scale.dim() != 1 or scale.shape[0] != d:
        raise ValueError(f"scale {tuple(scale.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32, got {scale.dtype}")
    if x.device != scale.device:
        raise ValueError("x and scale must be on one device")
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    vec = 16 // x.element_size()
    if not x.is_contiguous() or not scale.is_contiguous() or d % vec \
            or x.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError(f"kernel needs contiguous 16-byte aligned rows with "
                         f"d % {vec} == 0; got shape {tuple(x.shape)}, "
                         f"strides {x.stride()}")
    y = torch.empty_like(x)
    n = x.numel() // d
    if n == 0:
        return y
    err = load_library().repro_rmsnorm(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), DTYPE_CODES[x.dtype],
        n, d, float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "rmsnorm")
    launches += 1
    return y


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
