"""Flash attention for Hopper: wrapper, plain version and cost model.

Port of ``repro.kernels.flash_attention`` (the Pallas ``_attn_kernel``).
The CUDA kernels are in ``csrc/flash_attention.cu``: blocked online-softmax
GQA attention with fp32 ``m``/``l``/``acc``, causal and sliding-window
masks, skipping of fully masked KV tiles, and masking of a ragged sequence
edge (any ``S``, unlike the Pallas kernel's ``S % bq == 0``).  bf16 runs on
the tensor cores (TMA-fed ``wgmma``, warp-specialised, persistent); fp32 on
the CUDA cores.

On a CPU tensor :func:`flash_attention` computes the plain version
(:func:`repro_torch.kernels.ref.attention_ref`); on a CUDA tensor it launches
the kernel or raises; on a meta tensor it returns the output's shape and
computes nothing (``launch.cost_analysis`` counts the call by
:func:`cost_estimate`).  The kernel takes one head dim for q, k and v; a V
narrower than Q and K (MLA) is padded to it by
:func:`repro_torch.kernels.ops.flash_attention_bshd`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check, load_library

HEAD_DIMS = (64, 112, 128, 192)           # template instances in the .cu
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0                              # kernel launches since reset


def _validate(q, k, v, window: int, softcap: float) -> None:
    if softcap:
        raise ValueError("flash_attention takes no logit softcap (the model "
                         "never sends one to the kernel)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,H,S,D), k/v (B,KV,S,D); got "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if h % k.shape[1] != 0:
        raise ValueError(f"heads {h} not a multiple of kv heads "
                         f"{k.shape[1]}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share a dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _check_instance(q) -> None:
    """Raises unless the library has a kernel for q's dtype and head dim."""
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"kernel head dim must be one of {HEAD_DIMS}, "
                         f"got {q.shape[-1]}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: (B, H, S, D); k/v: (B, KV, S, D) -> (B, H, S, D) in q's dtype.

    Head ``h`` reads kv head ``h // (H / KV)``.  On CUDA the tensors may be
    strided views (e.g. the model's (B, S, H, D) transposed) as long as the
    head dim is contiguous and rows are 16-byte aligned; the output has
    q's strides."""
    global launches
    _validate(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        if q.device.type == "meta":
            # shapes only (a step traced for its counts): the kernel's
            # output, nothing computed or launched
            return torch.empty_like(q)
        raise ValueError(f"unsupported device {q.device}")
    _check_instance(q)
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    # 16-byte rows and bases: the fp32 kernel's vector loads, and the bf16
    # kernel's TMA tensor maps (base and strides multiples of 16 bytes)
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: head dim must be contiguous and rows "
                             f"16-byte aligned (strides {t.stride()})")
    lib = load_library()
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        DTYPE_CODES[q.dtype], d, b, h, k.shape[1], s,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(causal), int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attention")
    launches += 1
    return o


def attended_pairs(s: int, *, causal: bool, window: int) -> int:
    """Number of (query, key) pairs the masks leave, per (batch, head)."""
    total = 0
    for r in range(s):
        lo = max(0, r - window + 1) if window else 0
        hi = r + 1 if causal else s
        total += max(0, hi - lo)
    return total


def cost_estimate(q_shape, kv_heads: int, itemsize: int, *,
                  causal: bool = True, window: int = 0,
                  dv: Optional[int] = None) -> dict:
    """Per-call ``{flops, bytes}`` of the work this call needs, V's head dim
    ``dv`` (default q's D) included: a V the adapter pads to D counts at
    its own width, since the padding is the kernel's cost, not the
    function's.

    FLOPs: 2*D for QK^T and 2*Dv for PV per attended (query, key) pair,
    counted exactly from the masks (the kernel's tile skipping does a little
    more).  Bytes: one read of q and k at D and of v at Dv, one write of o
    at Dv."""
    b, h, s, d = q_shape
    dv = d if dv is None else dv
    pairs = attended_pairs(s, causal=causal, window=window)
    flops = 2.0 * b * h * (d + dv) * pairs
    elems = b * s * (h + kv_heads) * (d + dv)
    return {"flops": flops, "bytes": float(elems * itemsize)}
