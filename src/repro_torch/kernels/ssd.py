"""Mamba2 SSD chunk scan for Hopper: wrapper, plain version and cost model.

Port of ``repro.kernels.ssd`` (the Pallas ``_ssd_kernel``).  The CUDA
kernels are in ``csrc/ssd.cu``: a chunked scan with the fp32 state carried
across a sequential chunk loop, that returns the final state and takes any
``L`` (the Pallas kernel drops the state and needs ``L % chunk == 0``).
bf16 runs on the tensor cores (``wgmma``, TMA-fed chunks), fp32 on the CUDA
cores.

On a CPU tensor :func:`ssd_scan` computes the plain version
(:func:`repro_torch.kernels.ref.ssd_ref`); on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check, load_library

CHUNK = 64                                # the kernel's steps per chunk
HEAD_DIM = STATE_DIM = 64                 # P and N the kernel is built for
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0                              # kernel launches since reset


def _validate(x, a, b, c, init_state) -> None:
    if x.dim() != 4 or a.dim() != 3 or b.dim() != 4 or b.shape != c.shape:
        raise ValueError(f"expected x (B,H,L,P), a (B,H,L), b/c (B,G,L,N); "
                         f"got {tuple(x.shape)} {tuple(a.shape)} "
                         f"{tuple(b.shape)} {tuple(c.shape)}")
    bsz, h, l, p = x.shape
    if l == 0:
        raise ValueError("x has no steps (L = 0)")
    if tuple(a.shape) != (bsz, h, l):
        raise ValueError(f"a {tuple(a.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if b.shape[0] != bsz or b.shape[2] != l:
        raise ValueError(f"b/c {tuple(b.shape)} do not match x "
                         f"{tuple(x.shape)}")
    if h % b.shape[1] != 0:
        raise ValueError(f"heads {h} not a multiple of groups {b.shape[1]}")
    if not (x.dtype == b.dtype == c.dtype):
        raise ValueError("x, b and c must share a dtype")
    if a.dtype != torch.float32:
        raise ValueError(f"a must be float32, got {a.dtype}")
    if init_state is not None:
        if tuple(init_state.shape) != (bsz, h, p, b.shape[-1]):
            raise ValueError(f"init_state {tuple(init_state.shape)}, "
                             f"expected {(bsz, h, p, b.shape[-1])}")
        if init_state.dtype != torch.float32:
            raise ValueError(f"init_state must be float32, got "
                             f"{init_state.dtype}")
    tensors = (x, a, b, c) + (() if init_state is None else (init_state,))
    if any(t.device != x.device for t in tensors):
        raise ValueError("all inputs must be on one device")


def canonical_groups(b, c):
    """b/c (B, G, L, N) as the kernel's tensor maps can address them.

    A TMA map needs a nonzero stride for every dim it walks: b/c broadcast
    over the heads as expanded views (group stride 0, all groups the same)
    become one group, which every head reads; if only one of the two is
    broadcast, that one is made dense so both keep G groups."""
    g = b.shape[1]
    if g > 1 and b.stride(1) == 0 and c.stride(1) == 0:
        return b[:, :1], c[:, :1]
    return tuple(t.contiguous() if g > 1 and t.stride(1) == 0 else t
                 for t in (b, c))


def kernel_strides(t) -> list:
    """The (b, h|g, l) element strides handed to the kernel.  A dim of size
    one is only ever read at index 0, so its stride (which PyTorch leaves
    free: it may be 0 or odd) is given as the span of the other dims, a
    valid TMA stride whenever theirs are."""
    span = max(st * sz for st, sz in zip(t.stride(), t.shape) if sz > 1)
    return [st if sz > 1 else span for st, sz in zip(t.stride()[:3],
                                                     t.shape[:3])]


def ssd_scan(x, a, b, c, init_state=None):
    """Chunked SSD scan.

    x: (B, H, L, P) bf16/fp32, already multiplied by dt; a: (B, H, L) fp32
    log decays (<= 0); b/c: (B, G, L, N) in x's dtype, head h reading group
    h // (H / G); init_state: (B, H, P, N) fp32 or None (zeros).  On CUDA
    the inputs may be strided views (e.g. the model's (B, L, H, P)
    transposed, or b/c with a zero head stride) as long as the last dim is
    contiguous and rows are 16-byte aligned.

    Returns (y (B, H, L, P) in x's dtype with x's strides, final state
    (B, H, P, N) fp32).
    """
    global launches
    _validate(x, a, b, c, init_state)
    if x.device.type == "cpu":
        return ref.ssd_ref(x, a, b, c, init_state)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    bsz, h, l, p = x.shape
    n = b.shape[-1]
    if p != HEAD_DIM or n != STATE_DIM:
        raise ValueError(f"kernel is built for head dim {HEAD_DIM} and state "
                         f"dim {STATE_DIM}, got P={p}, N={n}")
    if bsz > 65535:
        raise ValueError(f"batch {bsz} exceeds the kernel's grid")
    b, c = canonical_groups(b, c)
    g = b.shape[1]
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    vec = 16 // x.element_size()
    for name, t in (("x", x), ("b", b), ("c", c), ("y", y)):
        if t.stride(-1) != 1 or any(st % vec for st in kernel_strides(t)) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: last dim must be contiguous and rows "
                             f"16-byte aligned (strides {t.stride()})")
    if init_state is not None and (not init_state.is_contiguous()
                                   or init_state.data_ptr() % 16):
        raise ValueError("init_state must be contiguous and 16-byte aligned")
    err = load_library().repro_ssd_scan(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), state.data_ptr(), DTYPE_CODES[x.dtype], bsz, h, g, l,
        *kernel_strides(x), *a.stride(), *kernel_strides(b),
        *kernel_strides(c), *kernel_strides(y),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "ssd_scan")
    launches += 1
    return y, state


def cost_estimate(x_shape, groups: int, state_n: int, itemsize: int, *,
                  init_state: bool = False) -> dict:
    """Per-call ``{flops, bytes}`` of the work the kernel does at its own
    chunk.

    FLOPs per step: the within-chunk pair (C B^T then P x, 2*C*(N+P)) and
    the state pair (C S and B^T x, 2*N*P each), counted over the L steps
    the call has (the masked tail of the last chunk is not work the
    function needs).  Bytes: one read of x, a, b/c (once per (batch,
    group): a broadcast over heads is read once) and of the initial state
    when given; one write of y and of the final state."""
    bsz, h, l, p = (int(v) for v in x_shape)
    n = int(state_n)
    c = min(CHUNK, l)
    flops = float(bsz * h * l) * (2.0 * c * (n + p) + 4.0 * n * p)
    elems = bsz * h * l * 2 * p + bsz * groups * l * 2 * n
    state_bytes = bsz * h * p * n * 4 * (2 if init_state else 1)
    return {"flops": flops,
            "bytes": float(elems * itemsize + bsz * h * l * 4 + state_bytes)}
