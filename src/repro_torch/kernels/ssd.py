"""Mamba2 SSD chunk scan for Hopper: wrappers, plain versions and cost
models, forward and backward.

Port of ``repro.kernels.ssd`` (the Pallas ``_ssd_kernel``).  The forward
kernels are in ``csrc/ssd.cu``: a chunked scan with the fp32 state carried
across a sequential chunk loop, that returns the final state and takes any
``L`` (the Pallas kernel drops the state and needs ``L % chunk == 0``).
bf16 runs on the tensor cores (``wgmma``, TMA-fed chunks), fp32 on the CUDA
cores.  So does the backward (:func:`ssd_scan_bwd`, ``csrc/ssd_bwd.cu``):
bf16 through a states kernel and a reverse ``wgmma`` kernel whose blocks
sum the db/dc of their two heads, fp32 on the CUDA cores.

On a CPU tensor the wrappers compute the plain versions
(:func:`repro_torch.kernels.ref.ssd_ref`, :func:`~repro_torch.kernels.ref.
ssd_bwd_ref`); otherwise they call the custom ops ``repro_torch::ssd_scan``
and ``repro_torch::ssd_scan_bwd``, which launch the kernel on a CUDA tensor
(or raise) and, on meta tensors, launch and compute nothing and return
empty outputs of the right shapes.  Each op has a flop formula (the cost
model's), so :class:`~torch.utils.flop_counter.FlopCounterMode` counts the
SSD as it counts aten's products (``train.step.count_step_flops``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ref
from repro_torch.kernels.build import check, load_library

CHUNK = 64                                # the kernel's steps per chunk
HEAD_DIM = STATE_DIM = 64                 # P and N the kernel is built for
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0                              # kernel launches since reset
bwd_launches = 0                          # backward launches since reset


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


def _tma_strides(name: str, t) -> list:
    """:func:`kernel_strides` of a tensor the bf16 kernels address by TMA
    (fp32 ones the same way): last dim contiguous, strides and base aligned
    to 16 bytes."""
    st = kernel_strides(t)
    if t.stride(-1) != 1 or any(s % (16 // t.element_size()) for s in st) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: last dim must be contiguous and rows "
                         f"16-byte aligned (strides {t.stride()})")
    return st


def _check_kernel_args(x, b) -> None:
    """What both kernels take: a CUDA tensor, fp32 or bf16, P = N = 64."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    p, n = x.shape[-1], b.shape[-1]
    if p != HEAD_DIM or n != STATE_DIM:
        raise ValueError(f"kernel is built for head dim {HEAD_DIM} and state "
                         f"dim {STATE_DIM}, got P={p}, N={n}")
    if x.shape[0] > 65535:
        raise ValueError(f"batch {x.shape[0]} exceeds the kernel's grid")


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
    _validate(x, a, b, c, init_state)
    if x.device.type == "cpu":
        return ref.ssd_ref(x, a, b, c, init_state)
    if x.device.type != "meta":
        _check_kernel_args(x, b)
    return torch.ops.repro_torch.ssd_scan(x, a, b, c, init_state)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(),
                         device_types="cuda")
def _scan_op(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, init_state: Optional[torch.Tensor]
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan kernel's launch, on inputs :func:`ssd_scan` checked."""
    global launches
    bsz, h, l, p = x.shape
    n = b.shape[-1]
    b, c = canonical_groups(b, c)
    g = b.shape[1]
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    strides = [_tma_strides(name, t) for name, t in
               (("x", x), ("b", b), ("c", c), ("y", y))]
    if init_state is not None and (not init_state.is_contiguous()
                                   or init_state.data_ptr() % 16):
        raise ValueError("init_state must be contiguous and 16-byte aligned")
    err = load_library().repro_ssd_scan(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), state.data_ptr(), DTYPE_CODES[x.dtype], bsz, h, g, l,
        *strides[0], *a.stride(), *strides[1], *strides[2], *strides[3],
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "ssd_scan")
    launches += 1
    return y, state


@_scan_op.register_fake
def _scan_shapes(x, a, b, c, init_state):
    bsz, h, _, p = x.shape
    return torch.empty_like(x), x.new_empty((bsz, h, p, b.shape[-1]),
                                            dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.ssd_scan, get_raw=True)
def _scan_flops(x, a, b, c, init_state, *, out_val=None, **kwargs) -> float:
    return cost_estimate(x.shape, b.shape[1], b.shape[-1], x.element_size(),
                         init_state=init_state is not None)["flops"]


def causal_pairs(l: int) -> int:
    """(i, j) pairs with j <= i inside the chunks of ``l`` steps: the
    within-chunk products are causal, so these are all they need."""
    full, tail = divmod(int(l), CHUNK)
    return full * CHUNK * (CHUNK + 1) // 2 + tail * (tail + 1) // 2


def cost_estimate(x_shape, groups: int, state_n: int, itemsize: int, *,
                  init_state: bool = False) -> dict:
    """Per-call ``{flops, bytes}`` of the work the kernel does at its own
    chunk.

    FLOPs: the within-chunk pair (C B^T then P x, 2*(N+P) a pair), over
    the causal pairs of each chunk (:func:`causal_pairs`: the upper
    triangle and the last chunk's masked tail are not work the function
    needs), and the state pair (C S and B^T x, 2*N*P each) a step.
    Bytes: one read of x, a, b/c (once per (batch, group): a broadcast
    over heads is read once) and of the initial state when given; one
    write of y and of the final state."""
    bsz, h, l, p = (int(v) for v in x_shape)
    n = int(state_n)
    flops = float(bsz * h) * (2.0 * (n + p) * causal_pairs(l)
                              + 4.0 * n * p * l)
    elems = bsz * h * l * 2 * p + bsz * groups * l * 2 * n
    state_bytes = bsz * h * p * n * 4 * (2 if init_state else 1)
    return {"flops": flops,
            "bytes": float(elems * itemsize + bsz * h * l * 4 + state_bytes)}


def _rows(t) -> list:
    """The (b, h|g, l) element strides of a backward-kernel operand: last
    dim contiguous, row strides a multiple of 4 (the kernel moves 4
    elements a load), 4-element aligned; a dim of size one is never
    stepped, so its stride is passed as 0."""
    st = [s if sz > 1 else 0 for s, sz in zip(t.stride()[:3], t.shape[:3])]
    if t.stride(-1) != 1 or any(s % 4 for s in st) or \
            t.data_ptr() % (4 * t.element_size()):
        raise ValueError(f"last dim must be contiguous, strides a multiple "
                         f"of 4 and rows aligned to 4 elements (shape "
                         f"{tuple(t.shape)}, strides {t.stride()})")
    return st


def ssd_scan_bwd(x, a, b, c, dy, init_state=None, dstate=None):
    """Gradient of :func:`ssd_scan` for the output gradient ``dy`` (x's
    shape and dtype) and, optionally, the final state's ``dstate`` (B, H,
    P, N) fp32.

    Inputs as :func:`ssd_scan`; b/c may have any strides along (b, g, l),
    zero included.  Returns (dx in x's dtype with x's strides, da (B, H, L)
    fp32, db and dc (B, G, L, N) in b's dtype, each summed over the heads
    of its group and laid out as a (B, L, G, N) tensor's transpose, d_init
    (B, H, P, N) fp32 or None without ``init_state``)."""
    _validate(x, a, b, c, init_state)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    bsz, h, l, p = x.shape
    n = b.shape[-1]
    if dstate is not None and (tuple(dstate.shape) != (bsz, h, p, n)
                               or dstate.dtype != torch.float32
                               or dstate.device != x.device):
        raise ValueError(f"dstate {tuple(dstate.shape)} {dstate.dtype}, "
                         f"expected {(bsz, h, p, n)} float32")
    if x.device.type == "cpu":
        return ref.ssd_bwd_ref(x, a, b, c, dy, init_state, dstate)
    if x.device.type != "meta":
        _check_kernel_args(x, b)
    grads = torch.ops.repro_torch.ssd_scan_bwd(x, a, b, c, dy, init_state,
                                               dstate)
    return (*grads[:4], grads[4] if init_state is not None else None)


def _bwd_outputs(x, b, init_state) -> list:
    """Empty dx, da, db, dc (and d_init with ``init_state``)."""
    bsz, h, l, p = x.shape
    g, n = b.shape[1], b.shape[-1]

    def grads_of_b():                 # (B, G, L, N), model memory order
        return x.new_empty((bsz, l, g, n), dtype=b.dtype).transpose(1, 2)
    out = [torch.empty_like(x), x.new_empty((bsz, h, l), dtype=torch.float32),
           grads_of_b(), grads_of_b()]
    if init_state is not None:
        out.append(x.new_empty((bsz, h, p, n), dtype=torch.float32))
    return out


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=(),
                         device_types="cuda")
def _bwd_op(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, dy: torch.Tensor,
            init_state: Optional[torch.Tensor],
            dstate: Optional[torch.Tensor]) -> list[torch.Tensor]:
    """The backward kernel's launch, on inputs :func:`ssd_scan_bwd`
    checked: [dx, da, db, dc] and d_init with ``init_state``."""
    global bwd_launches
    bsz, h, l, p = x.shape
    g, n = b.shape[1], b.shape[-1]
    out = _bwd_outputs(x, b, init_state)
    dx, da, db, dc = out[:4]
    d_init = out[4] if init_state is not None else None
    for name, t in (("init_state", init_state), ("dstate", dstate)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if x.dtype == torch.bfloat16:
        # TMA-read inputs; b/c broadcast over the groups are read as one
        b, c = canonical_groups(b, c)
        strides = [_tma_strides(name, t) for name, t in
                   (("x", x), ("b", b), ("c", c), ("dy", dy))]
    else:
        strides = [_rows(t) for t in (x, b, c, dy)]
    strides += [_rows(t) for t in (dx, db, dc)]
    parts = bwd_partials(x.dtype, h, g)
    ws = torch.empty(bwd_scratch(x.shape, parts)["states"] // 4,
                     dtype=torch.float32, device=x.device)
    part = torch.empty((2, bsz, parts, l, n), dtype=torch.float32,
                       device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()
    err = load_library().repro_ssd_scan_bwd(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        dy.data_ptr(), ptr(init_state), ptr(dstate), dx.data_ptr(),
        da.data_ptr(), db.data_ptr(), dc.data_ptr(), ptr(d_init),
        ws.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
        DTYPE_CODES[x.dtype], bsz, h, g, l, b.shape[1],
        *strides[0], *a.stride(), *strides[1], *strides[2], *strides[3],
        *strides[4], *strides[5], *strides[6],
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "ssd_scan_bwd")
    bwd_launches += 1
    return out


@_bwd_op.register_fake
def _bwd_shapes(x, a, b, c, dy, init_state, dstate):
    return _bwd_outputs(x, b, init_state)


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd, get_raw=True)
def _bwd_flops(x, a, b, c, dy, init_state, dstate, *, out_val=None,
               **kwargs) -> float:
    return bwd_cost_estimate(x.shape, b.shape[1], b.shape[-1],
                             x.element_size(),
                             init_state=init_state is not None)["flops"]


def bwd_partials(dtype, heads: int, groups: int) -> int:
    """The fp32 db/dc partials a batch row that the backward kernels write
    (one a head in fp32, one a block of a group's heads in bf16), as the
    kernel library counts them."""
    n = load_library().repro_ssd_bwd_partials(DTYPE_CODES[dtype], heads,
                                              groups)
    if n < 0:
        raise ValueError(f"ssd_scan_bwd: no partials for {dtype}, "
                         f"{heads} heads in {groups} groups")
    return n


NCB = 2                                   # heads a bf16 backward block


def bwd_partials_of(dtype, heads: int, groups: int) -> int:
    """:func:`bwd_partials` without the library (a meta tensor's count):
    the C entry point's formula, one partial a head in fp32, one a block of
    NCB heads of a group in bf16."""
    if dtype == torch.float32:
        return heads
    return groups * -(-(heads // groups) // NCB)


def held_bytes(x_shape, dtype, groups: int, state_n: int) -> int:
    """The device memory a backward call holds beside its inputs and
    outputs while it runs: the chunk-start states and the fp32 db/dc
    partials (:func:`bwd_scratch`); in bf16 at zamba2's training shape
    (8, 112, 2048, 64), 0.94 GB (its traffic, each written and read once,
    is twice that)."""
    bsz, h, l, _ = (int(v) for v in x_shape)
    parts = bwd_partials_of(dtype, h, groups)
    return bwd_scratch(x_shape, parts)["states"] + \
        2 * bsz * parts * l * int(state_n) * 4


def bwd_scratch(x_shape, parts: int) -> dict:
    """The backward kernels' scratch for x of ``x_shape`` and ``parts``
    db/dc partials a batch row (:func:`bwd_partials`): ``states``, the
    bytes of the chunk-start states (16 KB a chunk and head: fp32 P x N, or
    the bf16 kernel's hi/lo tiles), and ``bytes``, the traffic the states
    and the fp32 partials make, each written once and read once."""
    bsz, h, l, p = (int(v) for v in x_shape)
    states = bsz * h * -(-l // CHUNK) * p * STATE_DIM * 4
    partials = 2 * bsz * parts * l * STATE_DIM * 4
    return {"states": states, "bytes": 2 * (states + partials)}


def bwd_cost_estimate(x_shape, groups: int, state_n: int, itemsize: int, *,
                      init_state: bool = False) -> dict:
    """Backward ``{flops, bytes}`` of the function, counted as
    :func:`cost_estimate` counts the forward.

    FLOPs: the five within-chunk products (C B^T, dY X^T, and the ones
    giving dx, db and dc from them: 2*(3N + 2P) a pair), all causal, over
    the causal pairs of each chunk (:func:`causal_pairs`); and a step and
    head the four state products (dx and db from the end-state gradient,
    dc from the start state, the gradient's carry: 8*N*P) and the
    recompute of the chunk-start states (2*N*P).  Bytes: one read of x,
    dy, a, b/c (once per (batch, group)) and of the initial state when
    given; one write of dx, da, db/dc and of its gradient.  The kernel's
    fp32 scratch (the states, the per-head db/dc terms) is its own cost,
    not the function's."""
    bsz, h, l, p = (int(v) for v in x_shape)
    n = int(state_n)
    flops = float(bsz * h) * (2.0 * (3 * n + 2 * p) * causal_pairs(l)
                              + 10.0 * n * p * l)
    elems = bsz * h * l * 3 * p + bsz * groups * l * 4 * n
    state_bytes = bsz * h * p * n * 4 * 2 if init_state else 0
    return {"flops": flops,
            "bytes": float(elems * itemsize + bsz * h * l * 4 * 2
                           + state_bytes)}
