"""Fused RMSNorm for Hopper: wrappers, plain versions and cost models.

Port of ``repro.kernels.rmsnorm`` (the Pallas ``_rmsnorm_kernel``):
``y = x * rsqrt(mean(x^2) + eps) * scale`` in fp32, stored in x's dtype.  The
CUDA kernels are in ``csrc/rmsnorm.cu``: the forward, and the backward the
port owes it because the model calls the kernel where the reference computes
the norm in jnp (:func:`rmsnorm_bwd`; ``ops.RMSNormFunction`` pairs the two
for autograd).  On a CPU tensor each wrapper computes the plain version
(:mod:`repro_torch.kernels.ref`); on a CUDA tensor it launches the kernel or
raises; on a meta tensor it returns the outputs' shapes and computes
nothing.

The kernels hold each row in registers between its reduction and its write,
so a row is read once.  :func:`plan` picks how a row is spread over a slot
of threads (a warp for narrow rows, one or two 16-byte vectors a thread for
decode rows, two vectors a thread for wide rows); :func:`walks` and
:func:`grid_blocks` size the grid: the blocks that fit on the card at once,
whose slots walk the rows (the backward, and forward rows of up to 4 KB),
or a slot a row.  The backward writes one fp32 row of dscale sums a block
into a scratch that a second kernel adds up in a fixed order.  x (and dy)
may be strided rows (:func:`rows`: MLA's latent is the first 512 columns of
576-wide rows); y and dx are contiguous.

The statistic from outside (:func:`rmsnorm_split`, :func:`rmsnorm_split_bwd`):
rows whose columns are split over ranks are normalised by the mean square of
the whole row (``width`` columns): a kernel writes each row's fp32 sum over
this rank's columns, the caller's ``reduce`` (an all-reduce over "model")
makes it the whole row's, and a second kernel applies it; the backward
alike, with the row dots of x and dy * scale.  Each wrapper call counts one
launch of its own (:data:`split_launches`, :data:`split_bwd_launches`).

The CUDA path is kept short on the host, since a decode step calls it once
per norm on a few rows: the C entry points are resolved once, a plan and
its grid cap are cached by shape class, and the stream is read raw
(``compat.current_raw_stream``, no ``torch.cuda.Stream`` object).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.compat import current_raw_stream
from repro_torch.kernels import ref
from repro_torch.kernels.build import check, load_library

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BAD_LAYOUT = -1                          # the C entry points' layout refusal
VPTS = (1, 2, 4, 8)                      # the kernels' vectors a thread
MAX_THREADS = 512                        # a block's threads (csrc)
NARROW_VECTORS = 128                     # a warp a row up to this many
DECODE_ROWS = 64                         # forward: rows spread thin
FWD_THREADS = 512                        # a wide forward block's threads
BWD_THREADS = 256                        # a backward (narrow forward) block's
WALK_VECTORS = 256                       # forward: wider rows get a slot each

launches = 0                              # forward kernel launches since reset
bwd_launches = 0                          # backward launches since reset
split_launches = 0                        # statistic-from-outside forwards
split_bwd_launches = 0                    # and backwards, since reset

_entry = {}                               # C entry point by name
_plans = {}                               # (vpt, tpr, slots, grid cap) by key
_sm_count = {}                            # SMs by device index


def _fn(name: str):
    fn = _entry.get(name)
    if fn is None:
        fn = _entry[name] = getattr(load_library(), name)
    return fn


def _layout_error(x) -> ValueError:
    vec = 16 // x.element_size()
    return ValueError(f"kernel needs 16-byte aligned rows of d % {vec} == 0 "
                      f"with a contiguous last dim, the leading dims "
                      f"flattening to one row stride (>= d, a multiple of "
                      f"16 bytes); got shape {tuple(x.shape)}, strides "
                      f"{x.stride()}")


def rows(x):
    """(rows, row stride in elements) of ``x`` read as rows of its last
    dim, or None where the kernels cannot read it so: the last dim must be
    contiguous with d a multiple of a 16-byte vector, the leading dims must
    flatten to rows of one stride (size-1 dims take any stride), that stride
    at least d and a multiple of 16 bytes, and the data 16-byte aligned."""
    d = x.shape[-1]
    vec = 16 // x.element_size()
    if d % vec or x.data_ptr() % 16:
        return None
    if x.is_contiguous():
        return (x.numel() // d if d else 0), d
    if d > 1 and x.stride(-1) != 1:
        return None
    ld = expect = None
    for size, stride in zip(reversed(x.shape[:-1]), reversed(x.stride()[:-1])):
        if size == 1:
            continue
        if ld is None:
            ld = stride
        elif stride != expect:
            return None
        expect = stride * size
    ld = d if ld is None else ld
    if ld < d or ld % vec:
        return None
    return x.numel() // d, ld


def _check(x, scale) -> int:
    """Shared argument checks; returns the dtype code for a CUDA ``x``
    (``-1`` for a CPU ``x``, which takes the plain version, or a meta
    ``x``, which takes the shapes only)."""
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
    if not scale.is_contiguous():
        raise _layout_error(x)
    return code


def _raise(err: int, x, what: str) -> None:
    if err == BAD_LAYOUT:
        raise _layout_error(x)
    check(err, what)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def plan(n: int, d: int, itemsize: int, *, backward: bool = False) -> tuple:
    """(VPT, tpr, slots): the 16-byte vectors a thread holds, the threads of
    a row slot (a multiple of 32) and the slots of a block, for rows of
    ``d`` elements of ``itemsize`` bytes.  Decode rows (a forward of at most
    DECODE_ROWS rows) spread a row so each thread issues one or two loads,
    one slot a block; a narrow row (at most NARROW_VECTORS vectors) is one
    warp, BWD_THREADS threads' worth of them a block; a wide row takes, in
    the forward, the VPT (2 first) that leaves the fewest idle vector slots
    in blocks of FWD_THREADS threads, and in the backward the first of VPT
    2, 4, 8 whose slot covers the row, in blocks of BWD_THREADS threads.
    Raises ValueError for a row wider than 8 vectors a thread of a
    MAX_THREADS slot.  (Chosen on an H100 with ``profile_rmsnorm.py
    --sweep``: more blocks an SM beat fuller vector slots.)"""
    nv = d * itemsize // 16
    if not backward and n <= DECODE_ROWS:
        for vpt in (1,) if nv <= 32 else (2, 4, 8):
            tpr = _round_up(-(-nv // vpt), 32)
            if tpr <= MAX_THREADS:
                return vpt, tpr, 1
    if nv <= NARROW_VECTORS:
        vpt = next(v for v in VPTS if 32 * v >= nv)
        return vpt, 32, BWD_THREADS // 32
    best = None
    if backward:
        # two vectors a thread where a slot covers the row so (VPT 8, which
        # runs short of registers and spills, only where nothing else does)
        for vpt in (2, 4, 8):
            tpr = _round_up(-(-nv // vpt), 32)
            if tpr <= MAX_THREADS:
                best = (0, vpt, tpr)
                break
    else:
        for vpt in (2, 4, 1, 8):
            tpr = _round_up(-(-nv // vpt), 32)
            if tpr <= MAX_THREADS and (best is None or
                                       tpr * vpt - nv < best[0]):
                best = (tpr * vpt - nv, vpt, tpr)
    if best is None:
        raise ValueError(f"rows of {d} elements of {itemsize} bytes are "
                         f"wider than the kernels take "
                         f"({8 * MAX_THREADS} vectors of 16 bytes)")
    _, vpt, tpr = best
    return vpt, tpr, max(1, (BWD_THREADS if backward else FWD_THREADS) // tpr)


def walks(d: int, itemsize: int, backward: bool = False) -> bool:
    """Whether the grid is capped at the blocks that fit on the card, so
    its slots walk the rows (the backward always, to keep one scratch row a
    block; a forward of rows of at most WALK_VECTORS vectors, which then
    loads the next row while the current one reduces), rather than one
    slot a row (wider forward rows: the card's block scheduler balances
    those better)."""
    return backward or d * itemsize // 16 <= WALK_VECTORS


def grid_blocks(n: int, slots: int, cap: int) -> int:
    """Blocks of a launch, and so the backward's rows of dscale scratch:
    enough for every row to have its slot, no more than fit on the card at
    once (``cap``: the SMs times the plan's blocks an SM)."""
    return max(1, min(-(-n // slots), cap))


def _sms(x) -> int:
    """The SMs of ``x``'s card (cached)."""
    dev = x.get_device()
    sms = _sm_count.get(dev)
    if sms is None:
        sms = _sm_count[dev] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    return sms


def _plan_for(x, code: int, n: int, d: int, backward: bool) -> tuple:
    """The cached (VPT, tpr, slots, grid cap) of a launch."""
    dev = x.get_device()
    key = (dev, backward, code, d, not backward and n <= DECODE_ROWS)
    p = _plans.get(key)
    if p is None:
        vpt, tpr, slots = plan(n, d, x.element_size(), backward=backward)
        per_sm = ctypes.c_int(0)
        err = _fn("repro_rmsnorm_blocks_per_sm")(
            int(backward), code, vpt, tpr, slots, d, ctypes.byref(per_sm))
        if err:
            _raise(err, x, "rmsnorm occupancy")
        if per_sm.value < 1:
            raise RuntimeError(f"rmsnorm plan {(vpt, tpr, slots)} at d={d} "
                               f"fits no block on an SM")
        cap = _sms(x) * per_sm.value if walks(d, x.element_size(),
                                              backward) else 1 << 30
        p = _plans[key] = (vpt, tpr, slots, cap)
    return p


def rmsnorm(x, scale, *, eps: float = 1e-5):
    """x: (..., d) bf16/fp32, rows of one stride (:func:`rows`); scale: (d,)
    fp32.  Fused RMSNorm over d; y is contiguous."""
    global launches
    code = _check(x, scale)
    if code < 0:
        if x.is_meta:               # shapes only: y as the kernel makes it
            return x.new_empty(x.shape)
        return ref.rmsnorm_ref(x, scale, eps=eps)
    layout = rows(x)
    if layout is None:
        raise _layout_error(x)
    n, ld = layout
    y = x.new_empty(x.shape)
    if n == 0:
        return y
    d = x.shape[-1]
    vpt, tpr, slots, cap = _plan_for(x, code, n, d, False)
    err = _fn("repro_rmsnorm")(
        x.data_ptr(), ld, scale.data_ptr(), y.data_ptr(), code, n, d, eps,
        vpt, tpr, slots, grid_blocks(n, slots, cap),
        current_raw_stream(x.get_device()))
    if err:
        _raise(err, x, "rmsnorm")
    launches += 1
    return y


def rmsnorm_bwd(x, scale, dy, *, eps: float = 1e-5):
    """Gradient of :func:`rmsnorm` at ``x`` for the output gradient ``dy``
    (x's shape and dtype; either may be strided rows).  Returns (dx in x's
    dtype, contiguous; dscale (d,) fp32).  On the card dscale is the first
    row of the call's one fp32 allocation, whose other rows are the
    kernel's scratch (a few hundred rows of d), so it keeps that alive."""
    global bwd_launches
    code = _check(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if code < 0:
        if x.is_meta:               # shapes only: dscale in fp32
            return (x.new_empty(x.shape),
                    x.new_empty((x.shape[-1],), dtype=torch.float32))
        return ref.rmsnorm_bwd_ref(x, scale, dy, eps=eps)
    lx, lg = rows(x), rows(dy)
    if lx is None or lg is None:
        raise _layout_error(x if lx is None else dy)
    (n, ldx), ldg = lx, lg[1]
    d = x.shape[-1]
    dx = x.new_empty(x.shape)
    if n == 0:
        return dx, torch.zeros((d,), dtype=torch.float32, device=x.device)
    vpt, tpr, slots, cap = _plan_for(x, code, n, d, True)
    blocks = grid_blocks(n, slots, cap)
    buf = torch.empty(((blocks + 1) * d,), dtype=torch.float32,
                      device=x.device)
    dscale, partial = buf[:d], buf[d:]
    err = _fn("repro_rmsnorm_bwd")(
        x.data_ptr(), ldx, scale.data_ptr(), dy.data_ptr(), ldg,
        dx.data_ptr(), partial.data_ptr(), dscale.data_ptr(), code, n, d,
        eps, vpt, tpr, slots, blocks, current_raw_stream(x.get_device()))
    if err:
        _raise(err, x, "rmsnorm_bwd")
    bwd_launches += 1
    return dx, dscale


ROWSUM_WARPS = 8                          # rows a row-sum block (csrc)
APPLY_VECTORS = 128                       # vectors of a row an apply block
APPLY_BLOCKS_PER_SM = 8                   # the apply grid's blocks an SM


def _split_grid(x, n: int, d: int) -> tuple:
    """(row-sum blocks, apply row blocks) of a statistic-from-outside call:
    the row sums' warps walk the rows, capped at the blocks that fill the
    card; the apply grid's column tiles times its row blocks fill it
    APPLY_BLOCKS_PER_SM times over, no more row blocks than rows."""
    sms = _sms(x)
    tiles = -(-(d * x.element_size() // 16) // APPLY_VECTORS)
    rowsum = max(1, min(-(-n // ROWSUM_WARPS), sms * 8))
    apply = max(1, min(n, -(-sms * APPLY_BLOCKS_PER_SM // tiles)))
    return rowsum, apply


def _split_rows(x, dy=None) -> tuple:
    """(code, n, ldx, ldg) of a statistic-from-outside call on the card."""
    lx = rows(x)
    lg = rows(dy) if dy is not None else lx
    if lx is None or lg is None:
        raise _layout_error(x if lx is None else dy)
    return lx[0], lx[1], lg[1]


def rmsnorm_split(x, scale, *, width: int, reduce, eps: float = 1e-5):
    """RMSNorm of rows of which ``x`` (..., d) holds d of ``width``
    columns (the rest on other ranks), by the mean square of the whole
    row: the kernel's fp32 sum of squares over x's columns a row,
    ``reduce`` (a function summing an (n,) fp32 tensor over the ranks
    holding the row's other columns, in place or not; returns the sum)
    between the two kernels.  scale: (d,) fp32, this rank's columns.
    Returns (y contiguous in x's dtype, the reduced sums (n,) fp32), the
    sums for :func:`rmsnorm_split_bwd`."""
    global split_launches
    code = _check(x, scale)
    d = x.shape[-1]
    if code < 0:
        if x.is_meta:            # shapes only; the exchange is counted
            ss = reduce(x.new_empty((x.numel() // max(d, 1),),
                                    dtype=torch.float32))
            return x.new_empty(x.shape), ss
        return ref.rmsnorm_split_ref(x, scale, width=width, reduce=reduce,
                                     eps=eps)
    n, ld, _ = _split_rows(x)
    y = x.new_empty(x.shape)
    ss = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return y, reduce(ss)
    stream = current_raw_stream(x.get_device())
    blocks, row_blocks = _split_grid(x, n, d)
    err = _fn("repro_rmsnorm_rowsum")(
        x.data_ptr(), ld, None, 0, scale.data_ptr(), ss.data_ptr(), code, n,
        d, blocks, stream)
    if err:
        _raise(err, x, "rmsnorm_rowsum")
    ss = reduce(ss)
    err = _fn("repro_rmsnorm_apply")(
        x.data_ptr(), ld, scale.data_ptr(), ss.data_ptr(), y.data_ptr(),
        code, n, d, width, eps, row_blocks, stream)
    if err:
        _raise(err, x, "rmsnorm_apply")
    split_launches += 1
    return y, ss


def rmsnorm_split_bwd(x, scale, dy, ss, *, width: int, reduce,
                      eps: float = 1e-5):
    """Gradient of :func:`rmsnorm_split` at ``x`` for ``dy`` (x's shape
    and dtype), from its reduced sums of squares ``ss``: the kernel's fp32
    row dots of x with dy * scale over x's columns, ``reduce`` between,
    then dx and dscale (this rank's columns: no exchange).  Returns (dx in
    x's dtype, contiguous; dscale (d,) fp32)."""
    global split_bwd_launches
    code = _check(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    d = x.shape[-1]
    if code < 0:
        if x.is_meta:
            reduce(x.new_empty((x.numel() // max(d, 1),),
                               dtype=torch.float32))
            return (x.new_empty(x.shape),
                    x.new_empty((d,), dtype=torch.float32))
        return ref.rmsnorm_split_bwd_ref(x, scale, dy, ss, width=width,
                                         reduce=reduce, eps=eps)
    n, ldx, ldg = _split_rows(x, dy)
    dx = x.new_empty(x.shape)
    dot = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        reduce(dot)
        return dx, torch.zeros((d,), dtype=torch.float32, device=x.device)
    stream = current_raw_stream(x.get_device())
    blocks, row_blocks = _split_grid(x, n, d)
    err = _fn("repro_rmsnorm_rowsum")(
        x.data_ptr(), ldx, dy.data_ptr(), ldg, scale.data_ptr(),
        dot.data_ptr(), code, n, d, blocks, stream)
    if err:
        _raise(err, x, "rmsnorm_rowsum")
    dot = reduce(dot)
    buf = torch.empty(((row_blocks + 1) * d,), dtype=torch.float32,
                      device=x.device)
    dscale, partial = buf[:d], buf[d:]
    err = _fn("repro_rmsnorm_apply_bwd")(
        x.data_ptr(), ldx, scale.data_ptr(), dy.data_ptr(), ldg,
        ss.data_ptr(), dot.data_ptr(), dx.data_ptr(), partial.data_ptr(),
        dscale.data_ptr(), code, n, d, width, eps, row_blocks, stream)
    if err:
        _raise(err, x, "rmsnorm_apply_bwd")
    split_bwd_launches += 1
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


def split_cost_estimate(x_shape, itemsize: int) -> dict:
    """``{flops, bytes}`` of :func:`rmsnorm_split` as a function: the
    forward's (:func:`cost_estimate`) and the fp32 row sums written (the
    second read of x is the design's, not the function's)."""
    out = cost_estimate(x_shape, itemsize)
    rows_ = 1
    for dim in x_shape[:-1]:
        rows_ *= int(dim)
    out["bytes"] += 4.0 * rows_
    return out


def split_bwd_cost_estimate(x_shape, itemsize: int) -> dict:
    """``{flops, bytes}`` of :func:`rmsnorm_split_bwd` as a function: the
    backward's (:func:`bwd_cost_estimate`) and the fp32 row sums read."""
    out = bwd_cost_estimate(x_shape, itemsize)
    rows_ = 1
    for dim in x_shape[:-1]:
        rows_ *= int(dim)
    out["bytes"] += 4.0 * rows_
    return out
