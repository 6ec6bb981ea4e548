#!/usr/bin/env python3
"""The RMSNorm kernels' times on one GPU, forward and backward, bf16.

Run from the root of a checkout on a machine with a CUDA card::

    python3 profile_rmsnorm.py            # every row, as the wrapper plans it
    python3 profile_rmsnorm.py --sweep    # other plans at the same rows

For every shape of ``chip_smoke.RMSNORM_FWD_SHAPES`` and
``RMSNORM_BWD_SHAPES`` it holds the kernel against its plain version and
prints ``chip_smoke``'s kernel-check row: back-to-back ``ms``, the kernels'
own device time (``device_ms``, from ``torch.profiler``'s kernel events),
the same two for one ``F.rms_norm`` (and its autograd backward), the bytes
bound and the share of it reckoned on the device time.

``--sweep`` launches the kernels through their C entry points with other
plans than ``rmsnorm.plan`` picks (VPT 1-8, blocks of 128-512 threads) and
grids (capped at the blocks that fit on the card, so slots walk the rows,
or a slot a row for the forward; the backward also at twice the cap),
checks each against the wrapper's result and prints one ``sweep`` line a
shape: each plan's device time and share of the bound, fastest first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import torch

import chip_smoke  # also puts the checkout's src/ on sys.path
from repro_torch.compat import current_raw_stream
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import rmsnorm as rms

BF16 = 1                                    # the entry points' dtype code


def blocks_per_sm(backward: bool, vpt: int, tpr: int, slots: int,
                  d: int) -> int:
    per_sm = ctypes.c_int(0)
    kbuild.check(rms._fn("repro_rmsnorm_blocks_per_sm")(
        int(backward), BF16, vpt, tpr, slots, d, ctypes.byref(per_sm)),
        "rmsnorm occupancy")
    return per_sm.value


def launcher(x, scale, dy, plan: tuple, blocks: int):
    """A call of the forward (``dy`` None) or the backward with ``plan``
    (VPT, tpr, slots) on a grid of ``blocks``."""
    n, d = x.shape
    vpt, tpr, slots = plan

    def fwd():
        y = torch.empty_like(x)
        kbuild.check(rms._fn("repro_rmsnorm")(
            x.data_ptr(), d, scale.data_ptr(), y.data_ptr(), BF16, n, d,
            1e-5, vpt, tpr, slots, blocks, current_raw_stream(0)), "fwd")
        return y

    def bwd():
        dx = torch.empty_like(x)
        buf = torch.empty(((blocks + 1) * d,), dtype=torch.float32,
                          device=x.device)
        kbuild.check(rms._fn("repro_rmsnorm_bwd")(
            x.data_ptr(), d, scale.data_ptr(), dy.data_ptr(), d,
            dx.data_ptr(), buf[d:].data_ptr(), buf.data_ptr(), BF16, n, d,
            1e-5, vpt, tpr, slots, blocks, current_raw_stream(0)), "bwd")
        return dx, buf[:d]
    return fwd if dy is None else bwd


def plans(nv: int) -> list:
    """(VPT, tpr, slots) of a row of ``nv`` vectors: each VPT with the
    fewest whole warps that cover the row, in blocks of 128, 256 or 512
    threads; a warp a row for narrow rows."""
    out = set()
    for vpt in rms.VPTS:
        tpr = -(-(-(-nv // vpt)) // 32) * 32
        if tpr > rms.MAX_THREADS or (nv <= rms.NARROW_VECTORS and tpr > 32):
            continue
        for threads in (128, 256, 512):
            slots = max(1, threads // tpr)
            if tpr * slots <= rms.MAX_THREADS:
                out.add((vpt, tpr, slots))
    return sorted(out)


def sweep(gen, kind: str, n: int, d: int) -> dict:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x = torch.randn((n, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    scale = 1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
    dy = None
    if kind == "backward":
        dy = torch.randn((n, d), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        want = rms.rmsnorm_bwd(x, scale, dy)
        costs = rms.bwd_cost_estimate(x.shape, 2)
    else:
        want = (rms.rmsnorm(x, scale),)
        costs = rms.cost_estimate(x.shape, 2)
    bound_ms = chip_smoke.bound(costs, torch.float32)[0]
    rows = []
    for plan in plans(d // 8):
        per_sm = blocks_per_sm(kind == "backward", *plan, d)
        if per_sm < 1:
            continue
        rows_per_block = -(-n // plan[2])
        grids = {"walk": min(rows_per_block, sms * per_sm)}
        if kind == "forward":
            grids["a slot a row"] = rows_per_block
        else:
            grids["walk, twice the cap"] = min(rows_per_block,
                                               2 * sms * per_sm)
        for grid, blocks in grids.items():
            fn = launcher(x, scale, dy, plan, blocks)
            got = fn()
            got = got if isinstance(got, tuple) else (got,)
            chip_smoke.compare("rmsnorm", got[0], want[0], torch.bfloat16,
                               what=f"sweep {plan}")
            if kind == "backward":
                chip_smoke.compare(
                    "rmsnorm_dscale", got[1], want[1], torch.bfloat16,
                    chip_smoke.dscale_magnitude(x, dy), what=f"sweep {plan}")
            # one profiler session a plan: many in one lose events
            ms = chip_smoke.device_ms({"k": fn}, iters=30)["k"][0]
            rows.append({"plan": list(plan), "grid": grid, "blocks": blocks,
                         "blocks_per_sm": per_sm, "device_ms": ms,
                         "frac_of_bound": bound_ms / ms})
    rows.sort(key=lambda r: r["device_ms"])
    return {"kind": kind, "shape": [n, d], "bound_ms": bound_ms,
            "chosen": list(rms.plan(n, d, 2, backward=kind == "backward")),
            "plans": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="time other plans at the same rows")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_rmsnorm: CUDA is not available", file=sys.stderr)
        return 1
    print(f"gpu: {chip_smoke.gpu_line()}; torch {torch.__version__}",
          flush=True)
    kbuild.load_library()
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    bf16 = torch.bfloat16
    for kind, shapes in (("forward", chip_smoke.RMSNORM_FWD_SHAPES),
                         ("backward", chip_smoke.RMSNORM_BWD_SHAPES)):
        for n, d in shapes:
            if args.sweep:
                if kind == "forward" and n <= rms.DECODE_ROWS:
                    continue
                print(f"sweep: {json.dumps(sweep(gen, kind, n, d))}",
                      flush=True)
            elif kind == "forward":
                chip_smoke.check_rmsnorm(gen, n, d, bf16, tag="profile")
            else:
                chip_smoke.check_rmsnorm_bwd(gen, n, d, bf16, tag="profile")
    return 0


if __name__ == "__main__":
    sys.exit(main())
