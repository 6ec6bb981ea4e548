#!/usr/bin/env python3
"""How far planted faults in the RMSNorm backward move ``chip_smoke.py``'s
training checks, beside how far the sound kernel moves them.

Run from the root of a checkout on a machine with a CUDA card::

    python3 train_faults.py

Each fault wraps the backward wrapper for one run (the kernel still runs;
its result is then spoiled in PyTorch), so no source changes:

* ``dscale_zero``          -- dscale = 0;
* ``dscale_without_r``     -- dscale = sum over rows of dy x (no r);
* ``dx_without_mean_term`` -- dx = r (dy o scale), the x r^3 mean(x g)
                              term dropped;
* ``dx_times_0.97``        -- dx 3% short.

For the sound kernel and each fault it prints one ``parity`` line: the
relative gaps of ``chip_smoke.parity_run`` from the plain path (the step-0
gradients leaf by leaf, then loss, grad norm and param norm of each AdamW
step on lms-demo) and which of them exceed ``chip_smoke.TRAIN_TOL``.  Then
one ``kernel-rule`` line for the sound kernel and each fault, at granite's
training shape (16384, 4096) in bf16: the worst error of dx and dscale as
a share of ``chip_smoke.compare``'s limit, dscale under its fp32 tolerance
and under the 2e-2 bf16 tolerance it had before (a share above 1 fails the
check).
"""

from __future__ import annotations

import json
import sys
from contextlib import contextmanager

import torch

import chip_smoke as cs
from chip_smoke import TOL, TRAIN_TOL, log
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rms

FAULTS = ("dscale_zero", "dscale_without_r", "dx_without_mean_term",
          "dx_times_0.97")


def spoil(kind: str, x, scale, dy, dx, dscale, eps: float):
    """(dx, dscale) with the fault ``kind`` planted."""
    xf, dyf = x.float(), dy.float()
    d = x.shape[-1]
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if kind == "dscale_zero":
        dscale = torch.zeros_like(dscale)
    elif kind == "dscale_without_r":
        dscale = (dyf * xf).reshape(-1, d).sum(dim=0)
    elif kind == "dx_without_mean_term":
        dx = (r * dyf * scale).to(x.dtype)
    elif kind == "dx_times_0.97":
        dx = (dx.float() * 0.97).to(x.dtype)
    elif kind != "sound":
        raise ValueError(kind)
    return dx, dscale


@contextmanager
def planted(kind: str):
    real = rms.rmsnorm_bwd

    def bwd(x, scale, dy, *, eps=1e-5):
        return spoil(kind, x, scale, dy, *real(x, scale, dy, eps=eps), eps)
    rms.rmsnorm_bwd = bwd
    try:
        yield
    finally:
        rms.rmsnorm_bwd = real


def share_of_limit(got, want, tol, magnitude=None) -> float:
    """max |got - want| / (tol (1 + m)), m as in chip_smoke.compare."""
    g, w = got.float(), want.float()
    m = w.abs() if magnitude is None else magnitude
    return float(((g - w).abs() / (tol * (1.0 + m))).max())


def kernel_rule(kind: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    n = cs.TRAIN_SHAPE.global_batch * cs.TRAIN_SHAPE.seq_len
    d = cs.get_config(cs.TRAIN_MODEL).d_model
    dt = torch.bfloat16
    x = torch.randn((n, d), generator=gen, device="cuda", dtype=dt)
    dy = torch.randn((n, d), generator=gen, device="cuda", dtype=dt)
    scale = 1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
    eps = 1e-5
    dx, ds = spoil(kind, x, scale, dy, *rms.rmsnorm_bwd(x, scale, dy,
                                                        eps=eps), eps)
    want_dx, want_ds = ref.rmsnorm_bwd_ref(x, scale, dy, eps=eps)
    mag = cs.dscale_magnitude(x, dy, eps)
    return {"fault": kind, "shape": [n, d], "dtype": "bfloat16",
            "dx": share_of_limit(dx, want_dx, TOL["rmsnorm_backward"][dt]),
            "dscale": share_of_limit(ds, want_ds, TOL["rmsnorm_dscale"][dt],
                                     mag),
            "dscale_at_bf16_tol": share_of_limit(
                ds, want_ds, TOL["rmsnorm_backward"][dt], mag)}


def main() -> int:
    if not torch.cuda.is_available():
        print("train_faults: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    kbuild.build()
    kbuild.load_library()
    log(f"gpu: {cs.gpu_line()}")
    plain = cs.parity_run(cs.plain_kernels)
    for kind in ("sound",) + FAULTS:
        run = cs.parity_run((lambda k=kind: planted(k)) if kind != "sound"
                            else cs.nullcontext)
        gaps = cs.parity_gaps(run, plain)
        over = sorted({k for g in gaps for k, v in g.items()
                       if not v <= TRAIN_TOL[k]})
        log("parity " + json.dumps({"run": kind, "gaps": gaps,
                                    "over_limit": over,
                                    "limits": TRAIN_TOL}))
        del run
    for kind in ("sound",) + FAULTS:
        log("kernel-rule " + json.dumps(kernel_rule(kind)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
