#!/usr/bin/env python3
"""How far planted faults in the backward kernels move ``chip_smoke.py``'s
checks, beside how far the sound kernels move them.

Run from the root of a checkout on a machine with a CUDA card::

    python3 train_faults.py [--kernel rmsnorm_backward|ssd_scan_backward]

(both kernels without ``--kernel``).  Each fault wraps a backward wrapper
for one run (the kernel still runs; the fault then spoils its result, or
feeds it spoiled inputs), so no source changes.  ``FAULTS`` lists them:

RMSNorm backward (``kernels.rmsnorm.rmsnorm_bwd``):

* ``dscale_zero``          -- dscale = 0;
* ``dscale_without_r``     -- dscale = sum over rows of dy x (no r);
* ``dx_without_mean_term`` -- dx = r (dy o scale), the x r^3 mean(x g)
                              term dropped;
* ``dx_times_0.97``        -- dx 3% short.

SSD backward (``kernels.ssd.ssd_scan_bwd``):

* ``da_without_cross_chunk`` -- da of every 64-step chunk as if it were a
                                sequence of its own: right within a chunk,
                                so a check at L <= 64 cannot see it;
* ``db_one_head_of_group``   -- db of the first head of each group alone,
                                not summed over the group's heads;
* ``decay_off_by_one``       -- every gradient from decays one step late
                                (a_t taken as a_{t-1}), an off-by-one of
                                the decay mask;
* ``bf16_rounded``           -- the sound gradients rounded to bf16: a
                                control of lower precision, which the fp32
                                limit must reject.

Lines printed, per kernel: ``kernel-rule`` for the sound kernel and each
fault at the kernel's training shapes, the worst error of each output as a
share of ``chip_smoke.compare``'s limit (above 1 fails the check);
``parity`` for the sound kernel and each fault, the relative gaps of
``chip_smoke.parity_run`` from its plain path on the kernel's parity model
(lms-demo for the RMSNorm backward, the fp32 narrow hybrid for the SSD
backward) and which of them exceed ``chip_smoke.TRAIN_TOL``.  For the SSD
backward also: ``precision`` lines (the fp32 kernel's and plain version's
largest gaps from a float64 recurrence, and from each other, at decay 0.1
and 20), ``bf16-noise`` (the narrow hybrid's bf16 step-0 gradients through
the kernels and through the plain versions, each against the fp32 plain
path's and against each other) and ``bf16-parity`` lines (the bf16 kernel
path's step-0 gradients, sound and with each fault, against the fp32
plain path's, beside ``chip_smoke.HYBRID_BF16_TOL``).
"""

from __future__ import annotations

import argparse
import json
import sys
from contextlib import contextmanager

import torch
import torch.nn.functional as F

import chip_smoke as cs
from chip_smoke import TOL, TRAIN_TOL, log
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rms
from repro_torch.kernels import ssd


# -- the RMSNorm backward ----------------------------------------------------


def spoil_rmsnorm(kind: str, real, x, scale, dy, *, eps: float = 1e-5):
    """(dx, dscale) with the fault ``kind`` planted."""
    dx, dscale = real(x, scale, dy, eps=eps)
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


def share_of_limit(got, want, tol, magnitude=None) -> float:
    """max |got - want| / (tol (1 + m)), m as in chip_smoke.compare."""
    g, w = got.float(), want.float()
    m = w.abs() if magnitude is None else magnitude
    return float(((g - w).abs() / (tol * (1.0 + m))).max())


def rule_rmsnorm(kind: str) -> list:
    """Granite's training shape (16384, 4096) in bf16; dscale under its
    fp32 tolerance and under the 2e-2 bf16 tolerance it had before."""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    n = cs.TRAIN_SHAPE.global_batch * cs.TRAIN_SHAPE.seq_len
    d = cs.get_config(cs.TRAIN_MODEL).d_model
    dt = torch.bfloat16
    x = torch.randn((n, d), generator=gen, device="cuda", dtype=dt)
    dy = torch.randn((n, d), generator=gen, device="cuda", dtype=dt)
    scale = 1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
    eps = 1e-5
    dx, ds = spoil_rmsnorm(kind, rms.rmsnorm_bwd, x, scale, dy, eps=eps)
    want_dx, want_ds = ref.rmsnorm_bwd_ref(x, scale, dy, eps=eps)
    mag = cs.dscale_magnitude(x, dy, eps)
    return [{"shape": [n, d], "dtype": "bfloat16",
             "dx": share_of_limit(dx, want_dx, TOL["rmsnorm_backward"][dt]),
             "dscale": share_of_limit(ds, want_ds,
                                      TOL["rmsnorm_dscale"][dt], mag),
             "dscale_at_bf16_tol": share_of_limit(
                 ds, want_ds, TOL["rmsnorm_backward"][dt], mag)}]


# -- the SSD backward --------------------------------------------------------


def chunkwise_da(real, x, a, b, c, dy):
    """da with each chunk of ``ssd.CHUNK`` steps run as its own sequence."""
    bsz, h, l, p = x.shape
    ch = ssd.CHUNK
    nc = -(-l // ch)
    pad = nc * ch - l

    def split(t):                  # (B, *, L[, D]) -> (B * nc, *, C[, D])
        t = F.pad(t, (0, 0, 0, pad) if t.dim() == 4 else (0, pad))
        t = t.reshape(t.shape[0], t.shape[1], nc, ch, *t.shape[3:])
        return t.transpose(1, 2).reshape(bsz * nc, t.shape[1], ch,
                                         *t.shape[4:]).contiguous()
    da = real(split(x), split(a), split(b), split(c), split(dy))[1]
    return da.reshape(bsz, nc, h, ch).transpose(1, 2).reshape(
        bsz, h, nc * ch)[:, :, :l]


def spoil_ssd(kind, real, x, a, b, c, dy, init_state=None, dstate=None):
    """The backward's five results with the fault ``kind`` planted."""
    out = list(real(x, a, b, c, dy, init_state, dstate))
    if kind == "da_without_cross_chunk":
        out[1] = chunkwise_da(real, x, a, b, c, dy)
    elif kind == "db_one_head_of_group":
        hpg = x.shape[1] // b.shape[1]
        out[2] = real(x[:, ::hpg], a[:, ::hpg], b, c, dy[:, ::hpg])[2]
    elif kind == "decay_off_by_one":
        late = F.pad(a[..., :-1], (1, 0))
        out = list(real(x, late, b, c, dy, init_state, dstate))
    elif kind == "bf16_rounded":
        out = [None if t is None else t.bfloat16().to(t.dtype) for t in out]
    elif kind != "sound":
        raise ValueError(kind)
    return tuple(out)


def rule_ssd(kind: str) -> list:
    """The ragged L = 1000, 4 groups of 4 heads, with an initial state, and
    zamba2's training shape, each in bf16 and fp32."""
    heads = cs.get_config("zamba2-7b").ssm.num_heads(
        cs.get_config("zamba2-7b").d_model)
    shapes = (((2, 1000, 16, 4), True),
              ((cs.TRAIN_SHAPE.global_batch, cs.TRAIN_SHAPE.seq_len, heads,
                1), False))
    lines = []
    for shape, init in shapes:
        for dt in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
            args = cs.ssd_bwd_inputs(gen, *shape, dt, init=init)
            got = spoil_ssd(kind, ssd.ssd_scan_bwd, *args)
            want = ref.ssd_bwd_ref(*args)
            tol = TOL["ssd_scan_backward"][dt]
            lines.append({"shape": list(shape), "init_state": init,
                          "dtype": str(dt).replace("torch.", ""),
                          **{k: v / tol for k, v in
                             cs.ssd_bwd_gaps(got, want).items()}})
            del got, want, args
            torch.cuda.empty_cache()
    return lines


def precision(decay: float, shape: tuple) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    args = cs.ssd_bwd_inputs(gen, *shape, torch.float32, decay=decay,
                             init=True)
    kernel = ssd.ssd_scan_bwd(*args)
    plain = ref.ssd_bwd_ref(*args)
    x, a, b, c, dy, s0, ds = args
    leaves = [t.double().detach().requires_grad_() for t in (x, a, b, c, s0)]
    y, s = ref.ssd_ref(*leaves)
    exact = torch.autograd.grad([y, s], leaves, [dy.double(), ds.double()])
    gaps = {name: cs.ssd_bwd_gaps(got, want) for name, got, want in (
        ("kernel", kernel, exact), ("plain", plain, exact),
        ("kernel_vs_plain", kernel, plain))}
    return {"decay": decay, "shape": list(shape),
            **{k: {name: g[k] for name, g in gaps.items()}
               for k in gaps["kernel"]}}


def worst_gap(got: dict, want: dict) -> float:
    """Largest relative L2 gap over the leaves (chip_smoke's ``grads``)."""
    return max(float((got[k].float() - w).norm() / w.norm())
               for k, w in want.items())


def ssd_extra(faults: tuple) -> None:
    """The SSD backward's precision, bf16-noise and bf16-parity lines."""
    for decay in (0.1, 20.0):
        for shape in ((2, 300, 8, 1), (2, 1000, 16, 4)):
            log("precision " + json.dumps(precision(decay, shape)))
    fp32 = cs.parity_run(cs.plain_kernels, steps=0,
                         cfg=cs.narrow_hybrid())["grads"]
    bf16 = cs.narrow_hybrid("bfloat16")
    plain = cs.parity_run(cs.plain_kernels, steps=0, cfg=bf16)["grads"]
    for kind in ("sound",) + faults:
        grads = cs.parity_run(swap_for("ssd_scan_backward", kind), steps=0,
                              cfg=bf16)["grads"]
        if kind == "sound":
            log("bf16-noise " + json.dumps({
                "model": bf16.name,
                "kernels_vs_fp32": worst_gap(grads, fp32),
                "plain_vs_fp32": worst_gap(plain, fp32),
                "kernels_vs_plain": worst_gap(grads, plain)}))
        gap = worst_gap(grads, fp32)
        log("bf16-parity " + json.dumps({
            "run": kind, "model": bf16.name, "grads_vs_fp32_plain": gap,
            "limit": cs.HYBRID_BF16_TOL,
            "over_limit": not gap <= cs.HYBRID_BF16_TOL}))
        del grads
        torch.cuda.empty_cache()


# -- the table and the shared runner -----------------------------------------


# per kernel: (module, wrapper name, spoil, faults, kernel rule, parity
# model or None for lms-demo, extra lines)
KERNELS = {
    "rmsnorm_backward": (rms, "rmsnorm_bwd", spoil_rmsnorm,
                         ("dscale_zero", "dscale_without_r",
                          "dx_without_mean_term", "dx_times_0.97"),
                         rule_rmsnorm, lambda: None, None),
    "ssd_scan_backward": (ssd, "ssd_scan_bwd", spoil_ssd,
                          ("da_without_cross_chunk", "db_one_head_of_group",
                           "decay_off_by_one", "bf16_rounded"),
                          rule_ssd, cs.narrow_hybrid, ssd_extra),
}
FAULTS = {k: v[3] for k, v in KERNELS.items()}


@contextmanager
def planted(kernel: str, kind: str):
    """Within the block ``kernel``'s wrapper returns what ``kind`` makes
    of the sound result."""
    mod, name, spoil = KERNELS[kernel][:3]
    real = getattr(mod, name)

    def wrapper(*args, **kwargs):
        return spoil(kind, real, *args, **kwargs)
    setattr(mod, name, wrapper)
    try:
        yield
    finally:
        setattr(mod, name, real)


def swap_for(kernel: str, kind: str):
    return cs.nullcontext if kind == "sound" else (
        lambda: planted(kernel, kind))


def run_kernel(kernel: str) -> None:
    _, _, _, faults, rule, parity_cfg, extra = KERNELS[kernel]
    for kind in ("sound",) + faults:
        for line in rule(kind):
            log("kernel-rule " + json.dumps({"kernel": kernel,
                                             "fault": kind, **line}))
    cfg = parity_cfg()
    plain = cs.parity_run(cs.plain_kernels, cfg=cfg)
    for kind in ("sound",) + faults:
        run = cs.parity_run(swap_for(kernel, kind), cfg=cfg)
        gaps = cs.parity_gaps(run, plain)
        over = sorted({k for g in gaps for k, v in g.items()
                       if not v <= TRAIN_TOL[k]})
        log("parity " + json.dumps({
            "kernel": kernel, "run": kind,
            "model": (cfg or cs.get_config("lms-demo")).name, "gaps": gaps,
            "over_limit": over, "limits": TRAIN_TOL}))
        del run
    del plain
    torch.cuda.empty_cache()
    if extra is not None:
        extra(faults)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=tuple(KERNELS), action="append",
                    help="the kernel whose faults to plant (repeatable; "
                         "default: every kernel)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_faults: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    kbuild.build()
    kbuild.load_library()
    log(f"gpu: {cs.gpu_line()}")
    for kernel in args.kernel or tuple(KERNELS):
        run_kernel(kernel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
