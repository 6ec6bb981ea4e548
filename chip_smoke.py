#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card, ``nvcc`` and ``nvidia-smi``, and imports nothing of JAX or of the
JAX package.  Phases, each reported on its own lines:

1. build   -- compile the kernels from ``src/repro_torch/kernels/csrc``
              into ``build/repro_torch_kernels/`` and print the seconds;
              print the card's name and power limit.
2. kernels -- every kernel against its plain PyTorch version on the card,
              in bf16 and fp32, at the main path's shapes (granite-3-8b
              prefill and decode, lms-demo) plus a window, a ragged S and a
              non-causal case: max abs error against the tolerance, kernel
              ms, plain ms, one library call's ms and the bound in ms.
3. serve   -- granite-3-8b at full width and depth (40 layers, d=4096),
              random weights from a seed, bf16: ServingEngine(max_batch=8,
              max_len=2048) serves 8 requests of 256-1024 prompt tokens and
              32 new tokens each.  Launch counts are zeroed just before and
              read just after; they must be 40 flash launches per prefill
              batch and 81 rmsnorm launches per forward.  The logits must
              be finite and of the expected shape, and on a short input the
              kernel path (prefill, then decode through the cache) must
              agree with a plain full forward built from the plain kernel
              versions.
4. the kernels line (JSON), then the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises, so the script exits non-zero and prints no last line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    forward, init_cache, init_model_params)
from repro_torch.serve.engine import ServingEngine  # noqa: E402

# H100 SXM published peaks (dense): HBM bytes/s, and FLOP/s by input type
# (bf16 on the tensor cores; fp32 on the CUDA cores, which the fp32 kernels
# use).
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {"flash_attention": {torch.bfloat16: 2e-2, torch.float32: 2e-5},
       "rmsnorm": {torch.bfloat16: 2e-2, torch.float32: 1e-5}}
MODEL_TOL = 5e-2          # bf16 model logits (tests/test_kernels.py)
SOURCES = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:35"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:21"),
}
SEED = 0
N_REQUESTS, MAX_NEW = 8, 32
MAX_BATCH, MAX_LEN = 8, 2048


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def smoke_prompts(cfg) -> list:
    """The served workload: N_REQUESTS prompts of 256-1024 tokens drawn
    from SEED (``profile_serve.py`` traces the same batch)."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(256, 1025, size=N_REQUESTS)
    return [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
            for n in lens]


def serving_params(cfg) -> dict:
    """Random weights from SEED on the card, bf16 but for the fp32 norm
    scales."""
    return init_model_params(cfg, seed=SEED, compute_dtype=torch.bfloat16)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(costs: dict, dtype) -> tuple:
    """(least ms the card needs, "bytes" | "operations")."""
    t_bytes = costs["bytes"] / PEAK_BYTES * 1e3
    t_ops = costs["flops"] / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got, want, dtype) -> float:
    """Max abs error; raises when |got - want| > tol * (1 + |want|)."""
    tol = TOL[name][dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: non-finite output")
    worst = float((err - tol * (1.0 + w.abs())).max())
    if worst > 0:
        raise AssertionError(f"{name}: error {float(err.max()):.3e} beyond "
                             f"tolerance {tol:g}")
    return float(err.max())


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_flash(gen, b, h, kv, s, d, dtype, *, causal=True, window=0,
                tag=""):
    """Times the kernel as the served path calls it: (B, S, H, D)
    activations through ``ops.flash_attention_bshd``, which hands the kernel
    transposed views."""
    dev = torch.device("cuda")
    q = torch.randn((b, s, h, d), generator=gen, device=dev, dtype=dtype)
    k = torch.randn((b, s, kv, d), generator=gen, device=dev, dtype=dtype)
    v = torch.randn((b, s, kv, d), generator=gen, device=dev, dtype=dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    got = ops.flash_attention_bshd(q, k, v, causal=causal, window=window)
    want = ref.attention_ref(qt, kt, vt, causal=causal,
                             window=window).transpose(1, 2)
    err = compare("flash_attention", got, want, dtype)
    del want
    ms = time_ms(lambda: ops.flash_attention_bshd(q, k, v, causal=causal,
                                                  window=window))
    plain_ms = time_ms(lambda: ref.attention_ref(qt, kt, vt, causal=causal,
                                                 window=window), iters=3)
    if window:
        qp = torch.arange(s, device=dev)[:, None]
        kp = torch.arange(s, device=dev)[None, :]
        mask = kp > qp - window
        if causal:
            mask &= kp <= qp

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
    else:
        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal,
                                                  enable_gqa=True)
    library_ms = time_ms(lib)
    costs = fa.cost_estimate(qt.shape, kv, q.element_size(), causal=causal,
                             window=window)
    bound_ms, bound_by = bound(costs, dtype)
    row = {"name": "flash_attention", "shape": [b, h, kv, s, d],
           "dtype": str(dtype).replace("torch.", ""), "causal": causal,
           "window": window, "max_abs_err": err,
           "tol": TOL["flash_attention"][dtype], "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "tflops": costs["flops"] / ms / 1e9}
    log(f"kernel-check {tag}: {json.dumps(row)}")
    return row


def check_rmsnorm(gen, n, d, dtype, *, tag=""):
    dev = torch.device("cuda")
    x = torch.randn((n, d), generator=gen, device=dev, dtype=dtype)
    scale = 1.0 + 0.1 * torch.randn((d,), generator=gen, device=dev)
    eps = 1e-5
    got = rms.rmsnorm(x, scale, eps=eps)
    want = ref.rmsnorm_ref(x, scale, eps=eps)
    err = compare("rmsnorm", got, want, dtype)
    ms = time_ms(lambda: rms.rmsnorm(x, scale, eps=eps), iters=50)
    plain_ms = time_ms(lambda: ref.rmsnorm_ref(x, scale, eps=eps), iters=50)
    # the library fuses only when the weight has x's dtype, so its weight is
    # the scale rounded to x's dtype (an fp32 weight on bf16 x runs unfused)
    scale_x = scale.to(dtype)
    library_ms = time_ms(lambda: F.rms_norm(x, (d,), scale_x, eps), iters=50)
    costs = rms.cost_estimate(x.shape, x.element_size())
    # the arithmetic is fp32 on the CUDA cores whatever x's dtype
    bound_ms, bound_by = bound(costs, torch.float32)
    row = {"name": "rmsnorm", "shape": [n, d],
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "tol": TOL["rmsnorm"][dtype], "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by,
           "gbps": costs["bytes"] / ms / 1e6}
    log(f"kernel-check {tag}: {json.dumps(row)}")
    return row


def kernel_checks(plen: int) -> dict:
    """All kernel checks; returns the rows at the main path's prefill
    shapes (granite, S = the served batch's padded prompt length)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    main = {}
    for dt in (bf16, f32):
        check_flash(gen, 8, 32, 8, 1024, 128, dt, tag="granite-prefill")
        check_flash(gen, 8, 8, 4, 1024, 64, dt, tag="lms-demo-prefill")
        check_flash(gen, 8, 32, 8, 1024, 128, dt, window=256, tag="window")
        check_flash(gen, 8, 32, 8, 37, 128, dt, tag="ragged")
        check_flash(gen, 2, 8, 4, 200, 64, dt, causal=False,
                    tag="non-causal")
        check_rmsnorm(gen, 8 * 1024, 4096, dt, tag="granite-prefill")
        check_rmsnorm(gen, 8, 4096, dt, tag="granite-decode")
        check_rmsnorm(gen, 8 * 1024, 512, dt, tag="lms-demo-prefill")
    main["flash_attention"] = check_flash(gen, 8, 32, 8, plen, 128, bf16,
                                          tag="main-path-prefill")
    main["rmsnorm"] = check_rmsnorm(gen, 8 * plen, 4096, bf16,
                                    tag="main-path-prefill")
    return main


# ---------------------------------------------------------------------------
# Phase 3: serve granite-3-8b
# ---------------------------------------------------------------------------


class Recorder:
    """Minimal usermetric/markers hooks: keeps what the engine reports."""

    def __init__(self):
        self.metrics = []
        self.regions = {}

    def metric(self, name, fields, tags=None):
        self.metrics.append((name, dict(fields), tags))

    def region(self, name, counters=None):
        return _Region(self, name, counters)

    def record(self, name, seconds, counters=None):
        r = self.regions.setdefault(name, {"calls": 0, "seconds": 0.0})
        r["calls"] += 1
        r["seconds"] += seconds
        for k, v in (counters or {}).items():
            r[k] = r.get(k, 0.0) + v


class _Region:
    """A timed region: a context manager whose ``add`` sums counters."""

    def __init__(self, rec, name, counters):
        self.rec, self.name = rec, name
        self.counters = dict(counters or {})

    def add(self, **c):
        for k, v in c.items():
            self.counters[k] = self.counters.get(k, 0.0) + v

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.rec.record(self.name, time.monotonic() - self.t0,
                        counters=self.counters)
        return False


def plain_forward(params, cfg, tokens):
    """Prefill logits through the plain kernel versions (the reference the
    kernel path is held to on a short input)."""
    b, s = tokens.shape
    h, kvh, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    x = layers.embed_tokens(params["embed"], tokens, cfg)
    cos, sin = layers.rope_table(torch.arange(s, device=tokens.device)[None],
                                 hd, cfg.rope_theta)
    lay = params["dense_layers"]
    for i in range(cfg.num_layers):
        a = {k: w[i] for k, w in lay["attn"].items()}
        hh = ref.rmsnorm_ref(x, lay["ln1"]["scale"][i], eps=cfg.norm_eps)
        q = (hh @ a["wq"].reshape(d, h * hd)).view(b, s, h, hd)
        k = (hh @ a["wk"].reshape(d, kvh * hd)).view(b, s, kvh, hd)
        v = (hh @ a["wv"].reshape(d, kvh * hd)).view(b, s, kvh, hd)
        q, k = layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin)
        o = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2)).transpose(1, 2)
        x = x + o.reshape(b, s, h * hd) @ a["wo"].reshape(h * hd, d)
        hh = ref.rmsnorm_ref(x, lay["ln2"]["scale"][i], eps=cfg.norm_eps)
        x = x + layers.apply_mlp({k: w[i] for k, w in lay["mlp"].items()},
                                 hh, cfg)
    x = ref.rmsnorm_ref(x, params["final_norm"]["scale"], eps=cfg.norm_eps)
    return layers.lm_logits(params["embed"], x, cfg)


def serve_granite(prompts) -> dict:
    cfg = get_config("granite-3-8b")
    t0 = time.monotonic()
    params = serving_params(cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in flatten(params).values())
    log(f"serve: granite-3-8b init {time.monotonic() - t0:.2f} s, "
        f"{n_params} params, layers={cfg.num_layers} d={cfg.d_model}, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")

    rec = Recorder()
    eng = ServingEngine(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                        usermetric=rec, markers=rec)
    finite = []

    def checked(fn):
        def run(*args):
            logits, cache = fn(*args)
            if logits.shape != (len(prompts), cfg.vocab_padded):
                raise AssertionError(f"logits shape {tuple(logits.shape)}")
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        return run
    eng.prefill, eng.decode = checked(eng.prefill), checked(eng.decode)
    for p in prompts:
        eng.submit(p, max_new_tokens=MAX_NEW)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    done = eng.run_until_empty()
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if len(done) != len(prompts) or any(len(r.output) != MAX_NEW
                                        for r in done):
        raise AssertionError("not every request got its tokens")
    if not all(bool(f) for f in finite):
        raise AssertionError("non-finite logits")
    n_batches = math.ceil(len(prompts) / eng.max_batch)
    n_forwards = n_batches * MAX_NEW        # 1 prefill + 31 decode steps
    want = {"flash_attention": cfg.num_layers * n_batches,
            "rmsnorm": (2 * cfg.num_layers + 1) * n_forwards}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")

    pre = [f for n, f, _ in rec.metrics if n == "serve_prefill"]
    dec = [f for n, f, _ in rec.metrics if n == "serve_decode"]
    reqs = [f for n, f, _ in rec.metrics if n == "serve_request"]
    out = {"wall_s": wall_s,
           "prefill_s": sum(f["prefill_time_s"] for f in pre),
           "prompt_len": max(f["prompt_len"] for f in pre),
           "ttft_s_max": max(f["ttft_s"] for f in reqs),
           "ttft_s_mean": sum(f["ttft_s"] for f in reqs) / len(reqs),
           # the engine's rate counts each request's first token, which
           # prefill made; the step rate counts only what decode made
           "decode_tokens_per_s": dec[0]["tokens_per_s"],
           "decode_step_tokens_per_s": sum(
               f["new_tokens"] - f["batch"] for f in dec) / sum(
               f["decode_time_s"] for f in dec),
           "decode_s": sum(f["decode_time_s"] for f in dec),
           "peak_memory_gb": peak_gb, "launches": counts,
           "regions": sorted(rec.regions)}
    log(f"serve: {json.dumps(out)}")

    model_check(params, cfg, prompts[0][:64])
    out["counts"] = counts
    return out


def model_check(params, cfg, prompt, steps: int = 3) -> None:
    """A short input through the kernel path -- prefill, then decode steps
    through the cache -- against a plain full forward over the same
    sequence at each step, same weights.  Error relative to the largest
    logit, limit MODEL_TOL."""
    dev = params["final_norm"]["scale"].device
    seq = [int(t) for t in prompt]
    cache = init_cache(cfg, 1, len(seq) + steps, device=dev)
    with torch.inference_mode():
        toks = torch.tensor([seq], device=dev)
        got, cache = forward(params, cfg, tokens=toks, mode="prefill",
                             cache=cache)
        for step in range(steps + 1):
            want = plain_forward(params, cfg,
                                 torch.tensor([seq], device=dev))[:, -1]
            g, w = got[:, -1].float(), want.float()
            err = float((g - w).abs().max())
            rel = err / float(w.abs().max())
            log(f"serve: model check {cfg.name} "
                f"{'prefill' if step == 0 else 'decode'} at position "
                f"{len(seq) - 1}: max abs logit err {err:.4e}, relative "
                f"{rel:.4e} (limit {MODEL_TOL}), argmax "
                f"{'equal' if int(g.argmax()) == int(w.argmax()) else 'differs'}")
            if not bool(torch.isfinite(g).all()) or rel > MODEL_TOL:
                raise AssertionError("kernel-path logits disagree with the "
                                     "plain forward")
            if step == steps:
                break
            seq.append(int(w.argmax()))
            got, cache = forward(params, cfg,
                                 tokens=torch.tensor([[seq[-1]]],
                                                     device=dev),
                                 mode="decode", cache=cache,
                                 pos=len(seq) - 1)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # Phase 1: build
    t0 = time.monotonic()
    kbuild.build(ptxas_verbose=True)
    kbuild.load_library()
    log(f"build: {time.monotonic() - t0:.2f} s into "
        f"{os.path.relpath(kbuild.BUILD_ROOT, ROOT)}")
    log(f"gpu: {gpu_line()}")

    prompts = smoke_prompts(get_config("granite-3-8b"))
    plen = max(len(p) for p in prompts)

    # Phase 2: kernels against plain
    t0 = time.monotonic()
    main_rows = kernel_checks(plen)
    log(f"kernels: all checks within tolerance "
        f"({time.monotonic() - t0:.2f} s)")

    # Phase 3: serve
    served = serve_granite(prompts)

    # Phase 4: kernels line, then the result
    kernels = []
    for name, r in main_rows.items():
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": served["counts"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
