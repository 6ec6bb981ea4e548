#!/usr/bin/env python3
"""Where the device time goes when the port serves a batch on one GPU.

Run from the root of a checkout on a machine with a CUDA card::

    python3 profile_serve.py [--model granite-3-8b] [--out DIR]

It serves ``chip_smoke.py``'s own workload for the model (``serve_plan``:
its seed, prompt draw, request count, new tokens, cache length and served
depth; random bf16 weights) at full width: once untraced (warm-up; its engine metrics are
printed), then once more under ``torch.profiler`` with the engine's
``serve:prefill`` / ``serve:decode`` regions as trace annotations.  The
encoder-decoder (``--model seamless-m4t-large-v2``) is served as
``chip_smoke.serve_encdec`` serves it, through ``make_serve_fns`` with its
source frames (``chip_smoke.run_serve_fns``, under the same regions).  From the
Chrome trace (written gzipped to ``<out>/profile_<model>.json.gz``, by
default under the gitignored ``build/profiles``) it prints, per phase: wall
seconds, device-busy seconds (union of kernel intervals), the device's idle
share, and kernel time by class (the port's kernels by name, matrix
products, the rest) and by the ten costliest kernels.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

import chip_smoke  # also puts the checkout's src/ on sys.path
from chip_smoke import MAX_BATCH, ROOT
from repro_torch.serve.engine import ServingEngine

OUR_KERNELS = chip_smoke.KERNEL_NAMES     # the port's kernels, by name
MATMUL_MARKS = ("gemm", "nvjet", "xmma", "cutlass", "cublas")


class Annotations:
    """Engine markers hook: each region is a profiler annotation."""

    def region(self, name, counters=None):
        return _Annotated(name)

    def record(self, name, seconds, counters=None):
        pass


class _Annotated:
    def __init__(self, name):
        self.rf = record_function(name)

    def __enter__(self):
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        return self.rf.__exit__(*exc)

    def add(self, **counters):
        pass


class Metrics:
    """Engine usermetric hook: keeps the engine's metric points."""

    def __init__(self):
        self.points = []

    def metric(self, name, fields, tags=None):
        self.points.append((name, dict(fields)))


def kernel_class(name: str) -> str:
    for k in OUR_KERNELS:
        if k in name:
            return k
    low = name.lower()
    if any(m in low for m in MATMUL_MARKS):
        return "matmul (cuBLAS)"
    return "other (elementwise, copies, reductions)"


def union_length(intervals) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def breakdown(trace: dict, prefix: str = "serve:") -> dict:
    """Per annotated phase whose name starts with ``prefix`` (the last one
    of each name): wall, device-busy and idle share, kernel time by class
    and the ten costliest kernels."""
    events = trace["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    phases = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith(prefix)]
    out = {}
    for ph in phases:
        t0, t1 = ph["ts"], ph["ts"] + ph["dur"]
        inside = [(max(k["ts"], t0), min(k["ts"] + k["dur"], t1), k["name"])
                  for k in kernels if k["ts"] < t1 and k["ts"] + k["dur"] > t0]
        by_class, by_name = defaultdict(float), defaultdict(float)
        for a, b, n in inside:
            by_class[kernel_class(n)] += (b - a) / 1e6
            by_name[n[:80]] += (b - a) / 1e6
        busy = union_length([(a, b) for a, b, _ in inside]) / 1e6
        wall = ph["dur"] / 1e6
        out[ph["name"]] = {
            "wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall if wall else None,
            "kernels": len(inside),
            "by_class_s": dict(sorted(by_class.items(),
                                      key=lambda kv: -kv[1])),
            "top10_s": dict(sorted(by_name.items(),
                                   key=lambda kv: -kv[1])[:10])}
    return out


def engine_server(model: str):
    """serve(markers) -> (wall s, metric points) of the model's workload
    through the engine."""
    cfg, prompts, max_len, max_new = chip_smoke.serve_plan(model)
    params = chip_smoke.serving_params(cfg)

    def serve(markers):
        metrics = Metrics()
        eng = ServingEngine(cfg, params, max_batch=MAX_BATCH,
                            max_len=max_len, usermetric=metrics,
                            markers=markers)
        for p in prompts:
            eng.submit(p, max_new_tokens=max_new)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        eng.run_until_empty()
        torch.cuda.synchronize()
        return time.monotonic() - t0, metrics.points
    return serve


def encdec_server(model: str):
    """serve(markers) -> (wall s, prefill and decode seconds as the
    engine's points) of the encoder-decoder's workload through
    ``make_serve_fns``."""
    cfg = chip_smoke.get_config(model)
    params = chip_smoke.serving_params(cfg)
    toks, extras = chip_smoke.encdec_inputs(
        cfg, chip_smoke.smoke_prompts(cfg), cfg.encdec_source_len,
        torch.bfloat16, params["final_norm"]["scale"].device)

    def serve(markers):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = chip_smoke.run_serve_fns(cfg, params, toks, extras,
                                       chip_smoke.MAX_LEN, chip_smoke.MAX_NEW,
                                       markers=markers)
        torch.cuda.synchronize()
        return time.monotonic() - t0, [
            ("serve_prefill", {"prefill_time_s": res["prefill_s"]}),
            ("serve_decode", {"decode_time_s": res["decode_s"]})]
    return serve


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="granite-3-8b")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profiles"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serve: CUDA is not available", file=sys.stderr)
        return 1
    print(f"gpu: {chip_smoke.gpu_line()}; torch {torch.__version__}",
          flush=True)

    serve = encdec_server(args.model) \
        if args.model == chip_smoke.ENCDEC_MODEL else engine_server(args.model)
    wall, points = serve(None)
    untraced = {n: f for n, f in points if n in ("serve_prefill",
                                                 "serve_decode")}
    print("untraced: " + json.dumps({"model": args.model, "wall_s": wall,
                                     **untraced}), flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, points = serve(Annotations())
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"profile_{args.model}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
        g.write(f.read())
    os.remove(path)
    traced = {n: f for n, f in points if n in ("serve_prefill",
                                               "serve_decode")}
    print("traced: " + json.dumps({"model": args.model, "wall_s": wall,
                                   **traced}), flush=True)
    for phase, row in breakdown(trace).items():
        print(f"breakdown {phase}: {json.dumps(row)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
