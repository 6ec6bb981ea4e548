"""The serving driver: the port's ``ServingEngine`` under open-loop or
backlog traffic, its points posted over HTTP to the receiver.

Set-up: the receiver starts, the weights are made on the card from the seed
(``weights``), the engine is built with a ``RemoteStack`` usermetric, and
one batch of ``max_batch`` prompts at the mix's longest prompt and most new
tokens warms it up.  The window then starts with the first batch; the
driver submits each request when it falls due (``requests.plan``, due
times after the window's start) and runs the engine's batches one after
the other; the window ends with the first batch that ends ``seconds`` after
it started.  Requests due by then that are still queued are served after
it, so every request due in the window is served to its end.

Each request's first token is timed on the driver's clock: the engine
emits its ``serve_prefill`` metric as soon as the batch's first tokens are
on the host, and the usermetric the driver hands the engine stamps that
call before passing it on.  TTFT is that time minus the time the request
was due.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from chipbench import common, costs, requests, weights
from chipbench import trace as tracing
from chipbench.train_driver import ReceiverProcess, model_config


class StampedMetrics:
    """The engine's usermetric: passes every call on to the stack's and
    stamps each batch's ``serve_prefill`` on the driver's clock."""

    def __init__(self, um):
        self.um = um
        self.markers = um.markers
        self.prefill_at = []

    def metric(self, name, fields, tags=None):
        if name == "serve_prefill":
            self.prefill_at.append(time.monotonic())
        return self.um.metric(name, fields, tags=tags)


def make_engine(cfg, params, mix, um, device):
    from repro_torch.serve.engine import ServingEngine
    return ServingEngine(cfg, params, max_batch=mix["max_batch"],
                         max_len=mix["max_len"], usermetric=um,
                         device=device)


def run(cell: dict, cfg_file: dict, mix: dict, *, seed: int,
        seconds: float, trace: bool, device="cuda", t_process=None) -> dict:
    from repro_torch.core import RemoteStack
    from repro_torch.kernels import ops

    t_process = time.monotonic() if t_process is None else t_process
    port = cfg_file["port"]
    cfg = model_config(port)
    dev = torch.device(device)
    peaks = costs.peaks_for(torch.cuda.get_device_name(dev)) \
        if dev.type == "cuda" else costs.PEAKS["H100"]
    phases = common.Phases(t_process)
    phases.mark("imports, CUDA")
    params = weights.make(port, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    phases.mark("weights")
    plan = requests.plan(mix, seed, seconds, port["vocab_size"])
    receiver = ReceiverProcess()
    stack = RemoteStack(receiver.url)
    phases.mark("receiver")
    batches, state = [], {}
    try:
        with stack.job(f"chipbench-serve-{seed}", hosts=["serve0"]):
            um = StampedMetrics(stack.usermetric(host="serve0"))
            eng = make_engine(cfg, weights.nested(params), mix, um, dev)
            phases.mark("engine")
            warm = np.random.default_rng(seed).integers(
                1, port["vocab_size"], size=mix["prompt_max"],
                dtype=np.int32)
            for _ in range(mix["max_batch"]):
                eng.submit(warm, max_new_tokens=mix["new_max"])
            eng.run_batch()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            phases.mark("warm-up")
            state = serve(eng, um, plan, seconds, mix, batches,
                          trace_batches=mix["trace_batches"] if trace else 0,
                          ops=ops, t_process=t_process)
        stack.close()
        summary = receiver.summary()
    finally:
        receiver.close()
    memory = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0
    trace_read = tracing.read(tracing.export_events(state["prof"])) \
        if state.get("prof") is not None else None
    del eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run_ = readings(port, mix, plan, batches, state, summary, trace_read,
                    peaks)
    run_["setup_phases"] = phases.seconds
    return {"run": run_, "memory_peak_bytes": memory, "params": params,
            "batches": batches, "plan": plan}


def serve(eng, um, plan, seconds, mix, batches, *, trace_batches, ops,
          t_process) -> dict:
    """Submit each request when due and run batches until the window has
    closed and every request due in it is served."""
    state = {"t_start": None, "t_end": None, "prof": None}
    t0 = time.monotonic()
    state["t_start"] = t0
    state["setup_s"] = t0 - t_process
    nxt = 0
    due = [p.due_s for p in plan]
    while True:
        now = time.monotonic() - t0
        limit = now if state["t_end"] is None else state["t_end"] - t0
        while nxt < len(plan) and due[nxt] <= limit:
            rid = eng.submit(plan[nxt].prompt, plan[nxt].new_tokens)
            plan[nxt].rid = rid
            nxt += 1
        if not eng._queue:
            if state["t_end"] is not None:
                break
            if nxt >= len(plan):
                state["t_end"] = time.monotonic()
                break
            time.sleep(max(0.0, due[nxt] - (time.monotonic() - t0)))
            continue
        k = len(batches)
        if k == 0 and trace_batches:
            state["prof"] = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            state["prof"].start()
            state["annot"] = torch.profiler.record_function(tracing.WINDOW)
            state["annot"].__enter__()
            ops.reset_launch_counts()
        started = time.monotonic()
        done = eng.run_batch()
        ended = time.monotonic()
        batches.append({"start": started, "end": ended,
                        "first_token": um.prefill_at[-1],
                        "requests": [(r.rid, len(r.prompt), list(r.output))
                                     for r in done],
                        "in_window": state["t_end"] is None,
                        "traced": k < trace_batches})
        if trace_batches and k + 1 == trace_batches:
            state["launches"] = dict(ops.launch_counts())
            state["annot"].__exit__(None, None, None)
            state["prof"].stop()
        if state["t_end"] is None and ended - t0 >= seconds:
            state["t_end"] = ended
    state.pop("annot", None)
    return state


def readings(port, mix, plan, batches, state, summary, trace_read,
             peaks) -> dict:
    """What the metric readers read of one serving run."""
    t0, t1 = state["t_start"], state["t_end"]
    by_rid = {}
    for b in batches:
        for rid, plen, out in b["requests"]:
            by_rid[rid] = (b, plen, out)
    due_in = [p for p in plan if p.rid >= 0 and t0 + p.due_s <= t1]
    ttft = []
    failed = 0
    for p in due_in:
        got = by_rid.get(p.rid)
        if got is None or len(got[2]) != p.new_tokens:
            failed += 1
            ttft.append(math.inf)
            continue
        ttft.append(got[0]["first_token"] - (t0 + p.due_s))
    posted = {str(pt["tags"].get("rid")) for pt in summary["points"]
              if pt["measurement"] == "serve_request"}
    failed += sum(1 for p in due_in if str(p.rid) not in posted
                  and p.rid in by_rid)
    # the engine's points, one of each a batch in order after the warm-up
    # batch's; the engine's per-layer readings leave out the traced batches,
    # which the profiler slows
    prefill = [pt["fields"] for pt in summary["points"]
               if pt["measurement"] == "serve_prefill"][1:]
    decode = [pt["fields"] for pt in summary["points"]
              if pt["measurement"] == "serve_decode"][1:]
    span = [(b, pf, dc) for b, pf, dc in zip(batches, prefill, decode)
            if b["in_window"] and not b["traced"]]
    positions = sum(len(b["requests"]) * max(r[1] for r in b["requests"])
                    for b, _, _ in span)
    real = sum(r[1] for b, _, _ in span for r in b["requests"])
    traced = [b for b in batches if b["traced"]]
    return {
        "kind": "serve", "port": port, "mix": mix, "peaks": peaks,
        "setup_s": state["setup_s"],
        "window_s": t1 - t0,
        "attempted": len(due_in), "failed": failed,
        "ttft_s": ttft,
        "padded_positions": positions - real, "prefilled_positions":
        positions,
        "prefill_s": sum(pf["prefill_time_s"] for _, pf, _ in span),
        "decode_s": sum(dc["decode_time_s"] for _, _, dc in span),
        "decode_steps": sum(max(len(r[2]) for r in b["requests"]) - 1
                            for b, _, _ in span),
        "served_tokens": sum(len(r[2]) for b, _, _ in span
                             for r in b["requests"]),
        "real_prompt_tokens": real,
        "trace": trace_read,
        "traced_batches": [(len(b["requests"]),
                            max(r[1] for r in b["requests"]))
                           for b in traced],
        "launches": state.get("launches"),
        # the raw record, for readers added later
        "batches": batches, "points": summary["points"],
        "due_s": {p.rid: t0 + p.due_s for p in plan if p.rid >= 0},
        "t_start": t0, "t_end": t1,
    }


def sample(got: dict, mix: dict, seed: int) -> list:
    """A sample, drawn from the seed, of the requests finished for the
    window: the longest (prompt and served tokens) first, then others in a
    seeded order until ``check_tokens`` served tokens are in it.  Each as
    (prompt, its batch's prompt length, served tokens)."""
    plan = {p.rid: p for p in got["plan"] if p.rid >= 0}
    done = []
    for b in got["batches"]:
        plen = max(r[1] for r in b["requests"])
        done += [(plan[rid].prompt, plen, out) for rid, _, out in
                 b["requests"] if rid in plan]
    if not done:
        return []
    longest = max(range(len(done)),
                  key=lambda i: len(done[i][0]) + len(done[i][2]))
    rest = [i for i in np.random.default_rng(seed).permutation(len(done))
            if i != longest]
    picked, tokens = [longest], len(done[longest][2])
    for i in rest:
        if tokens >= mix["check_tokens"]:
            break
        picked.append(i)
        tokens += len(done[i][2])
    return [done[i] for i in picked]


def check(cfg_file: dict, mix: dict, seed: int, got: dict, device,
          control: bool = False) -> dict:
    """The widest gap by which a served token's logit lies below the fp32
    reference's best, over the sampled requests (``reference.serve``)."""
    from chipbench.reference import model, serve as rserve
    model.no_tf32()
    picked = sample(got, mix, seed)
    per = rserve.gaps(got["params"], cfg_file["port"], picked, device,
                      control=control)
    worst = max(range(len(per)), key=per.__getitem__) if per else None
    return {"gaps": {"token_gap": max(per) if per else math.inf},
            "requests": len(picked),
            "tokens": sum(len(p[2]) for p in picked),
            "worst": {"request": worst,
                      "prompt_len": len(picked[worst][0])
                      if worst is not None else None}}
