"""Reading a ``torch.profiler`` trace of a bounded part of a run's window.

The window is a user annotation (``chipbench:window``) the driver opens and
closes around whole units of work.  Device operations are the trace's
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events; the device is busy
over the union of their intervals (as ``profile_train.py`` and
``profile_serve.py`` count it).  An idle gap is named by the innermost host
operation running when it began, or ``python`` where none ran.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

WINDOW = "chipbench:window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def union(intervals) -> list:
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def export_events(prof) -> list:
    """The trace's events, through a Chrome trace in a temporary file."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def read(events: list) -> dict:
    """The window's device time: ``window_s``, ``busy_s``, every device
    operation clipped to the window (``ops``: (name, seconds)), the idle
    gaps by host activity and the top ten of each."""
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW]
    if not win:
        raise ValueError("the trace has no window annotation")
    t0, t1 = win[-1]["ts"], win[-1]["ts"] + win[-1]["dur"]
    ops = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
            if b > a:
                ops.append((a, b, e.get("name", "?")))
    busy = union((a, b) for a, b, _ in ops)
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0), e.get("name", "?"))
                  for e in events if e.get("cat") in HOST_CATS
                  and e.get("name") != WINDOW and "dur" in e)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    gaps = defaultdict(float)
    for (a, b), name in zip(idle, _host_at(host, [a for a, _ in idle])):
        gaps[name] += (b - a) / 1e6
    by_op = defaultdict(float)
    for a, b, n in ops:
        by_op[n] += (b - a) / 1e6
    return {
        "window_s": (t1 - t0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "ops": [(n, (b - a) / 1e6) for a, b, n in ops],
        "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10]}


def _host_at(host: list, times: list) -> list:
    """For each of the sorted ``times``, the shortest host event covering
    it: one sweep over the host events sorted by start."""
    out, active, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= t]
        best = min(active, key=lambda h: h[1] - h[0], default=None)
        out.append(f"host: {best[2]}" if best else "host: python")
    return out
