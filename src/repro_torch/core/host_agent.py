"""Host agent: per-node metric collection (copy of
``repro.core.host_agent.HostAgent``).

Gathers system metrics from the OS (CPU load and time, RSS, I/O and network
counters, with per-interval rates) and the per-step HPM events of the job
(the step constants, the step time and any extra events), derives the
performance groups (:mod:`repro_torch.core.perf_groups`) and emits both
with the mandatory ``hostname`` tag.  Points are handed to the sink in
batches of ``batch_size``; a failing sink re-buffers them (bounded).
"""

from __future__ import annotations

import os
import resource
import socket
import threading
import time
from typing import Optional

from repro_torch.core.line_protocol import Point, now_ns
from repro_torch.core.perf_groups import derive_all


def _read_proc_io() -> dict:
    try:
        out = {}
        with open("/proc/self/io") as f:
            for line in f:
                k, _, v = line.partition(":")
                out[k.strip()] = int(v)
        return {"read_bytes": out.get("read_bytes", 0),
                "write_bytes": out.get("write_bytes", 0)}
    except OSError:
        return {"read_bytes": 0, "write_bytes": 0}


def _read_net_dev(path: str = "/proc/net/dev") -> dict:
    try:
        rx = tx = 0
        with open(path) as f:
            for line in f.readlines()[2:]:
                name, _, rest = line.partition(":")
                if name.strip() == "lo":
                    continue
                try:                     # skip a malformed or torn row
                    cols = rest.split()
                    row_rx, row_tx = int(cols[0]), int(cols[8])
                except (ValueError, IndexError):
                    continue
                rx += row_rx
                tx += row_tx
        return {"net_rx_bytes": rx, "net_tx_bytes": tx}
    except OSError:
        return {"net_rx_bytes": 0, "net_tx_bytes": 0}


class HostAgent:
    """Collects system and per-step HPM metrics for one host.

    ``sink`` has ``.write(points)``; ``device_constants`` are the static
    per-step facts (flops, model flops, tokens a step, the device's peaks
    as ``PEAK_FLOPS`` / ``HBM_BW``)."""

    # cumulative counter field -> the per-interval rate derived from it
    RATE_FIELDS = {
        "cpu_user_s": "cpu_user_frac",
        "cpu_sys_s": "cpu_sys_frac",
        "read_bytes": "read_bytes_per_s",
        "write_bytes": "write_bytes_per_s",
        "net_rx_bytes": "net_rx_bytes_per_s",
        "net_tx_bytes": "net_tx_bytes_per_s",
    }

    def __init__(self, sink, hostname: Optional[str] = None,
                 device_constants: Optional[dict] = None,
                 batch_size: int = 1,
                 max_pending_points: int = 65536):
        self.sink = sink
        self.hostname = hostname or socket.gethostname()
        self.step_constants = dict(device_constants or {})
        self._last_sys: Optional[dict] = None
        self._last_t = time.monotonic()
        self.batch_size = max(int(batch_size), 1)
        self.max_pending_points = int(max_pending_points)
        self._lock = threading.Lock()
        self._pending: list = []
        self._failed_flushes = 0
        self._dropped_points = 0

    def set_step_constants(self, **kwargs):
        self.step_constants.update(kwargs)

    # -- system metrics -------------------------------------------------------

    def _rate_fields(self, counters: dict, now_m: float) -> dict:
        """Per-interval rates from consecutive cumulative samples; a
        negative delta (a counter reset) skips that rate and re-baselines."""
        prev, dt = self._last_sys, now_m - self._last_t
        out = {}
        if prev is not None and dt > 0:
            for k, rate_name in self.RATE_FIELDS.items():
                cur, last = counters.get(k), prev.get(k)
                if cur is None or last is None:
                    continue
                delta = cur - last
                if delta < 0:
                    continue
                out[rate_name] = delta / dt
        self._last_sys = counters
        self._last_t = now_m
        return out

    def collect_system(self) -> Point:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        try:
            load1, _, _ = os.getloadavg()
        except OSError:
            load1 = 0.0
        fields = {
            "cpu_load_1m": load1,
            "cpu_user_s": ru.ru_utime,
            "cpu_sys_s": ru.ru_stime,
            "rss_bytes": ru.ru_maxrss * 1024,
            **{k: float(v) for k, v in _read_proc_io().items()},
            **{k: float(v) for k, v in _read_net_dev().items()},
        }
        counters = {k: fields[k] for k in self.RATE_FIELDS if k in fields}
        fields.update(self._rate_fields(counters, time.monotonic()))
        return Point("system", {"hostname": self.hostname}, fields, now_ns())

    # -- per-step HPM ---------------------------------------------------------

    def collect_step(self, *, step: int, step_time_s: float,
                     extra_events: Optional[dict] = None,
                     emit: bool = True, ts: Optional[int] = None) -> dict:
        """Raw events of one step -> derived groups, emitted as an ``hpm``
        point (``ts`` overrides its timestamp).  Returns the derived
        metrics."""
        raw = dict(self.step_constants)
        raw["step_time_s"] = max(step_time_s, 1e-9)
        raw["step"] = step
        if extra_events:
            raw.update(extra_events)
        derived = derive_all(raw)
        if emit:
            fields = {"step": step, "step_time_s": step_time_s}
            fields.update({k: float(v) for k, v in derived.items()})
            if extra_events:
                fields.update({k: float(v) for k, v in extra_events.items()
                               if k not in fields})
            self._emit(Point("hpm", {"hostname": self.hostname},
                             fields, ts if ts is not None else now_ns()))
        return derived

    def emit_system(self):
        self._emit(self.collect_system())

    # -- batched emission -----------------------------------------------------

    def _emit(self, point: Point):
        with self._lock:
            self._pending.append(point)
            full = len(self._pending) >= self.batch_size
        if full:
            self._flush(raise_errors=False)

    def flush(self):
        """Send any buffered points as one batch; a failing sink re-buffers
        them and raises."""
        self._flush(raise_errors=True)

    def _flush(self, raise_errors: bool):
        with self._lock:
            if not self._pending:
                return
            pending, self._pending = self._pending, []
        try:
            self.sink.write(pending)
        except Exception:
            with self._lock:
                self._failed_flushes += 1
                self._pending[:0] = pending
                excess = len(self._pending) - self.max_pending_points
                if excess > 0:
                    del self._pending[:excess]
                    self._dropped_points += excess
            if raise_errors:
                raise

    @property
    def emit_stats(self) -> dict:
        with self._lock:
            return {"pending": len(self._pending),
                    "failed_flushes": self._failed_flushes,
                    "dropped_points": self._dropped_points}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush()
        return False
