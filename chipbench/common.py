"""What every cell shares: finding its files by name, the readers of its
metrics, the check of loaded modules, and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; each
is a file of its own (``configs/<name>.json``, ``traffic/<name>.json``), as
is each metric's reader (``metrics/<name>.py``, with ``UNIT`` and
``read(run) -> number | None``), each cell's correctness limits
(``limits/<cell>.json``), each model family of the references and counts
(``families/<family>.py``, by a configuration's ``port["family"]``) and
each kind of arrivals (``arrivals/<kind>.py``, by a mix's ``arrivals``).
Adding any of them edits no file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config_file(name: str, bench: dict, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_file(name: str, here: Path = HERE) -> dict:
    return load_json(here / "traffic" / f"{name}.json")


def limits_file(cell_name: str, here: Path = HERE) -> dict:
    return load_json(here / "limits" / f"{cell_name}.json")


_LOADED: dict = {}


def load_module(folder: str, name: str, here: Path | None = None):
    """The module ``<folder>/<name>.py`` under ``here`` (the benchmark's
    folder by default), loaded once a path."""
    if not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}", name):
        raise ValueError(f"not a name: {name!r}")
    path = (here or HERE) / folder / f"{name}.py"
    if path not in _LOADED:
        if not path.is_file():
            raise KeyError(f"no {folder}/{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"chipbench_{folder}_" + re.sub(r"[.-]", "_", name), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def metric_reader(name: str, here: Path | None = None):
    """The module ``metrics/<name>.py`` (its ``UNIT`` and ``read``)."""
    return load_module("metrics", name, here)


def family(port: dict, here: Path | None = None):
    """The module ``families/<family>.py`` of a configuration's ``port``
    section: its ``leaves``, ``hidden`` and ``flop_params``."""
    return load_module("families", port["family"], here)


def arrivals(mix: dict, here: Path | None = None):
    """The module ``arrivals/<kind>.py`` of a traffic mix: its ``count``
    and ``gaps``."""
    return load_module("arrivals", mix["arrivals"], here)


def cell_metrics(cell_name: str, bench: dict, trace: bool) -> list:
    """The metrics a cell reports: with ``trace`` its per-layer ones, else
    its end-to-end ones (an entry with ``workloads`` only in those)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def read_metrics(cell_name: str, bench: dict, trace: bool, run: dict,
                 here: Path | None = None) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader finds
    something to read in ``run`` (a finite number)."""
    out = {}
    for m in cell_metrics(cell_name, bench, trace):
        value = metric_reader(m["name"], here).read(run)
        if value is None or not math.isfinite(value):
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole (``repro_torch`` is not
    ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own kernel library builds under ``build/`` there too)."""
    base = root / "build" / "chipbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["USE_FLAX"] = "0"


class Phases:
    """The set-up's phases: ``mark(label)`` ends the phase ``label`` now;
    ``seconds`` holds each label's time since the mark before it, summed
    over the marks of that label."""

    def __init__(self, t0: float):
        self.last = t0
        self.seconds: dict = {}

    def mark(self, label: str) -> None:
        now = time.monotonic()
        self.seconds[label] = self.seconds.get(label, 0.0) + now - self.last
        self.last = now


def device_block(torch, count: int, memory_peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(memory_peak_bytes)}


def checks_block(values: dict, limits: dict) -> tuple:
    """(all within limits, {name: {"value", "limit"}}) of the numbers
    compared; a number that is missing or not finite fails, and is printed
    as null."""
    out, ok = {}, True
    for k, lim in limits.items():
        v = values.get(k, math.inf)
        finite = math.isfinite(v)
        if not (finite and v <= lim):
            ok = False
        out[k] = {"value": v if finite else None, "limit": lim}
    return ok, out


def print_result(result: dict, checks: dict) -> None:
    """The numbers compared on standard error as its last lines, then the
    result as the last line of standard output, the checks last in it."""
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
