"""LIKWID-style performance groups on the job side (copy of the formula
compiler, the group format and the built-in groups of
``repro.core.perf_groups``).

A group lists the raw events it needs and formulas for derived metrics::

    GROUP FLOPS
    EVENTSET
      hlo_flops
      step_time_s
    METRICS
      gflops_per_s  hlo_flops / step_time_s / 1e9
      mfu           model_flops / step_time_s / PEAK_FLOPS

Formulas are compiled once by a small safe arithmetic evaluator (no
``eval``).  Unlike the stack's copy this one carries **no hardware
constants**: a formula that names a peak (``PEAK_FLOPS``, ``HBM_BW``,
``ICI_BW``) reads it from the raw events, and when the events lack it the
metric is skipped, as a metric with any other missing event is.  So no
constant of another chip can reach a card's records: the training loop
passes the card's peaks as events.  The query side of the stack (quantile
calls, column evaluation, group registration) is not copied.
"""

from __future__ import annotations

import ast
import functools
import operator
from dataclasses import dataclass
from typing import Optional

_BINOPS = {ast.Add: operator.add, ast.Sub: operator.sub,
           ast.Mult: operator.mul, ast.Div: operator.truediv,
           ast.Pow: operator.pow, ast.Mod: operator.mod}
_UNOPS = {ast.USub: operator.neg, ast.UAdd: operator.pos}
_FUNCS = {"min": min, "max": max, "abs": abs}


def _build(node):
    """AST node -> ``fn(env) -> float`` closure.  Only the whitelisted
    arithmetic subset compiles; anything else raises ValueError."""
    if isinstance(node, ast.Expression):
        return _build(node.body)
    if isinstance(node, ast.Constant):
        if isinstance(node.value, (int, float)) and \
                not isinstance(node.value, bool):
            c = float(node.value)
            return lambda env: c
        raise ValueError(f"bad constant {node.value!r}")
    if isinstance(node, ast.Name) or (
            isinstance(node, ast.Attribute) and
            isinstance(node.value, ast.Name)):
        ident = node.id if isinstance(node, ast.Name) \
            else f"{node.value.id}.{node.attr}"

        def name_fn(env, ident=ident):
            if ident in env:
                return float(env[ident])
            raise KeyError(ident)
        return name_fn
    if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
        op = _BINOPS[type(node.op)]
        left, right = _build(node.left), _build(node.right)
        return lambda env: op(left(env), right(env))
    if isinstance(node, ast.UnaryOp) and type(node.op) in _UNOPS:
        op = _UNOPS[type(node.op)]
        operand = _build(node.operand)
        return lambda env: op(operand(env))
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and \
            node.func.id in _FUNCS:
        func = _FUNCS[node.func.id]
        args = [_build(a) for a in node.args]
        return lambda env: func(*[a(env) for a in args])
    raise ValueError(f"disallowed syntax: {ast.dump(node)}")


class CompiledFormula:
    """One parsed and compiled formula; ``eval(env)`` raises ``KeyError``
    for an identifier ``env`` lacks."""

    __slots__ = ("expr", "_fn")

    def __init__(self, expr: str):
        self.expr = expr
        self._fn = _build(ast.parse(expr, mode="eval"))

    def eval(self, env: dict) -> float:
        return self._fn(env)


compile_formula = functools.lru_cache(maxsize=256)(CompiledFormula)


@dataclass
class PerfGroup:
    name: str
    events: list                       # required raw event names
    metrics: list                      # (metric name, formula) pairs
    description: str = ""

    def derive(self, raw_events: dict, strict: bool = False,
               skipped: Optional[list] = None) -> dict:
        """raw events -> derived metrics; a metric whose formula misses an
        event, or divides by zero, is skipped (and listed in ``skipped``,
        with its reason, when a list is given) unless ``strict``."""
        out = {}
        for mname, formula in self.metrics:
            try:
                out[mname] = compile_formula(formula).eval(raw_events)
            except KeyError as e:
                if strict:
                    raise
                if skipped is not None:
                    skipped.append((mname, f"missing event {e.args[0]!r}"))
            except ZeroDivisionError:
                if strict:
                    raise
                if skipped is not None:
                    skipped.append((mname, "division by zero"))
        return out


def parse_group(text: str) -> PerfGroup:
    """Parse the LIKWID-like group format (GROUP/EVENTSET/METRICS)."""
    name, desc = "", ""
    events, metrics = [], []
    section = None
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("GROUP"):
            name = line.split(None, 1)[1].strip()
        elif line == "EVENTSET":
            section = "events"
        elif line == "METRICS":
            section = "metrics"
        elif line.startswith("DESC"):
            desc = line.split(None, 1)[1].strip()
        elif section == "events":
            events.append(line.split()[0])
        elif section == "metrics":
            parts = line.split(None, 1)
            if len(parts) == 2:
                metrics.append((parts[0], parts[1]))
    if not name:
        raise ValueError("group text missing GROUP header")
    return PerfGroup(name, events, metrics, desc)


# The stack's built-in groups, text for text (ROOFLINE with its symbolic
# peaks: the job side never bakes a calibration in).
_GROUP_TEXTS = [
    """
    GROUP FLOPS
    DESC floating point throughput and machine utilization (IPC analogue)
    EVENTSET
      hlo_flops
      model_flops
      step_time_s
    METRICS
      gflops_per_s        hlo_flops / step_time_s / 1e9
      hw_flops_util       hlo_flops / step_time_s / PEAK_FLOPS
      mfu                 model_flops / step_time_s / PEAK_FLOPS
      useful_flop_ratio   model_flops / hlo_flops
    """,
    """
    GROUP MEM
    DESC memory bandwidth and footprint
    EVENTSET
      hlo_bytes
      step_time_s
      hbm_bytes_in_use
    METRICS
      mem_gb_per_s        hlo_bytes / step_time_s / 1e9
      hbm_bw_util         hlo_bytes / step_time_s / HBM_BW
      hbm_used_gb         hbm_bytes_in_use / 1e9
    """,
    """
    GROUP ICI
    DESC interconnect (collective) traffic — the QPI/network analogue
    EVENTSET
      collective_bytes
      wire_bytes
      step_time_s
    METRICS
      ici_gb_per_s        collective_bytes / step_time_s / 1e9
      ici_bw_util         collective_bytes / step_time_s / ICI_BW
      ici_wire_gb_per_s   wire_bytes / step_time_s / 1e9
      ici_wire_bw_util    wire_bytes / step_time_s / ICI_BW
    """,
    """
    GROUP GOODPUT
    DESC end-to-end job progress (the "CPU load" analogue for a TPU job)
    EVENTSET
      step_time_s
      tokens_per_step
      data_wait_s
    METRICS
      tokens_per_s        tokens_per_step / step_time_s
      data_stall_frac     data_wait_s / step_time_s
      steps_per_s         1.0 / step_time_s
    """,
    """
    GROUP ROOFLINE
    DESC marker-region roofline placement from work counters (hardware-constant peaks)
    EVENTSET
      flops
      bytes
      time_s
    METRICS
      intensity           flops / bytes
      achieved_gflops     flops / time_s / 1e9
      attainable_gflops   min(PEAK_FLOPS, HBM_BW * flops / bytes) / 1e9
      roofline_frac       flops / time_s / min(PEAK_FLOPS, HBM_BW * flops / bytes)
    """,
]

GROUPS = {g.name: g for g in (parse_group(t) for t in _GROUP_TEXTS)}


def formula_for(metric: str) -> Optional[str]:
    """The formula behind a group metric name (``MEM.hbm_bw_util`` or a bare
    ``hbm_bw_util``), or None."""
    gname, _, mname = metric.rpartition(".")
    for g in ([GROUPS[gname]] if gname in GROUPS else
              [] if gname else GROUPS.values()):
        for name, formula in g.metrics:
            if name == mname:
                return formula
    return None


def derive_all(raw_events: dict, skipped: Optional[list] = None) -> dict:
    """Run every group over the raw events; each metric whose events are
    all present is derived."""
    out = {}
    for g in GROUPS.values():
        out.update(g.derive(raw_events, skipped=skipped))
    return out
