"""The roofline half of the stack's job analysis (copy of the decision tree
and the roofline analyzer of ``repro.core.analysis``).

A job's three roofline terms (compute, memory, collective) and its goodput
metrics walk the FEPA-style decision tree :data:`DEFAULT_TREE` to a pattern
and a remedy.  The copy keeps **no default peak**: a
:class:`RooflineAnalyzer` is built with the card's peaks, as the caller
knows them (``repro_torch.train.loop.DEVICE_PEAKS``), so no rate of another
chip can reach a card's record.  The tree's tests and thresholds are the
reference's; the two remedies that named the other chip's hardware (its
matrix unit's alignment, unrolling a compiled layer scan) name the card's
counterparts.  The streaming half of the module (rules, findings, the
job analyzer) lives in the stack, not here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

INSUFFICIENT_DATA = "insufficient-data"

_OPS = {
    "<": lambda a, b: a < b,
    ">": lambda a, b: a > b,
    "<=": lambda a, b: a <= b,
    ">=": lambda a, b: a >= b,
}


@dataclass
class PatternNode:
    """Internal node: test ``metric op threshold``; leaf: pattern+remedy.

    A pathology test (``>`` / ``>=``) with no data means "no evidence of
    that pathology": the false branch is taken and the gap recorded in the
    decision path and the ``missing`` list; a goodness test (``<`` /
    ``<=``) cannot certify either branch without data and classifies as
    ``insufficient-data``.
    """

    pattern: Optional[str] = None
    remedy: Optional[str] = None
    metric: Optional[str] = None
    op: Optional[str] = None
    threshold: Optional[float] = None
    if_true: Optional["PatternNode"] = None
    if_false: Optional["PatternNode"] = None

    def classify(self, metrics: dict, path: Optional[list] = None,
                 missing: Optional[list] = None):
        path = path if path is not None else []
        missing = missing if missing is not None else []
        if self.pattern is not None:
            return self.pattern, self.remedy, path, missing
        v = metrics.get(self.metric)
        if v is None or (isinstance(v, float) and math.isnan(v)):
            missing.append(self.metric)
            if self.op in ("<", "<="):
                path.append(f"{self.metric}=missing -> insufficient-data")
                return (INSUFFICIENT_DATA,
                        "metrics missing for classification: "
                        + ", ".join(missing), path, missing)
            path.append(f"{self.metric}=missing -> False (no evidence)")
            return self.if_false.classify(metrics, path, missing)
        taken = _OPS[self.op](v, self.threshold)
        path.append(f"{self.metric}={v:.3g} {self.op} {self.threshold}"
                    f" -> {taken}")
        nxt = self.if_true if taken else self.if_false
        return nxt.classify(metrics, path, missing)


def leaf(pattern, remedy):
    return PatternNode(pattern=pattern, remedy=remedy)


def node(metric, op, threshold, if_true, if_false):
    return PatternNode(metric=metric, op=op, threshold=threshold,
                       if_true=if_true, if_false=if_false)


# The FEPA decision tree on the roofline term fractions and goodput
# metrics.  Inputs (all in [0, ~1]):
#   compute_frac / memory_frac / collective_frac : term_i / sum(terms)
#   mfu            : model FLOPs utilization
#   useful_flop_ratio : model_flops / counted flops
#   data_stall_frac, straggler_skew
DEFAULT_TREE = node(
    "data_stall_frac", ">", 0.3,
    leaf("ingest-bound",
         "input pipeline too slow: add prefetch/workers, shard files"),
    node("straggler_skew", ">", 0.15,
         leaf("load-imbalance",
              "straggler host: checkpoint-restart without it (elastic), "
              "check MoE expert balance"),
         node("collective_frac", ">", 0.4,
              leaf("collective-bound",
                   "overlap collectives with compute, rethink sharding axes, "
                   "gradient compression, larger per-device batch"),
              node("memory_frac", ">", 0.5,
                   node("useful_flop_ratio", "<", 0.6,
                        leaf("recompute-heavy memory-bound",
                             "relax remat policy; fuse attention (flash) to "
                             "cut activation traffic"),
                        leaf("memory-bound",
                             "increase arithmetic intensity: fuse ops, "
                             "quantize weights/cache, batch decode requests")),
                   node("mfu", "<", 0.25,
                        leaf("latency/overhead-bound",
                             "kernel launch / small-batch overheads: grow "
                             "per-device batch, capture the step in a CUDA "
                             "graph, check host callbacks"),
                        leaf("compute-bound",
                             "good: push tile shapes / tensor-core "
                             "alignment; consider fp8 matmuls"))))))


def classify_job(metrics: dict, tree: PatternNode = DEFAULT_TREE) -> dict:
    pattern, remedy, path, missing = tree.classify(dict(metrics))
    return {"pattern": pattern, "remedy": remedy, "path": path,
            "missing": missing}


@dataclass
class RooflineResult:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float
    hbm_bytes: float
    collective_bytes: float

    @property
    def terms(self) -> dict:
        return {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}

    @property
    def dominant(self) -> str:
        return max(self.terms, key=self.terms.get)

    @property
    def bound_s(self) -> float:
        """Roofline lower bound on step time (max of the three terms)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute term / bound: 1.0 means perfectly compute-limited."""
        return self.compute_s / self.bound_s if self.bound_s else 0.0

    def fractions(self) -> dict:
        tot = sum(self.terms.values()) or 1.0
        return {f"{k}_frac": v / tot for k, v in self.terms.items()}

    def classify(self, extra_metrics: Optional[dict] = None) -> dict:
        m = {**self.fractions(),
             "useful_flop_ratio": self.useful_flop_ratio,
             "mfu": self.roofline_fraction,   # upper-bound MFU from terms
             "data_stall_frac": 0.0, "straggler_skew": 0.0}
        if extra_metrics:
            m.update(extra_metrics)
        return classify_job(m)


class RooflineAnalyzer:
    """Three-term roofline from a step's counts (per-card rates, given)."""

    def __init__(self, peak_flops: float, hbm_bw: float, ici_bw: float):
        self.peak_flops = peak_flops
        self.hbm_bw = hbm_bw
        self.ici_bw = ici_bw

    def analyze(self, *, arch: str, shape: str, mesh: str, chips: int,
                hlo_flops: float, hbm_bytes: float, collective_bytes: float,
                model_flops: float) -> RooflineResult:
        """All inputs are *global* (whole-program) quantities; the terms
        are per-card seconds assuming perfect balance."""
        return RooflineResult(
            arch=arch, shape=shape, mesh=mesh, chips=chips,
            compute_s=hlo_flops / (chips * self.peak_flops),
            memory_s=hbm_bytes / (chips * self.hbm_bw),
            collective_s=collective_bytes / (chips * self.ici_bw),
            model_flops=model_flops, hlo_flops=hlo_flops,
            hbm_bytes=hbm_bytes, collective_bytes=collective_bytes)
