"""Launch analysis of the port (``repro_torch.launch.{steps, cost_analysis}``,
``repro_torch.core.analysis``, the loop's constants) against the reference,
on the CPU.

* ``input_specs`` and ``serve_param_specs``: every key's shape, dtype and
  logical axes equal to ``repro.launch.steps``'s, for the 10 assigned archs
  x 4 shapes; ``supports_shape`` and ``ASSIGNED_ARCHS`` equal.
* ``_moe_localized`` equal for mixtral and deepseek on (1, 1), (4, 2),
  (16, 16) and (2, 16, 16).
* The roofline copy equals the reference's ``RooflineAnalyzer`` and its
  classification when both are given the same peaks (two remedies are
  reworded for the card; pattern, path and missing data are the same).
* The step counter equals the reference's ``analyze_hlo`` on the small
  programs ``tests/test_hlo_analysis.py`` builds: a dot exactly (flops and
  bytes), tanh / exp / a scale at the reference's elementwise weights, a
  loop of N steps against a scan of known trip count N (the scan's loop
  counter, an add and a compare a trip, is the only difference), and each
  collective kind at group sizes 2, 4 and 16 against a hand-written HLO
  line of the same operation (operand and wire bytes).
* The port's own traffic: the bytes model on known operations; each flash,
  RMSNorm and SSD call on meta counted once at its cost model and none of
  the plain versions' operations (the plain versions still compute on the
  CPU); the SSD backward's scratch held; over 4 gloo ranks the counted
  collective bytes of one data-parallel step equal to the bytes the real
  step's ``comm`` calls sent; ``train()`` posting the MEM and ICI groups
  and the ``train_step`` region's bytes.
"""

import dataclasses
import json
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torch_dist_ranks  # noqa: E402
from repro.configs import ASSIGNED_ARCHS as J_ARCHS  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import supports_shape as j_supports  # noqa: E402
from repro.core import analysis as janalysis  # noqa: E402
from repro.core import MonitoringStack  # noqa: E402
from repro.core.marker import MARKER_MEASUREMENT  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.models.params import ParamSpec as JSpec  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, ShapeConfig, \
    TrainConfig, get_config, supports_shape  # noqa: E402
from repro_torch.core import analysis as tanalysis  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.launch import cost_analysis as ca  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    flatten, fp32_leaves, unflatten)
from repro_torch.parallel import comm  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402

PEAKS = {"peak_flops": 989e12, "hbm_bw": 3.35e12}


def _jflat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JSpec))[0]
    return {"/".join(str(p.key) for p in path): s for path, s in flat}


def _jdesc(s) -> tuple:
    return tuple(s.shape), jnp.dtype(s.dtype).name, tuple(s.axes)


def _tdesc(s) -> tuple:
    return tuple(s.shape), str(s.dtype).replace("torch.", ""), tuple(s.axes)


# -- specs, configs, MoE localisation ----------------------------------------------


@pytest.mark.parametrize("shape", list(J_SHAPES))
@pytest.mark.parametrize("arch", J_ARCHS)
def test_input_specs_match_the_reference(arch, shape):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    want = {k: _jdesc(v) for k, v in
            jsteps.input_specs(jcfg, J_SHAPES[shape]).items()}
    got = {k: _tdesc(v) for k, v in
           tsteps.input_specs(tcfg, SHAPES[shape]).items()}
    assert got == want
    assert supports_shape(tcfg, SHAPES[shape]) == \
        j_supports(jcfg, J_SHAPES[shape])


@pytest.mark.parametrize("arch", J_ARCHS)
def test_serve_param_specs_match_the_reference(arch):
    want = {k: _jdesc(v) for k, v in
            _jflat(jsteps.serve_param_specs(jget_config(arch))).items()}
    got = {k: _tdesc(v) for k, v in
           flatten(tsteps.serve_param_specs(get_config(arch))).items()}
    assert got == want
    # what the port's served model keeps in fp32 (its norm scales): the
    # bundles' layout
    kept = tsteps.serve_param_specs(get_config(arch),
                                    fp32_leaves(get_config(arch)))
    assert all(s.dtype == torch.float32 for k, s in flatten(kept).items()
               if k.endswith("/scale"))


def test_assigned_archs_are_the_reference_pool():
    assert ASSIGNED_ARCHS == J_ARCHS


def _jmesh(sizes: dict):
    shape = tuple(sizes.values())
    dev = np.array(jax.devices() * math.prod(shape)).reshape(shape)
    return Mesh(dev, tuple(sizes))


MOE_MESHES = {"1x1": {"data": 1, "model": 1}, "4x2": {"data": 4, "model": 2},
              "16x16": {"data": 16, "model": 16},
              "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.mark.parametrize("mesh", list(MOE_MESHES))
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-236b"])
def test_moe_localized_matches_the_reference(arch, mesh):
    sizes = MOE_MESHES[mesh]
    want = jsteps._moe_localized(jget_config(arch), _jmesh(sizes)).moe
    got = tsteps._moe_localized(get_config(arch), sizes).moe
    assert (got.dispatch_groups, got.impl) == (want.dispatch_groups,
                                               want.impl)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# -- roofline and classification ---------------------------------------------------

ROOF_CASES = {
    "compute": dict(hlo_flops=8e17, hbm_bytes=1e14, collective_bytes=1e11,
                    model_flops=6e17),
    "memory": dict(hlo_flops=1e16, hbm_bytes=5e15, collective_bytes=1e11,
                   model_flops=8e15),
    "recompute": dict(hlo_flops=1e16, hbm_bytes=5e15, collective_bytes=1e11,
                      model_flops=1e15),
    "collective": dict(hlo_flops=1e15, hbm_bytes=1e13, collective_bytes=5e14,
                       model_flops=8e14),
    "overhead": dict(hlo_flops=1e15, hbm_bytes=2e15, collective_bytes=1.6e15,
                     model_flops=9e14),
}
REWORDED = ("latency/overhead-bound", "compute-bound")


@pytest.mark.parametrize("case", list(ROOF_CASES))
def test_roofline_matches_the_reference(case):
    peaks = (989e12, 3.35e12, 450e9)
    kw = dict(arch="a", shape="s", mesh="m", chips=256, **ROOF_CASES[case])
    want = janalysis.RooflineAnalyzer(*peaks).analyze(**kw)
    got = tanalysis.RooflineAnalyzer(*peaks).analyze(**kw)
    for attr in ("compute_s", "memory_s", "collective_s", "dominant",
                 "bound_s", "useful_flop_ratio", "roofline_fraction"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.fractions() == want.fractions()
    jc, tc = want.classify(), got.classify()
    assert (tc["pattern"], tc["path"], tc["missing"]) == \
        (jc["pattern"], jc["path"], jc["missing"])
    if jc["pattern"] not in REWORDED:
        assert tc["remedy"] == jc["remedy"]


TREE_CASES = {
    "ingest": {"data_stall_frac": 0.5},
    "imbalance": {"data_stall_frac": 0.0, "straggler_skew": 0.3},
    "missing-goodness": {"memory_frac": 0.1},
    "missing-pathology": {"collective_frac": 0.1, "memory_frac": 0.9,
                          "useful_flop_ratio": 0.9},
    "latency": {"collective_frac": 0.1, "memory_frac": 0.2, "mfu": 0.1},
    "compute": {"collective_frac": 0.1, "memory_frac": 0.2, "mfu": 0.5},
    "nan": {"collective_frac": float("nan"), "memory_frac": 0.2,
            "mfu": 0.5},
}


@pytest.mark.parametrize("case", list(TREE_CASES))
def test_decision_tree_matches_the_reference(case):
    want = janalysis.classify_job(TREE_CASES[case])
    got = tanalysis.classify_job(TREE_CASES[case])
    assert {k: got[k] for k in ("pattern", "path", "missing")} == \
        {k: want[k] for k in ("pattern", "path", "missing")}
    if want["pattern"] not in REWORDED:
        assert got["remedy"] == want["remedy"]
    else:                   # the card's words, not the other chip's
        assert "MXU" not in got["remedy"] and "scan" not in got["remedy"]


def test_the_roofline_copy_has_no_default_peak():
    with pytest.raises(TypeError):
        tanalysis.RooflineAnalyzer()


# -- the counter against analyze_hlo -------------------------------------------------


def _hlo(f, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze_hlo(jax.jit(f).lower(*args).compile().as_text())[
        "per_device"]


def _count(fn, *shapes):
    return ca.analyze_step(fn, tuple(torch.empty(s) for s in shapes))[
        "per_device"]


def test_dot_matches_the_reference_exactly():
    want = _hlo(lambda a, b: a @ b, (64, 32), (32, 16))
    got = _count(lambda a, b: a @ b, (64, 32), (32, 16))
    assert got["flops"] == want["flops"] == 2 * 64 * 32 * 16
    assert got["bytes"] == want["bytes"]
    assert got["elementwise_flops"] == 0


@pytest.mark.parametrize("name", ["tanh", "exp", "scale"])
def test_elementwise_weights_match_the_reference(name):
    jf = {"tanh": jnp.tanh, "exp": jnp.exp, "scale": lambda a: a * 2.0}[name]
    tf = {"tanh": torch.tanh, "exp": torch.exp,
          "scale": lambda a: a * 2.0}[name]
    want = _hlo(jf, (64, 32))
    got = _count(tf, (64, 32))
    assert got["elementwise_flops"] == want["flops"]
    assert got["transcendentals"] == want["transcendentals"]
    assert got["bytes"] == want["bytes"]
    assert got["flops"] == 0          # products only


@pytest.mark.parametrize("n", [3, 7])
def test_a_loop_matches_a_scan_of_its_trip_count(n):
    def body(x, _):
        return jnp.tanh(x @ x), None

    def jf(x):
        return jax.lax.scan(body, x, None, length=n)[0]

    def tf(x):
        for _ in range(n):
            x = torch.tanh(x @ x)
        return x
    want = _hlo(jf, (32, 32))
    got = _count(tf, (32, 32))
    # the scan's own counter: an add in the body and a compare in the
    # condition a trip, which a Python loop does not run on the device
    assert got["flops"] + got["elementwise_flops"] == want["flops"] - 2 * n
    assert got["flops"] == n * 2 * 32 ** 3
    assert got["transcendentals"] == want["transcendentals"]


_HLO_LINES = {
    "all-reduce": ("f32[{n}]", "f32[{n}]",
                   "all-reduce(%a), replica_groups=[{r},{g}]<=[16], "
                   "to_apply=%sum"),
    "all-gather": ("f32[{n}]", "f32[{ng}]",
                   "all-gather(%a), replica_groups=[{r},{g}]<=[16], "
                   "dimensions={{0}}"),
    "reduce-scatter": ("f32[{n}]", "f32[{nd}]",
                       "reduce-scatter(%a), replica_groups=[{r},{g}]<=[16], "
                       "dimensions={{0}}, to_apply=%sum"),
    "all-to-all": ("f32[{n}]", "f32[{n}]",
                   "all-to-all(%a), replica_groups=[{r},{g}]<=[16], "
                   "dimensions={{0}}"),
}


def _collective_hlo(kind: str, n: int, g: int) -> dict:
    ins, outs, op = _HLO_LINES[kind]
    fmt = dict(n=n, ng=n * g, nd=n // g, r=16 // g, g=g)
    ins, outs, op = (s.format(**fmt) for s in (ins, outs, op))
    text = (f"HloModule m, num_partitions=16\n\n"
            f"ENTRY %main (a: {ins}) -> {outs} {{\n"
            f"  %a = {ins}{{0}} parameter(0)\n"
            f"  ROOT %c = {outs}{{0}} {op}\n}}\n")
    return analyze_hlo(text)["per_device"]


def _comm_call(kind: str, x, g: int):
    mesh = {"data": g}
    if kind == "all-reduce":
        return comm.all_reduce(x, mesh, ("data",))
    if kind == "all-gather":
        return comm.all_gather(x, mesh, "data", 0)
    if kind == "reduce-scatter":
        return comm.reduce_scatter(x, mesh, "data", 0)
    return comm.all_to_all(x, mesh, "data")


@pytest.mark.parametrize("g", [2, 4, 16])
@pytest.mark.parametrize("kind", list(_HLO_LINES))
def test_collectives_match_the_reference(kind, g):
    """The port's helper on a meta operand of 64 fp32 elements over a
    group of g ranks (a {axis: size} mesh: the meta exchange is skipped)
    against the same operation's HLO line."""
    n = 64
    want = _collective_hlo(kind, n, g)
    r = ca.analyze_step(lambda x: _comm_call(kind, x, g), (torch.empty(n),))
    got = r["per_device"]
    assert got["collective_operand_bytes"] == \
        want["collective_operand_bytes"] == n * 4
    assert got["collective_wire_bytes"] == \
        pytest.approx(want["collective_wire_bytes"], rel=1e-12)
    assert got["by_collective"] == want["by_collective"]


def test_collective_permute_wire_is_its_operand():
    text = ("HloModule m, num_partitions=4\n\n"
            "ENTRY %main (a: f32[64]) -> f32[64] {\n"
            "  %a = f32[64]{0} parameter(0)\n"
            "  ROOT %c = f32[64]{0} collective-permute(%a), "
            "source_target_pairs={{0,1},{1,2},{2,3},{3,0}}\n}\n")
    want = analyze_hlo(text)["per_device"]
    assert ca.wire_bytes("collective-permute", 256, 256, 4) == \
        want["collective_wire_bytes"] == 256


def test_a_one_rank_axis_reports_nothing():
    r = ca.analyze_step(lambda x: comm.all_to_all(
        comm.all_reduce(x, {"data": 1}, ("data",)), {"model": 1}, "model"),
        (torch.empty(64),))
    assert r["per_device"]["collective_operand_bytes"] == 0
    assert r["per_device"]["by_collective"] == {}


# -- the port's own traffic ------------------------------------------------------------

BYTES_CASES = {
    "add": (lambda a, b: a + b, 3 * 4000),
    "view": (lambda a, b: a.view(10, 100), 0),
    "inplace": (lambda a, b: a.add_(b), 3 * 4000),
    "matmul": (lambda a, b: a.view(10, 100) @ b.view(100, 10),
               4000 + 4000 + 400),
    "expanded": (lambda a, b: a[:1].expand(7, 1000) + b[None], 4000 +
                 4000 + 7 * 4000),
}


@pytest.mark.parametrize("case", list(BYTES_CASES))
def test_bytes_model_on_known_operations(case):
    fn, want = BYTES_CASES[case]
    a, b = torch.empty(1000), torch.empty(1000)
    if case == "expanded":
        a = torch.empty(1, 1000)
    got = ca.analyze_step(fn, (a, b))["per_device"]
    assert got["bytes"] == got["bytes_fused"] == want


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_flash_on_meta_is_one_operation_at_its_cost_model():
    q, kv = _meta(2, 64, 8, 128), _meta(2, 64, 2, 128)
    r = ca.analyze_step(lambda q, k, v: ops.flash_attention_bshd(q, k, v),
                        (q, kv, kv))["per_device"]
    want = fa.cost_estimate((2, 8, 64, 128), 2, 2, causal=True)
    assert r["kernels"] == {"kernel:flash_attention": {
        "calls": 1, "flops": want["flops"], "bytes": want["bytes"]}}
    assert (r["flops"], r["bytes"], r["operations"]) == \
        (want["flops"], want["bytes"], 0)
    # on the CPU the plain version still computes
    g = torch.Generator().manual_seed(0)
    qc, kc = (torch.randn(t.shape, generator=g) for t in (q, kv))
    got = ops.flash_attention_bshd(qc, kc, kc)
    want_o = ref.attention_ref(qc.transpose(1, 2), kc.transpose(1, 2),
                               kc.transpose(1, 2)).transpose(1, 2)
    assert torch.equal(got, want_o)


def test_rmsnorm_on_meta_forward_and_backward_at_their_cost_models():
    x = _meta(4, 16, 512)
    scale = torch.empty(512, device="meta")

    def fwd_bwd(x, scale):
        x.requires_grad_()
        scale.requires_grad_()
        y = ops.fused_rmsnorm(x, scale)
        return torch.autograd.grad(y, (x, scale), torch.ones_like(y))
    r = ca.analyze_step(fwd_bwd, (x, scale))["per_device"]
    fwd = rms.cost_estimate(x.shape, 2)
    bwd = rms.bwd_cost_estimate(x.shape, 2)
    assert r["kernels"]["kernel:rmsnorm"] == {"calls": 1, **fwd}
    assert r["kernels"]["kernel:rmsnorm_backward"] == {"calls": 1, **bwd}
    # the two calls and the ones_like fill: none of the plain version's
    # reductions, squares or products
    assert r["operations"] == 1
    assert r["flops"] == fwd["flops"] + bwd["flops"]
    # the fill writes its output and does no arithmetic (a broadcast
    # constant in the reference's count)
    assert r["bytes"] == fwd["bytes"] + bwd["bytes"] + 4 * 16 * 512 * 2
    assert r["elementwise_flops"] == 0
    xc = torch.randn(4, 16, 512)
    sc = torch.rand(512)
    assert torch.equal(ops.fused_rmsnorm(xc, sc), ref.rmsnorm_ref(xc, sc))


def test_rmsnorm_backward_on_meta_keeps_the_cards_buffer():
    x = _meta(64, 4096)
    """dx in x's dtype and dscale in fp32, the kernel's (its per-block
    partials, at most a few MB a call, are not modelled)."""
    dx, dscale = rms.rmsnorm_bwd(x, torch.empty(4096, device="meta"), x)
    assert dx.shape == x.shape and dx.dtype == x.dtype and dx.is_meta
    assert dscale.shape == (4096,) and dscale.dtype == torch.float32
    assert dscale.untyped_storage().nbytes() == 4096 * 4


def test_ssd_backward_on_meta_holds_its_scratch():
    b, l, h, p, g, n = 1, 128, 4, 64, 1, 64
    x = _meta(b, l, h, p)
    a = _meta(b, l, h, dtype=torch.float32)
    bc = _meta(b, l, g, n)

    def fwd_bwd(x, a, bm, cm):
        for t in (x, a, bm, cm):
            t.requires_grad_()
        y, _ = ops.ssd_chunked_kernel(x, a, bm, cm)
        return torch.autograd.grad(y, (x, a, bm, cm), torch.ones_like(y))
    r = ca.analyze_step(fwd_bwd, (x, a, bc, bc))
    per = r["per_device"]
    assert per["kernels"]["kernel:ssd_scan"]["calls"] == 1
    assert per["kernels"]["kernel:ssd_scan_backward"]["calls"] == 1
    held = ssd.held_bytes((b, h, l, p), torch.bfloat16, g, n)
    assert r["memory"]["held_bytes"] == held > 0
    assert r["memory"]["peak_bytes"] >= held + r["memory"][
        "argument_bytes"]


@pytest.mark.parametrize("arch", ["lms-demo", "zamba2-7b"])
def test_step_flops_are_the_products_and_the_kernels_cost_models(arch):
    """The counter's flops on a whole train step are
    ``count_step_flops``'s (``FlopCounterMode``'s products, the SSD's cost
    model) plus the RMSNorm kernels' cost models: the optimizer update and
    the norms of the gradients add no products."""
    from repro_torch.models.transformer import model_specs
    from repro_torch.train import step as tstep
    cfg = get_config(arch, smoke=True)
    tcfg = TrainConfig(remat_policy="minimal")
    params = unflatten({k: torch.empty(s.shape, dtype=s.dtype)
                        for k, s in flatten(model_specs(cfg)).items()})
    fn, opt = tstep.make_train_step(cfg, tcfg)
    toks = torch.zeros((2, 32), dtype=torch.long)
    batch = {"tokens": toks, "labels": toks}
    per = ca.analyze_step(fn, (params, opt.init(params), batch, 0))[
        "per_device"]
    products = tstep.count_step_flops(params, batch, cfg, tcfg)
    norms = sum(v["flops"] for k, v in per["kernels"].items()
                if k.startswith("kernel:rmsnorm"))
    assert norms > 0
    assert per["flops"] == products + norms


def test_loop_constants_post_the_mem_and_ici_groups(tmp_path):
    cfg = get_config("lms-demo", smoke=True)
    tcfg = TrainConfig(total_steps=2, warmup_steps=1)
    shape = ShapeConfig("tiny", seq_len=32, global_batch=2, kind="train")
    stack = MonitoringStack.inprocess(out_dir=str(tmp_path))
    try:
        tloop.train(cfg, tcfg, shape, stack=stack, device="cpu",
                    job_id="ta", ici_bw=450e9, **PEAKS)
        db = stack.backend.db("global")
        hpm = db.select("hpm", ["mem_gb_per_s", "hbm_bw_util",
                                "ici_gb_per_s", "ici_bw_util",
                                "step_time_s"])[0].values
        assert len(hpm["hbm_bw_util"]) == 2
        assert all(u > 0 for u in hpm["hbm_bw_util"])
        assert all(v > 0 for v in hpm["mem_gb_per_s"])
        # one device: no collective
        assert hpm["ici_gb_per_s"] == [0.0, 0.0]
        assert hpm["ici_bw_util"] == [0.0, 0.0]
        step = db.select(MARKER_MEASUREMENT, ["flops", "bytes"],
                         tags={"region": "train_step"})[0].values
        assert all(b > 0 for b in step["bytes"])
        assert all(f > 0 for f in step["flops"])
    finally:
        stack.close()


def test_step_constants_are_the_analysis():
    analysis = {"per_device": {"flops": 3.0, "bytes": 5.0,
                               "collective_operand_bytes": 7.0,
                               "collective_wire_bytes": 11.0}}
    got = tloop.step_constants(analysis, model_flops=2.0,
                               tokens_per_step=13.0, peak_flops=1.0,
                               hbm_bw=2.0, ici_bw=3.0)
    assert got == {"hlo_flops": 3.0, "hlo_bytes": 5.0,
                   "collective_bytes": 7.0, "wire_bytes": 11.0,
                   "model_flops": 2.0, "tokens_per_step": 13.0,
                   "PEAK_FLOPS": 1.0, "HBM_BW": 2.0, "ICI_BW": 3.0}
    assert "ICI_BW" not in tloop.step_constants(
        analysis, model_flops=2.0, tokens_per_step=13.0, peak_flops=1.0,
        hbm_bw=2.0)


def test_h100_peaks_carry_one_direction_of_nvlink():
    assert tloop.DEVICE_PEAKS["H100"] == (989e12, 3.35e12, 450e9)


# -- over gloo: counted collectives against what the step sent -------------------

DIST_RUNS = [
    {"name": "granite-dp2-tp2", "model": "granite-3-8b",
     "names": ["data", "model"], "shape": [2, 2],
     "tcfg": {"num_microbatches": 2, "warmup_steps": 1}},
    {"name": "granite-dp2-tp2-sp", "model": "granite-3-8b",
     "names": ["data", "model"], "shape": [2, 2],
     "tcfg": {"seq_parallel": True, "warmup_steps": 1}},
    {"name": "mixtral-a2a", "model": "mixtral-8x7b",
     "names": ["data", "model"], "shape": [2, 2],
     "moe": {"impl": "a2a"}, "tcfg": {"optimizer": "adafactor"}},
    {"name": "lms-demo-pods-int8", "model": "lms-demo",
     "names": ["pod", "data", "model"], "shape": [2, 2, 1],
     "tcfg": {"grad_compression": "int8"}},
    {"name": "pipeline-4-stages", "pipeline": True,
     "names": ["pipe"], "shape": [4]},
    {"name": "pipeline-4-stages-grad", "pipeline": "grad",
     "names": ["pipe"], "shape": [4]},
]


@pytest.fixture(scope="module")
def dist_counts(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("analysis"))
    return torch_dist_ranks.launch("analysis", 4, work, {"runs": DIST_RUNS})


@pytest.mark.parametrize("run", [r["name"] for r in DIST_RUNS])
def test_counted_collectives_equal_what_the_step_sent(dist_counts, run):
    for rank, out in enumerate(dist_counts):
        counted = out[f"{run}/counted"]
        sent = out[f"{run}/sent"]
        assert counted[0] > 0, (rank, counted)
        np.testing.assert_array_equal(counted, sent)
        np.testing.assert_array_equal(out[f"{run}/counted_kinds"],
                                      out[f"{run}/sent_kinds"])
        purposes = json.loads(str(out[f"{run}/counted_purposes"]))
        assert purposes == json.loads(str(out[f"{run}/sent_purposes"]))
        if run.startswith("pipeline"):
            # a stage's hand-offs of 2 x 8 fp32 rows a microbatch, and the
            # broadcast of the 8 x 8 outputs (and of dx), each way
            stage = rank                # a ("pipe",) mesh of the world
            act = 4 * 64 * (stage < 3) + 4 * 64
            want = {"pipe_act": act}
            if run.endswith("-grad"):
                want["pipe_grad"] = 4 * 64 * (stage > 0) + 4 * 64
            assert purposes == want, (rank, purposes)


# -- the train CLI's mesh flags ---------------------------------------------------


def test_train_cli_on_one_rank_builds_no_mesh(tmp_path, capsys):
    from repro_torch.launch import train as train_cli
    stack = MonitoringStack.inprocess(out_dir=str(tmp_path),
                                      serve_http=True)
    try:
        assert train_cli.main([
            "--arch", "lms-demo", "--smoke", "--seq-len", "32",
            "--global-batch", "2", "--steps", "2", "--tp", "2",
            "--ici-bw", "450e9",
            "--peak-flops", "989e12", "--hbm-bw", "3.35e12",
            "--device", "cpu", "--lms-url", stack.http.url]) == 0
        out = capsys.readouterr().out
        assert "mesh: none (one rank" in out
        hpm = stack.backend.db("global").select(
            "hpm", ["ici_bw_util", "hbm_bw_util"])[0].values
        assert hpm["ici_bw_util"] == [0.0, 0.0]
        assert all(u > 0 for u in hpm["hbm_bw_util"])
    finally:
        stack.close()


def test_train_cli_on_two_ranks_trains_on_a_mesh(tmp_path):
    """``--tp 2`` on a world of 2 gloo ranks: a (1, 2) data x model mesh,
    one job, whose hpm points carry the ranks' gathers (the ICI group)."""
    stack = MonitoringStack.inprocess(out_dir=str(tmp_path / "lms"),
                                      serve_http=True)
    try:
        out = torch_dist_ranks.launch("cli", 2, str(tmp_path / "w"), {
            "world": 2, "argv": [
                "--arch", "lms-demo", "--smoke", "--seq-len", "32",
                "--global-batch", "2", "--steps", "2", "--tp", "2",
                "--peak-flops", "989e12",
                "--hbm-bw", "3.35e12", "--ici-bw", "450e9",
                "--device", "cpu", "--lms-url", stack.http.url]})
        assert [int(o["rc"]) for o in out] == [0, 0]
        assert all(list(o["mesh"]) == ["mesh: {'data': 1, 'model': 2}"]
                   for o in out)
        assert out[0]["job"][0] == out[1]["job"][0]
        hpm = stack.backend.db("global").select(
            "hpm", ["ici_gb_per_s", "ici_bw_util"])
        utils = [u for p in hpm for u in p.values["ici_bw_util"]]
        assert len(utils) == 4 and all(u > 0 for u in utils)
    finally:
        stack.close()


def test_train_cli_takes_the_references_grad_compression(tmp_path, capsys,
                                                         monkeypatch):
    """``--grad-compression`` lists the reference's choices, and its value
    reaches ``train()``'s ``TrainConfig``."""
    from repro.launch import train as jtrain_cli
    from repro_torch.launch import train as train_cli
    helps = []
    for cli in (jtrain_cli, train_cli):
        with pytest.raises(SystemExit):
            cli.main(["--help"])
        helps.append(re.search(r"--grad-compression \{[^}]*\}",
                               capsys.readouterr().out).group(0))
    assert helps[0] == helps[1] == "--grad-compression {none,int8,bf16}"
    seen = []

    class Reached(Exception):
        pass

    def reached(cfg, tcfg, *args, **kwargs):
        seen.append(tcfg)
        raise Reached

    monkeypatch.setattr(train_cli, "train", reached)
    stack = MonitoringStack.inprocess(out_dir=str(tmp_path),
                                      serve_http=True)
    try:
        with pytest.raises(Reached):
            train_cli.main(["--arch", "lms-demo", "--smoke", "--steps", "1",
                            "--grad-compression", "int8", "--device", "cpu",
                            "--peak-flops", "989e12", "--hbm-bw", "3.35e12",
                            "--lms-url", stack.http.url])
    finally:
        stack.close()
    assert [t.grad_compression for t in seen] == ["int8"]


def test_train_cli_grad_compression_on_its_own_mesh_changes_nothing(
        tmp_path):
    """On the CLI's own ("data", "model") mesh (no "pod" axis) of a world
    of 2 gloo ranks, ``--grad-compression int8`` gives the losses of the
    run without it, bit for bit: the reference's flag acts only across
    pods."""
    stack = MonitoringStack.inprocess(out_dir=str(tmp_path / "lms"),
                                      serve_http=True)
    try:
        argv = ["--arch", "lms-demo", "--smoke", "--seq-len", "32",
                "--global-batch", "4", "--steps", "3",
                "--peak-flops", "989e12", "--hbm-bw", "3.35e12",
                "--device", "cpu", "--lms-url", stack.http.url]
        out = torch_dist_ranks.launch("cli", 2, str(tmp_path / "w"), {
            "world": 2, "argvs": [argv, argv + ["--grad-compression",
                                                "int8"]]})
        assert [int(o["rc"]) for o in out] == [0, 0]
        assert all(list(o["mesh"]) == ["mesh: {'data': 2, 'model': 1}"] * 2
                   for o in out)
        for o in out:
            plain, int8 = o["losses"]
            assert len(plain) == 3 and np.all(np.isfinite(plain))
            np.testing.assert_array_equal(int8, plain)
    finally:
        stack.close()
