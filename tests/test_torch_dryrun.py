"""The port's dry run (``repro_torch.launch.dryrun``) and its step bundles,
on the CPU, against the reference.

* ``default_train_cfg`` (data-parallel sizes 16 and 32), ``model_flops_for``
  and ``supports_shape`` equal ``repro.launch.dryrun``'s for the 10
  assigned archs x 4 shapes.
* Bundles of all three kinds trace on a (1, 1) mesh for the 7 archs of the
  reference's ``test_bundles_lower_and_compile``, at smoke size: flops and
  bytes > 0, no collective bytes (every axis has size 1).
* A train step of many microbatches traced at 2 and 3 and extrapolated
  gives the counts of the same step traced whole.
* ``run_cell`` on smoke configs at both production meshes (256 and 512
  fake ranks) writes records that pass the reference's
  ``test_dryrun_artifacts_schema`` checks; serving cells on a mesh are
  ``ok`` with their cache layout, rows and the reference's decode write,
  the quadratic archs' ``long_500k`` cells ``skipped``; every record says
  it was counted with no device.
* The prefill and decode bundles of the smoke granite trace on both
  production meshes (256 and 512 fake ranks), their collectives counted
  by purpose.
* Per-layer gathers on a (4, 1) fake mesh: a narrow dense model whose
  weights outweigh its activations, at 2 and 3 layers; one more layer
  grows the train step's counted peak (remat ``"minimal"`` and
  ``"full"``, 2 microbatches) and the prefill's by less than that layer's
  gathered leaves, as a step holds one layer gathered at a time (a step
  that gathers every leaf for the whole step grows by 2.5 to 4 times
  them: the gathered copy, its gradient and the accumulator); the
  gradients' syncs are counted as ``"grad_scatter"``.  On a (1, 1) mesh the
  step is the one-device step: the same bits after two steps, and the same
  counted bytes and peak (no copy of a leaf).  On the (4, 1) mesh a step
  of 6 microbatches extrapolated from 2 and 3 reads the peak and the
  collective bytes of its whole trace.

A fake process group is global to its process, so everything that builds a
mesh runs in a subprocess of its own (pytest-xdist workers must not share
one).
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ASSIGNED_ARCHS as J_ARCHS  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402


def _import_reference_dryrun():
    """``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when
    it is imported (for its own process); put the variable back, so the
    tests that share this process keep one device."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return dryrun


jdry = _import_reference_dryrun()
from repro_torch.configs import SHAPES, ShapeConfig, TrainConfig, \
    get_config  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLE_ARCHS = ["granite-3-8b", "mixtral-8x7b", "rwkv6-1.6b", "zamba2-7b",
                "deepseek-v2-236b", "seamless-m4t-large-v2", "qwen2-vl-7b"]


@pytest.mark.parametrize("dp", [16, 32])
@pytest.mark.parametrize("arch", J_ARCHS)
def test_production_defaults_match_the_reference(arch, dp):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    for name in J_SHAPES:
        want = jdry.default_train_cfg(jcfg, J_SHAPES[name], dp)
        got = tdry.default_train_cfg(tcfg, SHAPES[name], dp)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert tdry.model_flops_for(tcfg, SHAPES[name]) == \
            jdry.model_flops_for(jcfg, J_SHAPES[name])
    assert dataclasses.asdict(tdry.default_train_cfg(tcfg)) == \
        dataclasses.asdict(jdry.default_train_cfg(jcfg))


def _run(code: str, *args, timeout: float = 600) -> None:
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code, *args], env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]


BUNDLES = """
import json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ShapeConfig, TrainConfig, get_config
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.steps import build_bundle, trace_bundle
shapes = [ShapeConfig("tiny", 32, 2, "train"),
          ShapeConfig("tinyp", 32, 2, "prefill"),
          ShapeConfig("tinyd", 32, 2, "decode")]
out = {}
with fake_world(1):
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    for arch in sys.argv[2].split(","):
        cfg = get_config(arch, smoke=True)
        for shape in shapes:
            b = build_bundle(cfg, shape, mesh,
                             train_cfg=TrainConfig(num_microbatches=2))
            r = trace_bundle(b)
            out[f"{arch}/{shape.kind}"] = {
                "status": b.status, "name": b.name,
                "num_partitions": r["num_partitions"],
                "device": r["device"], **r["per_device"],
                **r["memory"]}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bundles") / "bundles.json")
    _run(BUNDLES, path, ",".join(BUNDLE_ARCHS))
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", BUNDLE_ARCHS)
def test_bundles_trace_on_a_one_rank_mesh(traced, arch):
    kernels = set()
    for kind in ("train", "prefill", "decode"):
        r = traced[f"{arch}/{kind}"]
        assert r["status"] == "ok" and r["name"].startswith(kind)
        assert r["num_partitions"] == 1
        assert r["device"] == "meta (no device)"
        assert r["flops"] > 0 and r["bytes"] > 0
        assert r["collective_operand_bytes"] == 0 == r["by_collective"].get(
            "all-gather", 0)
        assert r["peak_bytes"] >= r["argument_bytes"] > 0
        kernels |= set(r["kernels"])
    # every kernel this arch's paths run was counted as a call
    if arch != "seamless-m4t-large-v2":        # LayerNorms only
        assert "kernel:rmsnorm" in kernels
        assert "kernel:rmsnorm_backward" in kernels
    if arch != "rwkv6-1.6b":                   # no attention to prefill
        assert "kernel:flash_attention" in kernels
    if arch == "zamba2-7b":
        assert {"kernel:ssd_scan", "kernel:ssd_scan_backward"} <= kernels


@pytest.mark.parametrize("arch", ["granite-3-8b", "zamba2-7b"])
def test_microbatches_extrapolate_to_the_whole_trace(arch):
    cfg = get_config(arch, smoke=True)
    shape = ShapeConfig("mb", seq_len=32, global_batch=6, kind="train")
    bundle = tsteps.build_bundle(cfg, shape, None,
                                 train_cfg=TrainConfig(num_microbatches=6))
    whole = tsteps.trace_bundle(bundle, extrapolate_above=99)
    ext = tsteps.trace_bundle(bundle)
    assert ext["trip_counts"] == {"microbatches": 6, "traced": [2, 3]}
    for k in ("flops", "bytes", "elementwise_flops", "transcendentals",
              "operations"):
        assert ext["per_device"][k] == pytest.approx(
            whole["per_device"][k], rel=1e-12), k
    for name, k in whole["per_device"]["kernels"].items():
        assert ext["per_device"]["kernels"][name] == pytest.approx(k)
    assert ext["memory"]["argument_bytes"] == whole["memory"][
        "argument_bytes"]
    assert ext["memory"]["peak_bytes"] == pytest.approx(
        whole["memory"]["peak_bytes"], rel=0.01)


SERVE_MESHES = """
import json, sys
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.steps import build_bundle, trace_bundle
cfg = get_config("granite-3-8b", smoke=True)
out = {}
for multi, n in ((False, 256), (True, 512)):
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        for kind, rows in (("prefill", 32), ("decode", 128), ("decode", 1)):
            b = build_bundle(cfg, ShapeConfig("s", 64, rows, kind), mesh)
            r = trace_bundle(b)
            out[f"{n}/{kind}/{rows}"] = {
                "status": b.status, "serve": b.serve,
                "by_purpose": r["per_device"]["by_purpose"],
                "kernels": r["per_device"]["kernels"],
                "cache_bytes": r["memory"]["cache_bytes"],
                "params_bytes": r["memory"]["params_bytes"]}
json.dump(out, open(sys.argv[1], "w"))
"""


def test_serving_bundles_trace_on_both_production_meshes(tmp_path):
    """The smoke granite (one KV head) served on 256 and 512 fake ranks:
    the cache's slots take "model" (the reference's ``"onehot"`` write),
    32 and 128 rows split over the data-parallel ranks and one row is
    replicated; prefill gathers the params and sums row-parallel outputs,
    decode also merges the partials of its slots; a rank holds a 16th of
    the cache's slots of its rows."""
    path = str(tmp_path / "serve.json")
    _run(SERVE_MESHES, path)
    with open(path) as f:
        out = json.load(f)
    cfg = get_config("granite-3-8b", smoke=True)
    for n in (256, 512):
        dp = n // 16
        for kind, rows in (("prefill", 32), ("decode", 128), ("decode", 1)):
            r = out[f"{n}/{kind}/{rows}"]
            assert r["status"] == "ok"
            serve = r["serve"]
            assert serve["cache_layout"] == "seq"
            assert serve["tp_compute"] == "sharded"
            split = rows % dp == 0
            assert serve["rows"] == ("split" if split else "replicated")
            local = rows // dp if split else rows
            assert serve["rows_per_rank"] == local
            # (k, v) x layers x (local rows, 64 / 16 slots, 1 head, D) bf16
            assert r["cache_bytes"] >= 2 * cfg.num_layers * local * 4 * \
                cfg.head_dim * 2
            assert r["params_bytes"] > 0
            purposes = r["by_purpose"]
            assert purposes["param_gather"] > 0
            assert purposes["model_sum"] > 0
            # its 4 query heads do not divide 16: every rank computes them
            # all, so no query is gathered
            assert "query_gather" not in purposes
            if kind == "decode":
                assert serve["cache_update"] == "onehot"
                assert purposes["partial_merge"] > 0
            else:
                assert "partial_merge" not in purposes
                assert r["kernels"]["kernel:flash_attention"]["calls"] == \
                    cfg.num_layers


CELLS = """
import sys
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import fake_world
out, archs = sys.argv[1], sys.argv[2].split(",")
for multi, n in ((False, 256), (True, 512)):
    with fake_world(n):
        for arch in archs:
            for shape in SHAPES:
                run_cell(arch, shape, multi, out,
                         cfg=get_config(arch, smoke=True))
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    _run(CELLS, out, ",".join(J_ARCHS), timeout=900)
    recs = {}
    for mesh in ("pod16x16", "pod2x16x16"):
        for name in os.listdir(os.path.join(out, mesh)):
            with open(os.path.join(out, mesh, name)) as f:
                r = json.load(f)
            recs[(mesh, r["arch"], r["shape"])] = r
    return recs


@pytest.mark.parametrize("mesh", ["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", J_ARCHS)
def test_dry_run_records_pass_the_reference_schema(records, mesh, arch):
    chips = 512 if mesh == "pod2x16x16" else 256
    for shape in SHAPES:
        r = records[(mesh, arch, shape)]
        assert r["mesh"] == mesh and r["device"] == "meta (no device)"
        assert r["peaks"]["peak_flops"] == 989e12
        assert r["status"] in ("ok", "skipped"), r.get("error")
        if r["status"] != "ok":
            assert r["reason"]
            assert shape == "long_500k"
            continue
        # the reference's test_dryrun_artifacts_schema checks
        roof = r["roofline"]
        for k in ("compute_s", "memory_s", "collective_s", "dominant",
                  "model_flops", "hlo_flops", "useful_flop_ratio",
                  "classification"):
            assert k in roof, (shape, k)
        assert roof["dominant"] in ("compute", "memory", "collective")
        assert roof["classification"]["pattern"]
        assert r["hlo_analysis"]["global"]["flops"] > 0
        assert r["memory_per_device"]["temp_bytes"] >= 0
        # the port's keys
        assert roof["chips"] == r["hlo_analysis"]["num_partitions"] == chips
        assert roof["bound_step_s"] == max(roof["compute_s"],
                                           roof["memory_s"],
                                           roof["collective_s"]) > 0
        assert isinstance(r["fits_80gb"], bool)
        assert r["fits_80gb"] or r["fits_note"]
        assert r["hlo_analysis"]["per_device"]["collective_operand_bytes"] \
            > 0        # the data-parallel exchange, the params' gathers
        # tensor-parallel compute: every family shards under "model" (the
        # smoke configs' vocabulary splits 16 ways; the recurrent ones'
        # heads, 8 or 4, do not, so their mixers compute whole)
        family = get_config(arch).family
        if SHAPES[shape].kind == "train":
            assert r["tp_compute"] == "sharded", (shape, r["tp_compute"])
            assert isinstance(r["tp_whole_leaves"], list)
            assert "serve" not in r
            continue
        # serving: the cache layout, the rows, the reference's decode
        # write; the smoke configs' KV heads (one, or 4 for the others)
        # never divide 16, so an attention cache splits its slots (MLA's
        # latent has no head dimension to split); RWKV6 has none
        serve = r["serve"]
        assert serve["tp_compute"] == "sharded"
        assert serve["cache_layout"] == ("whole" if family == "ssm"
                                         else "seq")
        assert serve["rows"] == ("replicated" if shape == "long_500k"
                                 else "split")
        assert serve["cache_bytes"] > 0 and serve["params_bytes"] > 0
        assert serve["collective_bytes_by_purpose"]["param_gather"] > 0
        if SHAPES[shape].kind == "decode":
            assert serve["cache_update"] == "onehot"
    skipped = [s for s in SHAPES
               if records[(mesh, arch, s)]["status"] == "skipped"]
    assert skipped == ([] if get_config(arch).sub_quadratic
                       else ["long_500k"])


LAYER_GROWTH = """
import dataclasses, json, math, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ShapeConfig, TrainConfig, get_config
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.steps import build_bundle, trace_bundle
from repro_torch.models.params import flatten
out = {}
narrow = dict(d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
              d_ff=1024)
with fake_world(4):
    mesh = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    for n in (2, 3):
        cfg = dataclasses.replace(get_config("lms-demo", smoke=True),
                                  num_layers=n, **narrow)
        cells = [(f"train/{remat}", ShapeConfig("t", 16, 8, "train"),
                  TrainConfig(optimizer="adafactor", beta1=0.0,
                              remat_policy=remat, num_microbatches=2))
                 for remat in ("minimal", "full")]
        cells.append(("prefill", ShapeConfig("p", 16, 8, "prefill"), None))
        for name, shape, tcfg in cells:
            b = build_bundle(cfg, shape, mesh, train_cfg=tcfg)
            r = trace_bundle(b)
            layer = sum(math.prod(s.shape[1:]) * s.dtype.itemsize
                        for k, s in flatten(b.abstract_args[0]).items()
                        if k.startswith("dense_layers/"))
            out[f"{name}/{n}"] = {
                "peak": r["memory"]["peak_bytes"], "layer": layer,
                "by_purpose": r["per_device"]["by_purpose"]}
    # 6 microbatches of a rank's 6 rows, traced whole and extrapolated
    b = build_bundle(cfg, ShapeConfig("t6", 16, 24, "train"), mesh,
                     train_cfg=TrainConfig(num_microbatches=6))
    for name, above in (("whole", 99), ("extrapolated", 3)):
        r = trace_bundle(b, extrapolate_above=above)
        out[f"mb6/{name}"] = {k: r["memory"][k] for k in (
            "peak_bytes", "argument_bytes")}
        out[f"mb6/{name}"]["collective_operand_bytes"] = r["per_device"][
            "collective_operand_bytes"]
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def layer_growth(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("growth") / "growth.json")
    _run(LAYER_GROWTH, path)
    with open(path) as f:
        return json.load(f)


def test_one_more_layer_adds_less_than_its_gathered_leaves(layer_growth):
    out = layer_growth
    for name in ("train/minimal", "train/full", "prefill"):
        two, three = out[f"{name}/2"], out[f"{name}/3"]
        assert three["layer"] == two["layer"] > 0
        growth = three["peak"] - two["peak"]
        assert 0 < growth < three["layer"], (name, growth, three["layer"])
        purposes = three["by_purpose"]
        assert purposes["param_gather"] > 0
        if name.startswith("train"):
            # the loss's label count, the metrics and the norms are left
            assert purposes["grad_scatter"] > 100 * purposes["other"]
        else:
            assert set(purposes) == {"param_gather"}


def test_microbatches_extrapolate_on_a_mesh(layer_growth):
    """With the gradient accumulator a piece, a step of 6 microbatches
    traced at 2 and 3 and extrapolated reads the whole trace's peak and
    its collective bytes (each microbatch gathers and syncs anew)."""
    whole, ext = layer_growth["mb6/whole"], layer_growth["mb6/extrapolated"]
    assert ext["argument_bytes"] == whole["argument_bytes"]
    assert ext["peak_bytes"] == pytest.approx(whole["peak_bytes"], rel=0.01)
    assert ext["collective_operand_bytes"] == pytest.approx(
        whole["collective_operand_bytes"], rel=1e-9)


ONE_RANK = """
import json, sys, torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import TrainConfig, get_config
from repro_torch.launch.cost_analysis import analyze_step
from repro_torch.launch.mesh import fake_world
from repro_torch.models.params import flatten
from repro_torch.models.transformer import init_model_params
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import shard_tree, tp_roles
from repro_torch.train import step as tstep
cfg = get_config("lms-demo", smoke=True)
tcfg = TrainConfig(num_microbatches=2, remat_policy="minimal",
                   warmup_steps=1, learning_rate=3e-3)
g = torch.Generator().manual_seed(0)
toks = torch.randint(1, cfg.vocab_size, (2, 4, 17), generator=g)
batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]
out = {}
with fake_world(1):
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    runs = {}
    for name, m in (("one", None), ("mesh", mesh)):
        params = init_model_params(cfg, seed=0, device="cpu")
        fn, opt = tstep.make_train_step(cfg, tcfg, mesh=m)
        psh = None
        if m is not None:
            psh, _ = tstep.shardings(cfg, tcfg, m)
            pieces = shard_tree(params, psh, m)
            roles = tp_roles(cfg, tstep.TRAIN_RULES, m)
            out["no_copy"] = all(
                comm.gather_piece(v, sh, m, roles[k]) is v is flatten(
                    params)[k] for (k, v), sh in zip(
                        flatten(pieces).items(), flatten(psh).values()))
            params = pieces
        state = opt.init(params, psh)
        counted = analyze_step(fn, (params, state, batches[0], 0))
        out[name] = {k: counted["memory"][k] for k in ("peak_bytes",
                                                         "temp_bytes")}
        out[name]["bytes"] = counted["per_device"]["bytes"]
        metrics = []
        for i, b in enumerate(batches):
            params, state, mt = fn(params, state, b, i)
            metrics.append({k: float(v) for k, v in mt.items()})
        runs[name] = params
        out[name]["metrics"] = metrics
    out["bit_equal"] = all(torch.equal(a, b) for a, b in zip(
        flatten(runs["one"]).values(), flatten(runs["mesh"]).values()))
json.dump(out, open(sys.argv[1], "w"))
"""


def test_a_one_rank_mesh_step_is_the_one_device_step(tmp_path):
    path = str(tmp_path / "one.json")
    _run(ONE_RANK, path)
    with open(path) as f:
        out = json.load(f)
    assert out["no_copy"] and out["bit_equal"]
    assert out["mesh"]["metrics"] == out["one"]["metrics"]
    for k in ("peak_bytes", "temp_bytes", "bytes"):
        assert out["mesh"][k] == out["one"][k], k
