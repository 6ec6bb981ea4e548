"""Expert-parallel MoE compute and the VLM under tensor parallelism over
"model", vs the JAX package, over gloo ranks on the CPU.

* ``tp_roles`` pinned for the MoE and the VLM: mixtral's expert stacks are
  ``"split"`` on their ``mlp`` dimension on the reference's (16, 16) and
  (2, 16, 16) meshes (8 experts on 16 ranks: the hidden columns take
  "model") and on their ``experts`` dimension on (1, 2); its router is
  ``"whole"`` wherever its ``experts`` dimension binds "model"; a shared
  expert follows the MLP's rule; qwen2-vl's text stack is split where the
  reference binds "model" (its 28 heads on 16 fall back: attention whole).
* The mesh step against the reference's single-device step on the same
  global batches (three steps, AdamW; ``STEP_TOL``: the loss, grad norm,
  param norm, lr and MoE statistics of every step and every rank's pieces
  of the updated params), each piece also held to the port's own
  one-device step at ``STEP_TOL``: the mixtral smoke model in fp32 (4
  experts, capacity factor 4: nothing drops) on (1, 2) with the experts
  split; 6 experts and one shared expert on (1, 4), so the experts' and the
  shared expert's hidden columns split; the same 6 experts on (1, 2) under
  ``TRAIN_RULES.with_overrides(experts=None)`` with ``seq_parallel`` (the
  hidden-column binding chosen by the rules, which the step now stores and
  computes alike); the qwen2-vl smoke model (fp32) with patches over
  tokens 1-8 and grid M-RoPE positions on (1, 2) with ``seq_parallel`` (S
  = 16: the patches span both ranks' rows) and on (2, 2).  The all-to-all
  dispatch (``impl="a2a"``) on (2, 2), with this rank's experts as they
  are stored, against the reference's a2a step (``impl="a2a"``, its
  ``shard_map`` dispatch) on a (2, 2) mesh of 4 host devices in a process
  of its own (its aux loss is e * the sum of the squared mean
  probabilities, which the grouped single-device reference does not
  compute): every metric and piece at STEP_TOL; and, besides, against the
  port's same dispatch on (4, 1), where "model" splits nothing; the
  dispatch counter shows a2a ran twice a MoE layer a step (the forward
  and its remat re-run) in both.
* Under a split binding no expert stack is gathered over "model": each
  computed leaf has its piece's shape, and the only leaf gathered over
  "model" is the router.  On (1, 2) and (1, 4) every "model" rank routed
  the same tokens to the same experts: the ranks' expert counts and MoE
  statistics agree.
* Mutation: with the gates' gradient sum over "model" dropped (the MoE
  layer's ``copy_to_model`` the identity), the experts-split and the
  hidden-split runs miss the reference.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_ranks  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.transformer import model_specs as jmodel_specs  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.models.transformer import model_specs  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from test_torch_dist import _jmesh  # noqa: E402
from test_torch_dist_step import (  # noqa: E402
    BASE, STEP_TOL, _batches, _check_metrics, _flat_np)
from test_torch_moe import _numpy_params  # noqa: E402
from test_torch_vlm import grid_positions  # noqa: E402

STEPS = 3
S = 16
M12 = (("data", "model"), (1, 2))
M22 = (("data", "model"), (2, 2))
M14 = (("data", "model"), (1, 4))
M41 = (("data", "model"), (4, 1))
ADAMW = dict(optimizer="adamw")
SP = dict(ADAMW, seq_parallel=True)
HIDDEN = {"experts": None}
FP32 = {"dtype": "float32"}
SHARED6 = {"num_experts": 6, "num_shared_experts": 1, "d_ff_shared": 64}
# the reference runs: (model, cfg overrides, moe overrides, extras)
REFS = {
    "mix": ("mixtral-8x7b", FP32, {}, False),
    "mix6": ("mixtral-8x7b", FP32, SHARED6, False),
    "vlm": ("qwen2-vl-7b", FP32, {}, True),
}
# name: (reference, mesh, train config, ranks, rule overrides, moe overrides
# of the run alone, mutation)
RUNS = {
    "mix-m12": ("mix", M12, ADAMW, 2, {}, {}, None),
    "mix6-m12-rules-sp": ("mix6", M12, SP, 2, HIDDEN, {}, None),
    "vlm-m12-sp": ("vlm", M12, SP, 2, {}, {}, None),
    "mix-m12-no-gate-sum": ("mix", M12, ADAMW, 2, {}, {}, "gate_sum"),
    "mix6-m14": ("mix6", M14, ADAMW, 4, {}, {}, None),
    "mix-m22-a2a": ("mix", M22, ADAMW, 4, {}, {"impl": "a2a"}, None),
    "mix-m41-a2a": ("mix", M41, ADAMW, 4, {}, {"impl": "a2a"}, None),
    "vlm-m22": ("vlm", M22, ADAMW, 4, {}, {}, None),
    "mix6-m14-no-gate-sum": ("mix6", M14, ADAMW, 4, {}, {}, "gate_sum"),
}
HELD = [n for n, r in RUNS.items() if r[6] is None and not r[5]]
MUTANTS = [n for n, r in RUNS.items() if r[6]]
PROBED = ("mix-m12", "mix6-m14", "mix6-m12-rules-sp", "mix-m22-a2a")
B = 8


def _cfgs(model, cfg, moe):
    jc = dataclasses.replace(jget_config(model, smoke=True), **cfg)
    tc = dataclasses.replace(get_config(model, smoke=True), **cfg)
    if moe:
        jc.moe = dataclasses.replace(jc.moe, **moe)
        tc.moe = dataclasses.replace(tc.moe, **moe)
    return jc, tc


def _vlm_extras(tc, seed):
    """Patches over tokens 1-8 (the smoke image of 2 x 4) and grid M-RoPE
    positions, a batch's worth for each step."""
    rng = np.random.default_rng(seed)
    text = S - 1 - tc.vlm_num_patches
    out = {}
    for i in range(STEPS):
        out[f"patches{i}"] = (0.5 * rng.standard_normal(
            (B, tc.vlm_num_patches, tc.d_model))).astype(np.float32)
        out[f"mrope_pos{i}"] = grid_positions(B, 2, 4, text)
    return out


def _keys(batches) -> list:
    return sorted({k.rstrip("0123456789") for k in batches})


def _reference(jc, tcfg: dict, pn, batches):
    """The reference's single-device step on the global batches (with
    their extras): each step's metrics and the params after the last."""
    jcfg = jbase.TrainConfig(**BASE, **tcfg)
    fn = jax.jit(jstep.make_train_step(jc, jcfg)[0])
    params = jax.tree.map(jnp.asarray, pn)
    state = joptim.get_optimizer(jcfg).init(params)
    metrics = []
    for i in range(STEPS):
        batch = {k: jnp.asarray(batches[f"{k}{i}"]) for k in _keys(batches)}
        params, state, m = fn(params, state, batch, i)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _flat_np(params)


# the reference's a2a step on a (2, 2) mesh of forced host devices: JAX
# fixes its device count when it starts, so it runs in a process of its own
_A2A_REFERENCE = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import base, get_config
from repro.parallel import sharding
from repro.train import optim, step

d, steps, tcfg = sys.argv[1], int(sys.argv[2]), eval(sys.argv[3])
cfg = dataclasses.replace(get_config("mixtral-8x7b", smoke=True),
                          dtype="float32")
cfg.moe = dataclasses.replace(cfg.moe, impl="a2a")
params = {}
for k, v in np.load(f"{d}/mix_params.npz").items():
    node = params
    for part in k.split("/")[:-1]:
        node = node.setdefault(part, {})
    node[k.split("/")[-1]] = jnp.asarray(v)
batches = np.load(f"{d}/mix_batches.npz")
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
jcfg = base.TrainConfig(**tcfg)
fn = jax.jit(step.make_train_step(
    cfg, jcfg, pc=sharding.PartitionConstraints(sharding.TRAIN_RULES, mesh),
    mesh=mesh)[0])
state = optim.get_optimizer(jcfg).init(params)
out = {}
with mesh:
    for i in range(steps):
        batch = {k: jnp.asarray(batches[f"{k}{i}"])
                 for k in ("tokens", "labels")}
        params, state, m = fn(params, state, batch, i)
        for k, v in m.items():
            out.setdefault(f"m/{k}", []).append(float(v))
    # the step exchanges tokens by all-to-all (the a2a dispatch ran)
    out["all_to_all"] = "all-to-all" in fn.lower(
        params, state, batch, 0).compile().as_text()

def walk(t, pre):
    for k, v in t.items():
        if isinstance(v, dict):
            walk(v, f"{pre}{k}/")
        else:
            out[f"p/{pre}{k}"] = np.asarray(v, np.float32)

walk(params, "")
np.savez(f"{d}/mix_a2a_reference.npz", **out)
"""


def _start_a2a_reference(d, tcfg: dict):
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
                   [torch_dist_ranks.SRC, os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_A2A_REFERENCE), str(d),
         str(STEPS), repr(tcfg)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _one_device(tc, tcfg: dict, pn, batches) -> dict:
    """The port's one-device step from the same params and global
    batches: the params after the last step, flat numpy."""
    params = params_from_numpy(_flat_np(pn), tc, device="cpu")
    fn, opt = tstep.make_train_step(tc, TrainConfig(**BASE, **tcfg))
    state = opt.init(params)
    for i in range(STEPS):
        batch = tstep.batch_to_device(
            {k: batches[f"{k}{i}"] for k in _keys(batches)}, "cpu")
        params, state, _ = fn(params, state, batch, i)
    return {k: v.detach().numpy() for k, v in flatten(params).items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_moe")
    cfgs, inputs = {}, {}
    for i, (ref, (model, cfg, moe, extras)) in enumerate(REFS.items()):
        jc, tc = _cfgs(model, cfg, moe)
        pn = _numpy_params(jmodel_specs(jc))
        np.savez(d / f"{ref}_params.npz", **_flat_np(pn))
        batches = _batches(tc.vocab_size, 20 + i, STEPS, S)
        if extras:
            batches.update(_vlm_extras(tc, 30 + i))
        np.savez(d / f"{ref}_batches.npz", **batches)
        cfgs[ref] = tc
        inputs[ref] = (jc, pn, batches)
    runs = {2: [], 4: []}
    for name, (ref, (names, shape), tcfg, ranks, rules, moe, mutate) in \
            RUNS.items():
        model, cfg, ref_moe, _ = REFS[ref]
        runs[ranks].append({
            "name": name, "model": model, "cfg": cfg,
            "moe": {**ref_moe, **moe}, "names": names, "shape": shape,
            "tcfg": {**BASE, **tcfg}, "steps": STEPS, "rules": rules,
            "params": f"{ref}_params.npz", "batches": f"{ref}_batches.npz",
            "probe": name in PROBED, "mutate": mutate})
    a2a = _start_a2a_reference(d, {**BASE, **ADAMW})
    two = torch_dist_ranks.launch("tp", 2, str(d), {"runs": runs[2]})
    four = torch_dist_ranks.launch("tp", 4, str(d), {"runs": runs[4]})
    # the references, while nothing else runs
    want = {ref: _reference(jc, ADAMW, pn, b)
            for ref, (jc, pn, b) in inputs.items()}
    one = {ref: _one_device(cfgs[ref], ADAMW, pn, b)
           for ref, (jc, pn, b) in inputs.items()}
    log, _ = a2a.communicate(timeout=600)
    assert a2a.returncode == 0, log[-4000:]
    ref_a2a = dict(np.load(d / "mix_a2a_reference.npz"))
    assert ref_a2a.pop("all_to_all")
    return {"out": {2: two, 4: four}, "want": want, "one": one,
            "cfgs": cfgs, "a2a": (
                [{k[2:]: float(v[i]) for k, v in ref_a2a.items()
                  if k.startswith("m/")} for i in range(STEPS)],
                {k[2:]: v for k, v in ref_a2a.items()
                 if k.startswith("p/")})}


def _sub(out, name) -> dict:
    return {k[len(name) + 1:]: v for k, v in out.items()
            if k.startswith(f"{name}/")}


def _rules(name):
    return tsh.TRAIN_RULES.with_overrides(**RUNS[name][4])


def _misses(out, name, cfg, want, tol) -> list:
    """The leaves whose piece misses ``want`` (whole leaves, sliced by the
    run's binding) beyond ``tol``, relative and absolute."""
    names, shape = RUNS[name][1]
    sizes = dict(zip(names, shape))
    coord = dict(zip(names, out[f"{name}/coord"].tolist()))
    bad = []
    for k, sh in flatten(tsh.shardings_for_specs(
            model_specs(cfg), _rules(name), sizes)).items():
        got = out[f"{name}/p/{k}"]
        assert got.shape == sh.local_shape(), k
        ref = want[k][sh.slices(coord)]
        if not np.allclose(got, ref, rtol=tol, atol=tol):
            bad.append(k)
    return bad


# -- roles ------------------------------------------------------------------


def _binds_model(pspec) -> bool:
    return any("model" in (e if isinstance(e, tuple) else (e,))
               for e in pspec if e is not None)


@pytest.mark.parametrize("mesh", [(("data", "model"), (16, 16)),
                                  (("pod", "data", "model"), (2, 16, 16))],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen2-vl-7b"])
def test_moe_and_vlm_roles_follow_the_reference_binding(arch, mesh):
    names, shape = mesh
    sizes = dict(zip(names, shape))
    jm = _jmesh(names, shape)
    cfg = get_config(arch)
    jspecs = flatten(jmodel_specs(jget_config(arch)))
    roles = tsh.tp_roles(cfg, tsh.TRAIN_RULES, sizes)
    assert "split" in roles.values()
    for k, role in roles.items():
        binds = _binds_model(jsh.logical_to_pspec(
            jspecs[k].axes, jspecs[k].shape, jsh.TRAIN_RULES, jm))
        if k.endswith("/moe/router"):
            assert role == "whole", k
        elif role == "split":
            assert binds, k
        else:
            assert not binds, (k, role)
    tp = tsh.TensorParallel(sizes, tsh.TRAIN_RULES, 16, 0, False)
    if arch == "mixtral-8x7b":
        specs = flatten(model_specs(cfg))
        for w in ("w_gate", "w_up", "w_down"):
            k = f"moe_layers/moe/{w}"
            assert roles[k] == "split", k
            # 8 experts on 16: the hidden columns take "model"
            assert tp.split_dim(specs[k]) == specs[k].axes.index("mlp"), k
    else:
        assert roles["dense_layers/attn/wq"] == "whole"      # 28 heads
        assert roles["dense_layers/mlp/w_up"] == "split"
        assert roles["embed/embedding"] == "split"


def test_moe_roles_on_small_meshes():
    mix = get_config("mixtral-8x7b", smoke=True)             # 4 experts
    specs = flatten(model_specs(mix))
    m12 = {"data": 1, "model": 2}
    roles = tsh.tp_roles(mix, tsh.TRAIN_RULES, m12)
    tp = tsh.TensorParallel(m12, tsh.TRAIN_RULES, 2, 0, False)
    for w in ("w_gate", "w_up", "w_down"):
        k = f"moe_layers/moe/{w}"
        assert roles[k] == "split", k
        assert tp.split_dim(specs[k]) == specs[k].axes.index("experts"), k
    # the router's experts dimension binds "model"; it stays whole
    assert tsh.binds_model(specs["moe_layers/moe/router"], tsh.TRAIN_RULES,
                           m12)
    assert roles["moe_layers/moe/router"] == "whole"
    hidden = tsh.TRAIN_RULES.with_overrides(experts=None)
    tph = tsh.TensorParallel(m12, hidden, 2, 0, False)
    w_down = specs["moe_layers/moe/w_down"]
    assert tph.split_dim(w_down) == w_down.axes.index("mlp")
    assert tsh.tp_roles(mix, hidden, m12)["moe_layers/moe/router"] == \
        "whole"
    six = get_config("mixtral-8x7b", smoke=True)
    six.moe = dataclasses.replace(six.moe, **SHARED6)
    r6 = tsh.tp_roles(six, tsh.TRAIN_RULES, {"data": 1, "model": 4})
    for k in ("w_gate", "w_down", "shared/w_gate", "shared/w_up",
              "shared/w_down"):
        assert r6[f"moe_layers/moe/{k}"] == "split", k
    # every MoE leaf whole where nothing splits (one "model" rank)
    assert set(tsh.tp_roles(mix, tsh.TRAIN_RULES,
                            {"data": 2, "model": 1}).values()) == {"whole"}


# -- the mesh step against the reference's single-device step ---------------


@pytest.mark.parametrize("name", HELD)
def test_tp_moe_step_matches_the_reference(world, name):
    ref, _, _, ranks, _, _, _ = RUNS[name]
    metrics, last = world["want"][ref]
    cfg = world["cfgs"][ref]
    held = 0
    for out in world["out"][ranks]:
        _check_metrics(_sub(out, name), metrics, STEP_TOL,
                       cfg.moe is not None)
        assert _misses(out, name, cfg, world["one"][ref], STEP_TOL) == []
        assert _misses(out, name, cfg, last, STEP_TOL) == []
        held += sum(v.size for k, v in out.items()
                    if k.startswith(f"{name}/p/"))
    assert held >= sum(v.size for v in last.values())


def _assemble(outs, name, cfg) -> dict:
    """The whole leaves of a run, put together from every rank's pieces."""
    names, shape = RUNS[name][1]
    sizes = dict(zip(names, shape))
    whole = {}
    for k, sh in flatten(tsh.shardings_for_specs(
            model_specs(cfg), _rules(name), sizes)).items():
        whole[k] = np.zeros(sh.shape, np.float32)
        for out in outs:
            coord = dict(zip(names, out[f"{name}/coord"].tolist()))
            whole[k][sh.slices(coord)] = out[f"{name}/p/{k}"]
    return whole


def test_a2a_dispatch_runs_under_tensor_parallelism(world):
    """The all-to-all dispatch with this rank's experts as stored, on (2,
    2), against the reference's a2a step on a (2, 2) mesh (every metric of
    every step and every piece of the updated params, STEP_TOL), and
    against the port's same dispatch on (4, 1), where no "model" axis
    splits anything (its stacks whole): the same function of the global
    batch.  Its step-0 cross-entropy is also the grouped reference's."""
    cfg = world["cfgs"]["mix"]
    metrics, _ = world["want"]["mix"]
    ref_metrics, ref_last = world["a2a"]
    layers = cfg.num_layers - cfg.moe.num_dense_layers
    outs = world["out"][4]
    dp = _assemble(outs, "mix-m41-a2a", cfg)
    for out in outs:
        tp, flat = _sub(out, "mix-m22-a2a"), _sub(out, "mix-m41-a2a")
        # each MoE layer dispatches in the forward and again in its remat
        for run in (tp, flat):
            assert run["dispatches"].tolist() == [0, 2 * layers * STEPS]
        _check_metrics(tp, ref_metrics, STEP_TOL, True)
        np.testing.assert_allclose(tp["m/loss"][0], metrics[0]["loss"],
                                   rtol=STEP_TOL, atol=STEP_TOL)
        for k in ("loss", "grad_norm", "param_norm", "moe_aux_loss",
                  "moe_dropped_frac", "moe_max_load"):
            np.testing.assert_allclose(tp[f"m/{k}"], flat[f"m/{k}"],
                                       rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=k)
    for out in outs:
        assert _misses(out, "mix-m22-a2a", cfg, ref_last, STEP_TOL) == []
        assert _misses(out, "mix-m22-a2a", cfg, dp, STEP_TOL) == []


@pytest.mark.parametrize("name", PROBED)
def test_no_expert_stack_is_gathered_over_model(world, name):
    ref, (names, shape), tcfg, ranks, _, _, _ = RUNS[name]
    cfg = world["cfgs"][ref]
    sizes = dict(zip(names, shape))
    rules = _rules(name)
    roles = tsh.tp_roles(cfg, rules, sizes, tcfg.get("seq_parallel", False))
    shardings = flatten(tsh.shardings_for_specs(model_specs(cfg), rules,
                                                sizes))
    router = shardings["moe_layers/moe/router"].shape
    for k in ("w_gate", "w_up", "w_down"):
        assert roles[f"moe_layers/moe/{k}"] == "split", k
    for out in world["out"][ranks]:
        for k, sh in shardings.items():
            want = list(sh.shape)
            if roles[k] == "split":
                for i in range(len(want)):
                    if "model" in sh.dim_axes(i):
                        want[i] //= sizes["model"]
            assert tuple(out[f"{name}/local/{k}"]) == tuple(want), k
        gathered = {tuple(r) for r in out[f"{name}/model_leaf_gathers"]}
        assert gathered <= {tuple(router)}, gathered
        # activations: along the sequence (dim 1), or the a2a dispatch's
        # flattened tokens (dim 0)
        dims = set(out[f"{name}/model_gather_dims"].tolist())
        assert dims <= ({0, 1} if name.endswith("a2a") else {1}), dims


def test_model_ranks_route_alike(world):
    """The ranks of one "data" coordinate route the same tokens the same
    way: over each step's routing calls (forward and remat re-run) their
    expert counts are equal, as are their MoE statistics (expert loads,
    drops, aux loss), step by step."""
    for name in ("mix-m12", "mix6-m12-rules-sp", "mix6-m14"):
        outs = world["out"][RUNS[name][3]]
        counts = outs[0][f"{name}/expert_counts"]
        assert counts.sum() > 0
        for out in outs[1:]:
            np.testing.assert_array_equal(out[f"{name}/expert_counts"],
                                          counts, err_msg=name)
            for k in ("m/moe_max_load", "m/moe_aux_loss",
                      "m/moe_dropped_frac"):
                np.testing.assert_array_equal(out[f"{name}/{k}"],
                                              outs[0][f"{name}/{k}"],
                                              err_msg=(name, k))


@pytest.mark.parametrize("name", MUTANTS)
def test_dropping_the_gates_sum_misses_the_reference(world, name):
    ref, _, _, ranks, _, _, _ = RUNS[name]
    cfg = world["cfgs"][ref]
    _, last = world["want"][ref]
    missed = [_misses(out, name, cfg, last, STEP_TOL)
              for out in world["out"][ranks]]
    assert any("moe_layers/moe/router" in m for m in missed), missed
