"""Tensor-parallel compute for MLA (deepseek-v2) and the encoder-decoder
(seamless) under "model", vs the JAX package, over gloo ranks on the CPU.

* ``tp_roles`` for deepseek-v2-236b and seamless-m4t-large-v2 on the
  reference's (16, 16) and (2, 16, 16) meshes, with and without sequence
  parallelism: ``"split"`` exactly where the reference's
  ``logical_to_pspec`` binds "model"; MLA's ``wq_a``, ``q_norm``,
  ``wkv_a`` and ``kv_norm`` (never bound) ``"partial"`` (each rank computes
  them whole for its own heads), the router ``"whole"``, the norms
  (``ln_cross`` and the encoder's included) ``"partial"`` only under
  sequence parallelism.
* The mesh step against the reference's single-device step on the same
  global batches (three steps, AdamW, ``STEP_TOL``: the loss, grad norm,
  param norm, lr (and MoE statistics) of every step and every rank's
  pieces of the updated params), each piece also held to the port's own
  one-device step: the deepseek smoke model in fp32 (MLA, its dense layer
  0 and a MoE layer with 2 shared experts) on (1, 2) with
  ``seq_parallel`` and on (2, 2); the seamless smoke model in fp32 with
  ``src_frames`` (32 frames, 16 tokens) on (1, 2) with ``seq_parallel``
  (the frames and the tokens both split) and on (1, 4) (one head a rank);
  and the fallbacks to the layout without sequence parallelism: deepseek
  on a sequence of 15, and seamless on 31 frames (its 16 tokens divide,
  but one layout holds for the whole pass).
* No split leaf is gathered over "model": each computed leaf has its
  piece's shape, and every exchange over "model" is an activation's, along
  the sequence (the MoE router, whole, excepted).
* Mutations: with ``wkv_a``'s gradient sum over "model" dropped (its role
  ``"whole"``), the deepseek run misses the reference at ``wkv_a``; with
  either sinusoidal position encoding not offset to a sequence-parallel
  rank's rows (the encoder's frames or the decoder's tokens), the seamless
  run misses it.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_ranks  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.transformer import model_specs as jmodel_specs  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.models.transformer import model_specs  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from test_torch_dist import _jmesh  # noqa: E402
from test_torch_dist_step import (  # noqa: E402
    BASE, STEP_TOL, _batches, _check_metrics, _flat_np)
from test_torch_moe import _numpy_params  # noqa: E402
from test_torch_tp_moe import (  # noqa: E402
    _binds_model, _one_device, _reference, _sub)

STEPS = 3
B = 8
M12 = (("data", "model"), (1, 2))
M22 = (("data", "model"), (2, 2))
M14 = (("data", "model"), (1, 4))
ADAMW = dict(optimizer="adamw")
SP = dict(ADAMW, seq_parallel=True)
FP32 = {"dtype": "float32"}
MLA, ENCDEC = "deepseek-v2-236b", "seamless-m4t-large-v2"
# the reference runs: (model, tokens a row, source frames a row)
REFS = {
    "mla": (MLA, 16, None),
    "mla-odd": (MLA, 15, None),
    "encdec": (ENCDEC, 16, 32),
    "encdec-odd": (ENCDEC, 16, 31),
}
# name: (reference, mesh, train config, ranks, mutation)
RUNS = {
    "mla-m12-sp": ("mla", M12, SP, 2, None),
    "mla-m12-sp-odd": ("mla-odd", M12, SP, 2, None),
    "encdec-m12-sp": ("encdec", M12, SP, 2, None),
    "encdec-m12-sp-odd": ("encdec-odd", M12, SP, 2, None),
    "mla-m12-no-wkv-a-sum": ("mla", M12, ADAMW, 2,
                             "no_partial_sum:wkv_a"),
    "encdec-m12-sp-no-enc-offset": ("encdec", M12, SP, 2, "no_offset:32"),
    "encdec-m12-sp-no-dec-offset": ("encdec", M12, SP, 2, "no_offset:16"),
    "mla-m22": ("mla", M22, ADAMW, 4, None),
    "encdec-m14": ("encdec", M14, ADAMW, 4, None),
}
HELD = [n for n, r in RUNS.items() if r[4] is None]
PROBED = ("mla-m12-sp", "mla-m22", "encdec-m12-sp", "encdec-m14")


def _cfgs(model):
    return (dataclasses.replace(jget_config(model, smoke=True), **FP32),
            dataclasses.replace(get_config(model, smoke=True), **FP32))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_mla_encdec")
    cfgs, inputs = {}, {}
    for i, (ref, (model, s, frames)) in enumerate(REFS.items()):
        jc, tc = _cfgs(model)
        pn = _numpy_params(jmodel_specs(jc), seed=i)
        np.savez(d / f"{ref}_params.npz", **_flat_np(pn))
        batches = _batches(tc.vocab_size, 50 + i, STEPS, s)
        if frames:
            rng = np.random.default_rng(60 + i)
            batches.update({f"src_frames{j}": rng.standard_normal(
                (B, frames, tc.d_model)).astype(np.float32)
                for j in range(STEPS)})
        np.savez(d / f"{ref}_batches.npz", **batches)
        cfgs[ref] = tc
        inputs[ref] = (jc, pn, batches)
    runs = {2: [], 4: []}
    for name, (ref, (names, shape), tcfg, ranks, mutate) in RUNS.items():
        runs[ranks].append({
            "name": name, "model": REFS[ref][0], "cfg": FP32,
            "names": names, "shape": shape, "tcfg": {**BASE, **tcfg},
            "steps": STEPS, "params": f"{ref}_params.npz",
            "batches": f"{ref}_batches.npz", "probe": name in PROBED,
            "mutate": mutate})
    two = torch_dist_ranks.launch("tp", 2, str(d), {"runs": runs[2]})
    four = torch_dist_ranks.launch("tp", 4, str(d), {"runs": runs[4]})
    # the references, while nothing else runs
    want = {ref: _reference(jc, ADAMW, pn, b)
            for ref, (jc, pn, b) in inputs.items()}
    one = {ref: _one_device(cfgs[ref], ADAMW, pn, b)
           for ref, (jc, pn, b) in inputs.items()}
    return {"out": {2: two, 4: four}, "want": want, "one": one,
            "cfgs": cfgs}


def _misses(out, name, cfg, want, tol=STEP_TOL) -> list:
    """The leaves whose piece misses ``want`` (whole leaves, sliced by the
    run's binding) beyond ``tol``, relative and absolute."""
    names, shape = RUNS[name][1]
    sizes = dict(zip(names, shape))
    coord = dict(zip(names, out[f"{name}/coord"].tolist()))
    bad = []
    for k, sh in flatten(tsh.shardings_for_specs(
            model_specs(cfg), tsh.TRAIN_RULES, sizes)).items():
        got = out[f"{name}/p/{k}"]
        assert got.shape == sh.local_shape(), k
        if not np.allclose(got, want[k][sh.slices(coord)], rtol=tol,
                           atol=tol):
            bad.append(k)
    return bad


# -- roles ------------------------------------------------------------------


@pytest.mark.parametrize("sp", [False, True], ids=["no-sp", "sp"])
@pytest.mark.parametrize("mesh", [(("data", "model"), (16, 16)),
                                  (("pod", "data", "model"), (2, 16, 16))],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", [MLA, ENCDEC])
def test_roles_follow_the_reference_binding(arch, mesh, sp):
    names, shape = mesh
    sizes = dict(zip(names, shape))
    jm = _jmesh(names, shape)
    cfg = get_config(arch)
    jspecs = flatten(jmodel_specs(jget_config(arch)))
    roles = tsh.tp_roles(cfg, tsh.TRAIN_RULES, sizes, sp)
    assert "split" in roles.values()
    assert set(roles) == set(jspecs)
    for k, role in roles.items():
        binds = _binds_model(jsh.logical_to_pspec(
            jspecs[k].axes, jspecs[k].shape, jsh.TRAIN_RULES, jm))
        leaf, parent = k.split("/")[-1], k.split("/")[-2]
        if k.endswith("/moe/router"):
            assert role == "whole", k
        elif leaf in ("wq_a", "q_norm", "wkv_a", "kv_norm"):
            assert not binds and role == "partial", (k, role)
        elif parent in ("ln1", "ln2", "ln_cross", "final_norm"):
            assert role == ("partial" if sp else "whole"), (k, role)
        else:
            assert role == ("split" if binds else "whole"), (k, role, binds)
    if arch == MLA:
        for k in ("wq_b", "wkv_b", "wo"):
            assert roles[f"moe_layers/attn/{k}"] == "split", k
        for k in ("mlp/w_up", "mlp/w_down"):       # d_ff_dense 12288
            assert roles[f"dense_layers/{k}"] == "split", k
        for k in ("w_gate", "shared/w_up", "shared/w_down"):
            assert roles[f"moe_layers/moe/{k}"] == "split", k
    else:
        for k in ("cross/wq", "cross/wk", "cross/wv", "cross/wo",
                  "attn/wk", "mlp/w_up"):
            assert roles[f"dec_layers/{k}"] == "split", k
        assert roles["encoder/layers/attn/wq"] == "split"
        assert roles["encoder/final_norm/scale"] == (
            "partial" if sp else "whole")


def test_mla_latent_leaves_stay_whole_without_a_head_split():
    """Where the heads do not split (one "model" rank, or heads that do
    not divide) MLA's latent leaves are whole, not partial; the layouts
    the runs below rely on."""
    cfg = get_config(MLA, smoke=True)
    assert set(tsh.tp_roles(cfg, tsh.TRAIN_RULES,
                            {"data": 2, "model": 1}).values()) == {"whole"}
    odd = dataclasses.replace(cfg, num_heads=6)
    roles = tsh.tp_roles(odd, tsh.TRAIN_RULES, {"data": 1, "model": 4})
    for k in ("wq_a", "q_norm", "wkv_a", "kv_norm", "wq_b", "wo"):
        assert roles[f"moe_layers/attn/{k}"] == "whole", k
    pc = tsh.PartitionConstraints(tsh.TRAIN_RULES, {"data": 1, "model": 2},
                                  seq_parallel=True)
    enc = get_config(ENCDEC, smoke=True)
    assert pc.sp_pass(enc, 16, 32) and not pc.sp_pass(enc, 16, 31)
    assert not pc.sp_pass(cfg, 15) and pc.sp_pass(cfg, 16, 31)
    # an encoder-decoder on (1, 4) splits its 4 KV heads a rank each
    m14 = tsh.tp_roles(enc, tsh.TRAIN_RULES, {"data": 1, "model": 4})
    assert m14["dec_layers/cross/wk"] == "split"


# -- the mesh step against the reference's single-device step ---------------


@pytest.mark.parametrize("name", HELD)
def test_tp_step_matches_the_reference(world, name):
    ref, _, _, ranks, _ = RUNS[name]
    metrics, last = world["want"][ref]
    cfg = world["cfgs"][ref]
    held = 0
    for out in world["out"][ranks]:
        _check_metrics(_sub(out, name), metrics, STEP_TOL,
                       cfg.moe is not None)
        assert _misses(out, name, cfg, world["one"][ref]) == []
        assert _misses(out, name, cfg, last) == []
        held += sum(v.size for k, v in out.items()
                    if k.startswith(f"{name}/p/"))
    assert held >= sum(v.size for v in last.values())


@pytest.mark.parametrize("name", PROBED)
def test_no_split_leaf_is_gathered_over_model(world, name):
    ref, (names, shape), tcfg, ranks, _ = RUNS[name]
    cfg = world["cfgs"][ref]
    sizes = dict(zip(names, shape))
    frames = REFS[ref][2]
    pc = tsh.PartitionConstraints(tsh.TRAIN_RULES, sizes,
                                  seq_parallel=tcfg.get("seq_parallel",
                                                        False))
    roles = tsh.tp_roles(cfg, tsh.TRAIN_RULES, sizes,
                         pc.sp_pass(cfg, REFS[ref][1], frames))
    shardings = flatten(tsh.shardings_for_specs(model_specs(cfg),
                                                tsh.TRAIN_RULES, sizes))
    assert "split" in roles.values()
    router = shardings.get("moe_layers/moe/router")
    for out in world["out"][ranks]:
        for k, sh in shardings.items():
            want = list(sh.shape)
            if roles[k] == "split":
                for i in range(len(want)):
                    if "model" in sh.dim_axes(i):
                        want[i] //= sizes["model"]
            assert tuple(out[f"{name}/local/{k}"]) == tuple(want), \
                (k, roles[k])
        assert set(out[f"{name}/model_gather_dims"].tolist()) <= {1}
        allowed = {tuple(router.shape)} if router else set()
        assert {tuple(r) for r in out[f"{name}/model_leaf_gathers"]} <= \
            allowed


def test_odd_runs_fall_back_to_the_layout_without_sp(world):
    """A sequence of 15 tokens, or 31 frames under 16 tokens, does not
    split over 2: the pass runs without sequence parallelism, its norms
    whole (``"whole"`` roles), as the reference's ``tokens`` fallback."""
    for name in ("mla-m12-sp-odd", "encdec-m12-sp-odd"):
        ref = RUNS[name][0]
        cfg = world["cfgs"][ref]
        pc = tsh.PartitionConstraints(tsh.TRAIN_RULES, {"data": 1,
                                                        "model": 2},
                                      seq_parallel=True)
        assert not pc.sp_pass(cfg, REFS[ref][1], REFS[ref][2])
        roles = tsh.tp_roles(cfg, tsh.TRAIN_RULES, {"data": 1, "model": 2},
                             False)
        assert roles["final_norm/scale"] == "whole"


def test_dropping_the_wkv_a_sum_misses_the_reference(world):
    name = "mla-m12-no-wkv-a-sum"
    cfg = world["cfgs"]["mla"]
    _, last = world["want"]["mla"]
    missed = [_misses(out, name, cfg, last) for out in world["out"][2]]
    assert all(any(k.endswith("/attn/wkv_a") for k in m) for m in missed), \
        missed


@pytest.mark.parametrize("name", ["encdec-m12-sp-no-enc-offset",
                                  "encdec-m12-sp-no-dec-offset"])
def test_unoffset_positions_miss_the_reference(world, name):
    """The position trap: a sequence-parallel rank that adds the first
    rows' sinusoidal positions to its own rows (of the frames, or of the
    tokens) misses the reference's loss and params."""
    cfg = world["cfgs"]["encdec"]
    metrics, last = world["want"]["encdec"]
    for out in world["out"][2]:
        got = _sub(out, name)["m/loss"]
        assert np.abs(got - [m["loss"] for m in metrics]).max() > \
            100 * STEP_TOL
        assert _misses(out, name, cfg, last) != []
