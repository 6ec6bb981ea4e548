"""Tensor-parallel compute for the recurrent families (zamba2's Mamba2
layers and shared attention, RWKV6's time and channel mix) under "model",
vs the JAX package, over gloo ranks on the CPU.

* ``tp_roles`` for zamba2-7b and rwkv6-1.6b on the reference's (16, 16)
  and (2, 16, 16) meshes, with and without sequence parallelism:
  ``"split"`` exactly where the reference's ``logical_to_pspec`` binds
  "model"; RWKV6's ddlerp, decay and channel-mix mixing leaves (no
  dimension on "model") ``"partial"``; the norms (a Mamba2 block's ``ln``,
  RWKV6's LayerNorms, the final norm, the shared blocks') ``"partial"``
  only under sequence parallelism.
* Mamba2's narrow layout on (1, 2), (1, 4) and (1, 8) meshes: rank r's
  ``in_proj`` piece is ``[z_r | x_r | BC_r | dt_r]`` cut from the whole
  leaf (its conv leaves and conv cache ``[x_r | BC_r]``), ``gather_tree``
  of the pieces gives the whole leaves back, and a checkpoint saved from
  the pieces restores them.
* The mesh step against the reference's single-device step on the same
  global batches (three steps, AdamW, ``STEP_TOL``: the loss, grad norm,
  param norm and lr of every step and every rank's pieces), each piece
  also held to the port's one-device step: the zamba2 smoke model in fp32
  (2 Mamba2 layers and both shared blocks) on (1, 2) with
  ``seq_parallel``, on (2, 2) and on (1, 4); the rwkv6 smoke model in
  fp32 on (1, 2) with ``seq_parallel`` and on (1, 4) (one head a rank);
  zamba2 with ``seq_parallel`` on 15 tokens, which do not split over 2:
  the layout without sequence parallelism.
* Serving: ``make_serve_fns(cfg, pc=)`` prefill and decode on (1, 2) for
  both families against the reference's single-device serve fns, each
  rank's cache piece the one-device cache's cut.
* Mutations that must miss the reference: Mamba2's B / C gather with a
  sliced backward (no sum over "model"); RWKV6's channel-mix gather with
  a summed backward; the gated norm on each rank's own statistic; an
  RWKV6 ``"partial"`` leaf (``decay_w1``) taken as ``"whole"``; the token
  shift on a sequence-parallel rank's rows; the identity in place of the
  segmented layout's permutation.
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
from repro_torch.models.transformer import (  # noqa: E402
    cache_specs, model_specs)
from repro_torch.parallel import sharding as tsh  # noqa: E402
from test_torch_dist import _jmesh  # noqa: E402
from test_torch_dist_step import (  # noqa: E402
    BASE, STEP_TOL, _batches, _check_metrics, _flat_np)
from test_torch_moe import _numpy_params  # noqa: E402
from test_torch_serve_mesh import (  # noqa: E402
    CACHE_TOL, TOL, _gap, _greedy_reference)
from test_torch_serve_mesh import _one_device as _serve_one  # noqa: E402
from test_torch_tp_moe import _binds_model, _one_device, _reference, _sub  # noqa: E402,E501

STEPS = 3
M12 = (("data", "model"), (1, 2))
M22 = (("data", "model"), (2, 2))
M14 = (("data", "model"), (1, 4))
ADAMW = dict(optimizer="adamw")
SP = dict(ADAMW, seq_parallel=True)
FP32 = {"dtype": "float32"}
ZAMBA, RWKV = "zamba2-7b", "rwkv6-1.6b"
# the reference runs: (model, tokens a row)
REFS = {
    "zamba2": (ZAMBA, 16),
    "zamba2-odd": (ZAMBA, 15),
    "rwkv6": (RWKV, 16),
}
# name: (reference, mesh, train config, ranks, mutation)
RUNS = {
    "zamba2-m12-sp": ("zamba2", M12, SP, 2, None),
    "zamba2-m12-sp-odd": ("zamba2-odd", M12, SP, 2, None),
    "rwkv6-m12-sp": ("rwkv6", M12, SP, 2, None),
    "zamba2-m12-bc-slice": ("zamba2", M12, ADAMW, 2, "bc_slice"),
    "rwkv6-m12-cm-sum": ("rwkv6", M12, ADAMW, 2, "cm_sum"),
    "zamba2-m12-local-norm": ("zamba2", M12, ADAMW, 2, "local_norm"),
    "rwkv6-m12-no-decay-w1-sum": ("rwkv6", M12, ADAMW, 2,
                                  "no_partial_sum:decay_w1"),
    "rwkv6-m12-sp-row-shift": ("rwkv6", M12, SP, 2, "row_shift:2"),
    "zamba2-m12-identity-layout": ("zamba2", M12, ADAMW, 2,
                                   "identity_layout"),
    "zamba2-m22": ("zamba2", M22, ADAMW, 4, None),
    "zamba2-m14": ("zamba2", M14, ADAMW, 4, None),
    "rwkv6-m14": ("rwkv6", M14, ADAMW, 4, None),
}
HELD = [n for n, r in RUNS.items() if r[4] is None]
MUTANTS = [n for n, r in RUNS.items() if r[4] is not None]
PROBED = ("zamba2-m12-sp", "zamba2-m22", "rwkv6-m12-sp", "rwkv6-m14")
# served batches: (model, rows, prompt length, max_len, decode steps)
SERVED = {"zamba2": (ZAMBA, 4, 12, 24, 5), "rwkv6": (RWKV, 4, 12, 24, 5)}
# the layout worlds: ranks, and the serving cache (rows, max_len) cut
LAYOUT_WORLDS = (2, 4, 8)
LAYOUT_CACHE = (2, 8)
SEGMENTED = ("groups/in_proj", "groups/conv_w", "groups/conv_b")


def _cfgs(model):
    return (dataclasses.replace(jget_config(model, smoke=True), **FP32),
            dataclasses.replace(get_config(model, smoke=True), **FP32))


def _run_opts(name, ref, names, shape, tcfg, mutate):
    return {"name": name, "model": REFS[ref][0], "cfg": FP32,
            "names": names, "shape": shape, "tcfg": {**BASE, **tcfg},
            "steps": STEPS, "params": f"{ref}_params.npz",
            "batches": f"{ref}_batches.npz", "probe": name in PROBED,
            "mutate": mutate}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_recurrent")
    cfgs, inputs = {}, {}
    for i, (ref, (model, s)) in enumerate(REFS.items()):
        jc, tc = _cfgs(model)
        pn = _numpy_params(jmodel_specs(jc), seed=70 + i)
        np.savez(d / f"{ref}_params.npz", **_flat_np(pn))
        np.savez(d / f"{ref}_batches.npz", **_batches(tc.vocab_size, 80 + i,
                                                      STEPS, s))
        cfgs[ref] = tc
        inputs[ref] = (jc, pn, dict(np.load(d / f"{ref}_batches.npz")))
    runs = {2: [], 4: []}
    for name, (ref, (names, shape), tcfg, ranks, mutate) in RUNS.items():
        runs[ranks].append(_run_opts(name, ref, names, shape, tcfg, mutate))
    # serving: the reference's greedy tokens fed to every run
    served, serve_runs = {}, []
    for i, (ref, (model, b, s, max_len, n)) in enumerate(SERVED.items()):
        jc, tc = _cfgs(model)
        pn = _numpy_params(jmodel_specs(jc), seed=90 + i)
        rng = np.random.default_rng(95 + i)
        toks = {"tokens": rng.integers(1, tc.vocab_size, (b, s)).astype(
            np.int32)}
        logits, fed, _ = _greedy_reference(jc, pn, toks, max_len, n)
        toks["steps"] = fed
        np.savez(d / f"serve_{ref}_params.npz", **_flat_np(pn))
        np.savez(d / f"serve_{ref}_inputs.npz", **toks)
        served[ref] = (logits, _serve_one(tc, pn, toks, max_len, fed))
        serve_runs.append({
            "name": f"serve-{ref}", "model": model, "cfg": FP32,
            "names": M12[0], "shape": M12[1], "max_len": max_len,
            "params": f"serve_{ref}_params.npz",
            "inputs": f"serve_{ref}_inputs.npz"})
    # the layout worlds' leaves: the zamba2 smoke params and a random cache
    _, zc = _cfgs(ZAMBA)
    np.savez(d / "layout_params.npz", **_flat_np(inputs["zamba2"][1]))
    rng = np.random.default_rng(99)
    cache = {k: rng.standard_normal(s.shape).astype(np.float32)
             for k, s in flatten(cache_specs(zc, *LAYOUT_CACHE)).items()}
    np.savez(d / "layout_cache.npz", **cache)
    lopts = {"model": ZAMBA, "cfg": FP32, "cache": list(LAYOUT_CACHE)}
    out = {2: torch_dist_ranks.launch("tp", 2, str(d), {"runs": runs[2]}),
           4: torch_dist_ranks.launch("tp", 4, str(d), {"runs": runs[4]})}
    serve = torch_dist_ranks.launch("serve", 2, str(d), {"runs": serve_runs})
    layout = {n: torch_dist_ranks.launch("layout", n, str(d), lopts)
              for n in LAYOUT_WORLDS}
    want = {ref: _reference(jc, ADAMW, pn, b)
            for ref, (jc, pn, b) in inputs.items()}
    one = {ref: _one_device(cfgs[ref], ADAMW, pn, b)
           for ref, (jc, pn, b) in inputs.items()}
    return {"out": out, "want": want, "one": one, "cfgs": cfgs,
            "serve": serve, "served": served, "layout": layout,
            "layout_params": inputs["zamba2"][1], "layout_cache": cache,
            "layout_cfg": zc}


def _misses(out, name, cfg, want, tol=STEP_TOL) -> list:
    """The leaves whose piece misses ``want`` (whole leaves, cut by the
    run's binding) beyond ``tol``, relative and absolute."""
    names, shape = RUNS[name][1]
    sizes = dict(zip(names, shape))
    coord = dict(zip(names, out[f"{name}/coord"].tolist()))
    bad = []
    for k, sh in flatten(tsh.shardings_for_specs(
            model_specs(cfg), tsh.TRAIN_RULES, sizes)).items():
        got = out[f"{name}/p/{k}"]
        assert got.shape == sh.local_shape(), k
        if not np.allclose(got, sh.cut(want[k], coord), rtol=tol, atol=tol):
            bad.append(k)
    return bad


# -- roles ------------------------------------------------------------------


@pytest.mark.parametrize("sp", [False, True], ids=["no-sp", "sp"])
@pytest.mark.parametrize("mesh", [(("data", "model"), (16, 16)),
                                  (("pod", "data", "model"), (2, 16, 16))],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", [ZAMBA, RWKV])
def test_roles_follow_the_reference_binding(arch, mesh, sp):
    names, shape = mesh
    sizes = dict(zip(names, shape))
    jm = _jmesh(names, shape)
    cfg = get_config(arch)
    jspecs = flatten(jmodel_specs(jget_config(arch)))
    roles = tsh.tp_roles(cfg, tsh.TRAIN_RULES, sizes, sp)
    assert set(roles) == set(jspecs)
    for k, role in roles.items():
        binds = _binds_model(jsh.logical_to_pspec(
            jspecs[k].axes, jspecs[k].shape, jsh.TRAIN_RULES, jm))
        leaf, parent = k.split("/")[-1], k.split("/")[-2]
        if leaf in tsh.RWKV_TIME_WHOLE + tsh.RWKV_CHANNEL_WHOLE:
            assert not binds and role == "partial", (k, role)
        elif parent in ("ln", "ln1", "ln2", "final_norm") or \
                leaf in tsh.RWKV_NORMS:
            assert role == ("partial" if sp else "whole"), (k, role)
        else:
            assert role == ("split" if binds else "whole"), (k, role, binds)
    if arch == ZAMBA:
        for k in tsh.MAMBA2:
            assert roles[f"groups/{k}"] == roles[f"rem/{k}"] == "split", k
        for k in ("attn/wq", "attn/wk", "attn/wo", "mlp/w_up"):
            assert roles[f"shared/{k}"] == "split", k
    else:
        for k in tsh.RWKV_TIME + tsh.RWKV_CHANNEL:
            assert roles[f"layers/{k}"] == "split", k


def test_recurrent_layouts_whole_where_the_heads_do_not_divide():
    """Where the heads (or a part of in_proj) do not divide the "model"
    size, the mixer's leaves are whole, its whole-computed leaves whole
    too; the pass's layout still splits the vocabulary; a serving cache's
    state splits by heads where those divide, RWKV6's token shifts never."""
    zamba = get_config(ZAMBA, smoke=True)               # 8 heads
    roles = tsh.tp_roles(zamba, tsh.TRAIN_RULES, {"data": 1, "model": 16})
    for k in tsh.MAMBA2:
        assert roles[f"groups/{k}"] == "whole", k
    rwkv = get_config(RWKV, smoke=True)                 # 4 heads
    roles = tsh.tp_roles(rwkv, tsh.TRAIN_RULES, {"data": 1, "model": 8})
    for k in tsh.RWKV_TIME_WHOLE:
        assert roles[f"layers/{k}"] == "whole", k
    assert roles["layers/wr"] == "whole"            # binds, not computed so
    assert roles["layers/cm_wk"] == "split"          # 128 hidden columns
    assert roles["embed/embedding"] == "split"
    mesh = {"data": 1, "model": 2}
    assert tsh.kv_cache_layout(rwkv, tsh.SERVE_RULES, mesh, 24) == "whole"
    assert tsh.kv_cache_layout(zamba, tsh.SERVE_RULES, mesh, 24) == "heads"
    csh = flatten(tsh.cache_shardings(rwkv, tsh.SERVE_RULES, mesh, 2, 24))
    assert csh["wkv"].dim_axes(2) == ("model",)
    assert "model" not in csh["shift_tm"].axes + csh["shift_cm"].axes
    zsh = flatten(tsh.cache_shardings(zamba, tsh.SERVE_RULES, mesh, 2, 24))
    assert zsh["groups/conv"].segments == (128, 32)
    assert zsh["groups/ssm"].dim_axes(3) == ("model",)
    with pytest.raises(ValueError, match="cut"):
        zsh["groups/conv"].slices({"model": 1})


# -- the narrow layout ------------------------------------------------------


def _narrow(full, r, n, parts):
    """Rank r's piece of a last dimension of ``parts``, cut by hand: the
    r-th of n equal chunks of each part, in part order."""
    out, lo = [], 0
    for w in parts:
        k = w // n
        out.append(full[..., lo + r * k:lo + (r + 1) * k])
        lo += w
    return np.concatenate(out, axis=-1)


@pytest.mark.parametrize("n", LAYOUT_WORLDS)
def test_segmented_pieces_gather_and_restore(world, n):
    cfg = world["layout_cfg"]
    di = cfg.ssm.d_inner(cfg.d_model)
    gn = cfg.ssm.n_groups * cfg.ssm.state_dim
    nh = cfg.ssm.num_heads(cfg.d_model)
    parts = {"groups/in_proj": (di, di, 2 * gn, nh),
             "groups/conv_w": (di, 2 * gn), "groups/conv_b": (di, 2 * gn)}
    params = world["layout_params"]
    flat = _flat_np(params)
    for out in world["layout"][n]:
        r = int(out["coord"][1])
        for k, p in parts.items():
            want = _narrow(flat[k], r, n, p)
            assert np.array_equal(out[f"piece/{k}"], want), (k, r)
            # its width is the reference's contiguous piece's
            assert want.shape[-1] * n == flat[k].shape[-1]
        assert np.array_equal(out["cpiece/groups/conv"], _narrow(
            world["layout_cache"]["groups/conv"], r, n, (di, 2 * gn)))
        for k, v in flat.items():
            assert np.array_equal(out[f"gathered/{k}"], v), k
            assert np.array_equal(out[f"restored/{k}"], out[f"piece/{k}"]), k
        for k, v in world["layout_cache"].items():
            assert np.array_equal(out[f"cgathered/{k}"], v), k


# -- the mesh step against the reference's single-device step ---------------


@pytest.mark.parametrize("name", HELD)
def test_tp_step_matches_the_reference(world, name):
    ref, _, _, ranks, _ = RUNS[name]
    metrics, last = world["want"][ref]
    cfg = world["cfgs"][ref]
    held = 0
    for out in world["out"][ranks]:
        _check_metrics(_sub(out, name), metrics, STEP_TOL, False)
        assert _misses(out, name, cfg, world["one"][ref]) == []
        assert _misses(out, name, cfg, last) == []
        held += sum(v.size for k, v in out.items()
                    if k.startswith(f"{name}/p/"))
    assert held >= sum(v.size for v in last.values())


@pytest.mark.parametrize("name", PROBED)
def test_no_split_leaf_is_gathered_over_model(world, name):
    """Each computed leaf has its role's shape (a split leaf its piece's),
    and every exchange over "model" outside the leaves' gathers runs on an
    activation's sequence (dimension 1) or columns (its last)."""
    ref, (names, shape), tcfg, ranks, _ = RUNS[name]
    cfg = world["cfgs"][ref]
    sizes = dict(zip(names, shape))
    pc = tsh.PartitionConstraints(tsh.TRAIN_RULES, sizes,
                                  seq_parallel=tcfg.get("seq_parallel",
                                                        False))
    roles = tsh.tp_roles(cfg, tsh.TRAIN_RULES, sizes,
                         pc.sp_pass(cfg, REFS[ref][1]))
    shardings = flatten(tsh.shardings_for_specs(model_specs(cfg),
                                                tsh.TRAIN_RULES, sizes))
    for out in world["out"][ranks]:
        for k, sh in shardings.items():
            want = list(sh.shape)
            if roles[k] == "split":
                for i in range(len(want)):
                    if "model" in sh.dim_axes(i):
                        want[i] //= sizes["model"]
            assert tuple(out[f"{name}/local/{k}"]) == tuple(want), \
                (k, roles[k])
        dims = set(out[f"{name}/model_gather_dims"].tolist())
        assert dims <= {1, -1}, dims
        assert out[f"{name}/model_leaf_gathers"].size == 0


def test_odd_run_falls_back_to_the_layout_without_sp(world):
    """15 tokens do not split over 2: the pass runs without sequence
    parallelism, its norms whole, as the reference's ``tokens``
    fallback."""
    cfg = world["cfgs"]["zamba2-odd"]
    pc = tsh.PartitionConstraints(tsh.TRAIN_RULES, {"data": 1, "model": 2},
                                  seq_parallel=True)
    assert not pc.sp_pass(cfg, 15) and pc.sp_pass(cfg, 16)
    roles = tsh.tp_roles(cfg, tsh.TRAIN_RULES, {"data": 1, "model": 2},
                         False)
    assert roles["groups/ln/scale"] == roles["final_norm/scale"] == "whole"


# -- serving ------------------------------------------------------------------


@pytest.mark.parametrize("ref", list(SERVED))
def test_mesh_serving_matches_the_reference(world, ref):
    model, b, _, max_len, n = SERVED[ref]
    want, (one, cache) = world["served"][ref]
    assert _gap(one, want) <= TOL
    _, tc = _cfgs(model)
    mesh = dict(zip(*M12))
    shards = flatten(tsh.cache_shardings(tc, tsh.SERVE_RULES, mesh, b,
                                         max_len))
    name = f"serve-{ref}"
    for out in world["serve"]:
        rows = out[f"{name}/rows"]
        got = out[f"{name}/logits"]
        assert got.shape == (n + 1, len(rows), want.shape[-1])
        assert _gap(got, want[:, rows]) <= TOL, _gap(got, want[:, rows])
        coord = dict(zip(M12[0], out[f"{name}/coord"].tolist()))
        split = 0
        for k, sh in shards.items():
            piece = out[f"{name}/c/{k}"]
            assert piece.shape == sh.local_shape(), k
            assert np.allclose(piece, sh.cut(cache[k], coord),
                               rtol=CACHE_TOL, atol=CACHE_TOL), k
            split += "model" in sh.axes
        assert split == (4 if ref == "zamba2" else 1)


# -- mutations ----------------------------------------------------------------


@pytest.mark.parametrize("name", MUTANTS)
def test_planted_faults_miss_the_reference(world, name):
    """Each planted fault misses the reference's params on every rank; the
    faults of the forward (the norm's statistic, the token shift, the
    layout) miss its losses beyond the tolerance too, those of a backward
    alone leave step 0's loss within it."""
    ref = RUNS[name][0]
    cfg = world["cfgs"][ref]
    metrics, last = world["want"][ref]
    forward = RUNS[name][4] in ("local_norm", "row_shift:2",
                                "identity_layout")
    for out in world["out"][2]:
        assert _misses(out, name, cfg, last) != [], name
        gaps = np.abs(_sub(out, name)["m/loss"] -
                      [m["loss"] for m in metrics])
        if forward:
            assert gaps.max() > STEP_TOL, gaps
        else:
            assert gaps[0] <= STEP_TOL, gaps
