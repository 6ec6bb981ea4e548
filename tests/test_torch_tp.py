"""Tensor-parallel compute and sequence parallelism under "model" vs the
JAX package, over gloo ranks on the CPU.

* ``tp_roles`` (``repro_torch.parallel.sharding``) for every shipped
  config on (16, 16) and (2, 16, 16): a leaf of a covered family (every
  family with attention blocks: dense, MoE and VLM with GQA or MLA, the
  enc-dec) is ``"split"`` exactly where the reference's
  ``logical_to_pspec`` binds "model", the MoE router excepted (always
  ``"whole"``); granite's ``wk`` / ``wv`` are
  ``"partial"`` (8 KV heads on 16), yi's ``wq`` / ``wo`` ``"whole"`` (56
  heads on 16), norms ``"partial"`` only under sequence parallelism, and
  every leaf of the recurrent families (the Mamba2 hybrid, RWKV6)
  ``"whole"``.  MLA and the enc-dec under a mesh are in
  ``test_torch_tp_mla_encdec.py``.
* Two ranks (``torch_dist_ranks``, case ``tp``): the four region
  operations' outputs and gradients against their definitions (exact:
  sums of two fp32 terms), and on meta operands their shapes; the
  vocabulary-parallel cross-entropy against the reference's
  ``cross_entropy`` with a padded vocabulary, uneven masks and a given
  denominator, its loss and its columns' gradients in fp32 at 1e-6.
* The mesh step against the reference's single-device step on the same
  global batches (three steps, AdamW; ``STEP_TOL`` as in
  ``test_torch_dist_step.py``: the loss, grad norm, param norm and lr of
  every step and every rank's pieces of the updated params; each piece
  is also held to the port's own one-device step at ``STEP_TOL``, and
  to the reference wherever that step is: an element whose step-0
  gradient is a near-cancelling sum far under AdamW's ``eps`` moves by a
  share of the learning rate that sums in another order change, so the
  one-device port already differs there (nemotron's embedding element
  (463, 32): 5.2e-10 in fp64 where its row's gradients are 2.3e-3 rms,
  1.3e-9 in the port's fp32 and -8.6e-11 in the reference's jitted fp32,
  each within 4e-7 of that rms; each package's update rebuilt in fp64
  from its own gradients gives its own fp32 result); no more than one
  element in 1000 a leaf may), for lms-demo
  narrow (4 heads, 2 KV heads, padded vocabulary) on (1, 2) and (1, 2)
  with ``seq_parallel`` and with ``seq_parallel`` on a sequence of 15 (the
  fallback to the layout without it), the narrow hybrid (zamba2 smoke in
  fp32: 2 groups of 2 Mamba2 blocks, each group followed by the one shared
  attention block, and a trailing block) and the enc-dec smoke (seamless,
  fp32, with ``src_frames``) on (2, 1), where every leaf is gathered over
  "data" layer by layer, on 2 ranks; and on 4 ranks, on
  (2, 2), (2, 2) with ``seq_parallel`` (Adafactor, 2 microbatches), (1, 4)
  (its 2 KV heads fall back to replication: ``wk`` / ``wv`` partial) and
  (1, 4) with 6 heads (its heads fall back: attention whole); nemotron
  smoke (LayerNorm, relu2, 1 KV head, untied head) on (2, 2) with
  ``seq_parallel``; mixtral smoke (its 4 experts split over "model",
  routed on the whole sequence) on (2, 2) with ``seq_parallel``.  On
  (2, 2) and (1, 4) a ``"split"`` leaf is computed as its "model" piece
  and no leaf but the MoE router is gathered over "model" (every other
  gather over it is an activation's, along the sequence).  The MoE and
  VLM runs of their own are in ``test_torch_tp_moe.py``.
* A param's piece gathered for compute (``comm.gather_piece``) on 4 ranks,
  (2, 2), in each role: the leaf it returns and its backward, which is
  ``train.step.mean_over_data`` of the upstream gradient exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_ranks  # noqa: E402
from repro.configs import available_archs  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.transformer import model_specs as jmodel_specs  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.models.transformer import model_specs  # noqa: E402
from repro_torch.parallel import comm  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from test_torch_dist import _jmesh  # noqa: E402
from test_torch_dist_step import (  # noqa: E402
    BASE, NARROW, STEP_TOL, _batches, _cfgs, _check_metrics, _check_pieces,
    _flat_np, _keys, _reference)
from test_torch_moe import _numpy_params  # noqa: E402

CE_TOL = 1e-6
STEPS = 3
M12 = (("data", "model"), (1, 2))
M21 = (("data", "model"), (2, 1))
M22 = (("data", "model"), (2, 2))
M14 = (("data", "model"), (1, 4))
ADAMW = dict(optimizer="adamw")
SP = dict(seq_parallel=True)
# the reference runs: (model, cfg overrides, sequence length); each is
# held by the runs named after it
REFS = {
    "lms": ("lms-demo", NARROW, 16),
    "lms-odd": ("lms-demo", NARROW, 15),
    "lms-h6": ("lms-demo", dict(NARROW, num_heads=6), 16),
    "nemo": ("nemotron-4-340b", {"dtype": "float32"}, 16),
    "mix": ("mixtral-8x7b", {"dtype": "float32"}, 16),
    "hyb": ("zamba2-7b", {"dtype": "float32", "num_layers": 5}, 16),
    "encdec": ("seamless-m4t-large-v2", {"dtype": "float32"}, 16),
}
# the hybrid's layout: 2 groups of 2 Mamba2 blocks, each group followed by
# the one shared attention block, then a trailing (rem) block
HYBRID = {"attn_every": 2, "num_shared_blocks": 1}
# name: (reference, mesh, train config, ranks)
RUNS = {
    "lms-m12": ("lms", M12, ADAMW, 2),
    "lms-m12-sp": ("lms", M12, dict(ADAMW, **SP), 2),
    "lms-m12-sp-odd": ("lms-odd", M12, dict(ADAMW, **SP), 2),
    "lms-m22": ("lms", M22, ADAMW, 4),
    "lms-m22-sp": ("lms", M22, dict(SP, optimizer="adafactor",
                                    num_microbatches=2), 4),
    "lms-m14-kv": ("lms", M14, ADAMW, 4),
    "lms-m14-h6": ("lms-h6", M14, ADAMW, 4),
    "nemo-m22-sp": ("nemo", M22, dict(ADAMW, **SP), 4),
    "mix-m22-sp": ("mix", M22, dict(ADAMW, **SP), 4),
    "hyb-m21": ("hyb", M21, ADAMW, 2),
    "encdec-m21": ("encdec", M21, ADAMW, 2),
}
PROBED = ("lms-m22", "lms-m14-kv", "lms-m22-sp", "mix-m22-sp")
B = 8


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
    d = tmp_path_factory.mktemp("tp")
    cfgs, inputs = {}, {}
    for i, (ref, (model, cfg, s)) in enumerate(REFS.items()):
        jc, tc = _cfgs(model, cfg, {})
        if ref == "hyb":
            jc.hybrid = dataclasses.replace(jc.hybrid, **HYBRID)
            tc.hybrid = dataclasses.replace(tc.hybrid, **HYBRID)
        pn = _numpy_params(jmodel_specs(jc))
        np.savez(d / f"{ref}_params.npz", **_flat_np(pn))
        batches = _batches(tc.vocab_size, 10 + i, STEPS, s)
        if tc.family == "encdec":
            rng = np.random.default_rng(40 + i)
            batches.update({f"src_frames{j}": rng.standard_normal(
                (B, tc.encdec_source_len, tc.d_model)).astype(np.float32)
                for j in range(STEPS)})
        np.savez(d / f"{ref}_batches.npz", **batches)
        cfgs[ref] = tc
        inputs[ref] = (jc, pn, batches)
    runs = {2: [], 4: []}
    for name, (ref, (names, shape), tcfg, ranks) in RUNS.items():
        model, cfg, _ = REFS[ref]
        runs[ranks].append({
            "name": name, "model": model, "cfg": cfg, "moe": {},
            "hybrid": HYBRID if ref == "hyb" else {},
            "names": names, "shape": shape, "tcfg": {**BASE, **tcfg},
            "steps": STEPS, "params": f"{ref}_params.npz",
            "batches": f"{ref}_batches.npz", "probe": name in PROBED})

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 8)).astype(np.float32)
    np.savez(d / "regions.npz", x=x,
             parts=rng.standard_normal((2, 2, 6, 8)).astype(np.float32),
             w=rng.standard_normal((2, 2, 6, 8)).astype(np.float32))
    ce_cfg = dict(NARROW)
    jce, tce = _cfgs("lms-demo", ce_cfg, {})
    assert tce.vocab_padded != tce.vocab_size
    logits = (3 * rng.standard_normal((3, 5, tce.vocab_padded))).astype(
        np.float32)
    targets = rng.integers(0, tce.vocab_size, (3, 5))
    mask = rng.random((3, 5)) < np.array([0.9, 0.2, 0.6])[:, None]
    np.savez(d / "ce.npz", logits=logits, targets=targets, mask=mask,
             denominator=np.float64(11.0))
    np.savez(d / "grad_piece.npz",
             w=rng.standard_normal((8, 6)).astype(np.float32),
             up=rng.standard_normal((4, 8, 6)).astype(np.float32))

    two = torch_dist_ranks.launch("tp", 2, str(d), {
        "runs": runs[2], "regions": True,
        "ce": {"model": "lms-demo", "cfg": ce_cfg}})
    four = torch_dist_ranks.launch("tp", 4, str(d), {"runs": runs[4],
                                                      "grad_piece": True})
    # the references, while nothing else runs
    want = {ref: _reference(jc, ADAMW, pn, b, STEPS)
            for ref, (jc, pn, b) in inputs.items()}
    one = {ref: _one_device(cfgs[ref], ADAMW, pn, b)
           for ref, (jc, pn, b) in inputs.items()}
    for name, (ref, _, tcfg, _) in RUNS.items():
        if tcfg.get("optimizer") == "adafactor":
            jc, pn, b = inputs[ref]
            plain = {k: v for k, v in tcfg.items() if k != "seq_parallel"}
            want[name] = _reference(jc, plain, pn, b, STEPS)
            one[name] = _one_device(cfgs[ref], plain, pn, b)
    return {"out": {2: two, 4: four}, "want": want, "one": one, "cfgs": cfgs,
            "regions": dict(np.load(d / "regions.npz")),
            "grad_piece": dict(np.load(d / "grad_piece.npz")),
            "ce": (jce, logits, targets, mask)}


# -- roles ------------------------------------------------------------------


def _binds_model(pspec) -> bool:
    return any("model" in (e if isinstance(e, tuple) else (e,))
               for e in pspec if e is not None)


@pytest.mark.parametrize("mesh", [(("data", "model"), (16, 16)),
                                  (("pod", "data", "model"), (2, 16, 16))],
                         ids=["16x16", "2x16x16"])
def test_tp_roles_agree_with_the_reference_binding(mesh):
    names, shape = mesh
    sizes = dict(zip(names, shape))
    jm = _jmesh(names, shape)
    for arch in available_archs():
        cfg = get_config(arch)
        jspecs = flatten(jmodel_specs(jget_config(arch)))
        for sp in (False, True):
            roles = tsh.tp_roles(cfg, tsh.TRAIN_RULES, sizes, sp)
            assert set(roles) == set(flatten(model_specs(cfg)))
            for k, role in roles.items():
                assert role in tsh.ROLES, (arch, k)
                binds = _binds_model(jsh.logical_to_pspec(
                    jspecs[k].axes, jspecs[k].shape, jsh.TRAIN_RULES, jm))
                if k.endswith("/moe/router"):
                    # the router stays whole where it binds "model" too
                    assert role == "whole", (arch, k)
                elif role == "split":
                    assert binds, (arch, k)
                else:
                    assert not binds, (arch, k, role)
                if k.split("/")[-2] in ("ln1", "ln2", "ln_cross",
                                        "final_norm"):
                    assert role == ("partial" if sp else "whole"), (arch, k)


def test_tp_roles_pinned_cases():
    sizes = {"data": 16, "model": 16}
    granite = tsh.tp_roles(get_config("granite-3-8b"), tsh.TRAIN_RULES,
                           sizes)
    for k in ("wk", "wv"):
        assert granite[f"dense_layers/attn/{k}"] == "partial"
    for k in ("attn/wq", "attn/wo", "mlp/w_gate", "mlp/w_up", "mlp/w_down"):
        assert granite[f"dense_layers/{k}"] == "split", k
    assert granite["embed/embedding"] == "split"
    yi = tsh.tp_roles(get_config("yi-34b"), tsh.TRAIN_RULES, sizes)
    for k in ("wq", "wo", "wk", "wv"):
        assert yi[f"dense_layers/attn/{k}"] == "whole"
    assert yi["dense_layers/mlp/w_up"] == "split"
    mix = tsh.tp_roles(get_config("mixtral-8x7b"), tsh.TRAIN_RULES, sizes,
                       True)
    # 8 experts on 16: the expert stacks split their hidden columns
    assert mix["moe_layers/moe/w_gate"] == "split"
    assert mix["moe_layers/moe/router"] == "whole"
    assert mix["moe_layers/ln2/scale"] == "partial"
    assert mix["final_norm/scale"] == "partial"
    # no live "model" axis: every leaf whole
    assert set(tsh.tp_roles(get_config("granite-3-8b"), tsh.TRAIN_RULES,
                            {"data": 16, "model": 1}).values()) == {"whole"}


def test_regions_are_the_identity_on_one_model_rank():
    x = torch.ones(2, 4, 8)
    one = {"data": 2, "model": 1}
    for fn in (comm.copy_to_model, comm.reduce_from_model, comm.gather_seq,
               comm.scatter_seq):
        assert fn(x, one) is x
    assert comm.staged() == {"collectives": 0, "bytes": 0}


# -- two ranks: regions and the vocabulary-parallel cross-entropy ------------


def test_region_operations_and_their_gradients(world):
    d = world["regions"]
    x, parts, w = d["x"], d["parts"], d["w"]
    half = x.shape[1] // 2
    whole_w = np.concatenate([w[0][:, :half], w[1][:, half:]], axis=1)
    for r, out in enumerate(world["out"][2]):
        mine = slice(r * half, (r + 1) * half)
        want = {
            "copy": (x, w[0] + w[1]),
            "reduce": (parts[0] + parts[1], w[0]),
            "gather": (x, (w[0] + w[1])[:, mine]),
            "scatter": ((parts[0] + parts[1])[:, mine], whole_w),
        }
        for name, (y, dx) in want.items():
            np.testing.assert_allclose(out[f"{name}/y"], y, rtol=1e-6,
                                       atol=1e-6, err_msg=name)
            np.testing.assert_allclose(out[f"{name}/dx"], dx, rtol=1e-6,
                                       atol=1e-6, err_msg=name)
        assert tuple(out["gather/meta_shape"]) == x.shape
        assert tuple(out["scatter/meta_shape"]) == (x.shape[0], half,
                                                    x.shape[2])
        assert tuple(out["copy/meta_shape"]) == x.shape
        assert tuple(out["reduce/meta_shape"]) == parts[0].shape


def test_vocab_parallel_cross_entropy_matches_the_reference(world):
    jce, logits, targets, mask = world["ce"]
    count = float(mask.sum())
    cases = {
        "den": (lambda lg: jlayers.cross_entropy(
            lg, jnp.asarray(targets), jce, mask=jnp.asarray(mask))
            * count / 11.0),
        "mask": (lambda lg: jlayers.cross_entropy(
            lg, jnp.asarray(targets), jce, mask=jnp.asarray(mask))),
        "none": (lambda lg: jlayers.cross_entropy(
            lg, jnp.asarray(targets), jce)),
    }
    n = logits.shape[-1] // 2
    for name, fn in cases.items():
        loss, grad = jax.value_and_grad(fn)(jnp.asarray(logits))
        grad = np.asarray(grad)
        ranks = world["out"][2]
        assert sorted(int(o["ce/rank"]) for o in ranks) == [0, 1]
        for out in ranks:
            r = int(out["ce/rank"])
            np.testing.assert_allclose(out[f"ce/{name}/loss"], float(loss),
                                       rtol=CE_TOL, atol=CE_TOL,
                                       err_msg=name)
            np.testing.assert_allclose(out[f"ce/{name}/grad"],
                                       grad[..., r * n:(r + 1) * n],
                                       rtol=CE_TOL, atol=CE_TOL,
                                       err_msg=name)


# -- a param's piece gathered for compute, and its gradient synced ---------


def test_a_gathered_piece_syncs_its_gradient_as_mean_over_data(world):
    """On (2, 2), for a leaf split over "data" (rows) and "model"
    (columns) in each role: ``comm.gather_piece`` returns the leaf whole
    (``"split"``: this rank's columns), and its backward is
    ``mean_over_data`` of the upstream gradient, and by hand: the mean
    over "data" of this rank's rows of it, summed over "model" first for
    ``"partial"``, its columns cut locally for ``"whole"``."""
    w, up = world["grad_piece"]["w"], world["grad_piece"]["up"]
    ranks = world["out"][4]
    coords = [tuple(o["gp/coord"].tolist()) for o in ranks]
    for out, (d, m) in zip(ranks, coords):
        rows, cols = slice(4 * d, 4 * d + 4), slice(3 * m, 3 * m + 3)
        for role in tsh.ROLES:
            y = out[f"gp/{role}/y"]
            np.testing.assert_array_equal(
                y, w[:, cols] if role == "split" else w, err_msg=role)
            got = out[f"gp/{role}/grad"]
            np.testing.assert_array_equal(
                got, out[f"gp/{role}/mean_over_data"], err_msg=role)
            summed = [q for q, c in enumerate(coords)
                      if role == "partial" or c[1] == m]
            want = sum(up[q][:, :y.shape[1]] for q in summed) / 2
            np.testing.assert_allclose(
                got, want[rows] if role == "split" else want[rows, cols],
                rtol=1e-6, atol=1e-6, err_msg=role)


# -- the mesh step against the reference's single-device step ---------------


def _check_tp_pieces(out, name, cfg, names, shape, want, one) -> int:
    """Every leaf's piece within STEP_TOL of the port's one-device step
    (``one``) everywhere, and of the reference (``want``) wherever the
    one-device step is; that step may miss the reference at no more than
    one element in 1000 a leaf.  Returns the elements held."""
    n = _check_pieces(out, name, cfg, names, shape, one, STEP_TOL)
    sizes = dict(zip(names, shape))
    coord = dict(zip(names, out[f"{name}/coord"].tolist()))
    for k, sh in flatten(tsh.shardings_for_specs(
            model_specs(cfg), tsh.TRAIN_RULES, sizes)).items():
        got, ref = out[f"{name}/p/{k}"], sh.cut(want[k], coord)
        near = np.abs(sh.cut(one[k], coord) - ref) <= \
            STEP_TOL * (1 + np.abs(ref))
        assert (~near).sum() <= got.size // 1000, k
        np.testing.assert_allclose(got[near], ref[near], rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=k)
    return n


@pytest.mark.parametrize("name", list(RUNS))
def test_tp_step_matches_the_reference(world, name):
    ref, (names, shape), tcfg, ranks = RUNS[name]
    key = name if name in world["want"] else ref
    metrics, trail = world["want"][key]
    cfg = world["cfgs"][ref]
    held = 0
    for out in world["out"][ranks]:
        sub = {k[len(name) + 1:]: v for k, v in out.items()
               if k.startswith(f"{name}/")}
        _check_metrics(sub, metrics[:STEPS], STEP_TOL, ref == "mix")
        held += _check_tp_pieces(out, name, cfg, names, shape,
                                 trail[STEPS - 1], world["one"][key])
    assert held >= sum(v.size for v in trail[STEPS - 1].values())


@pytest.mark.parametrize("name", PROBED)
def test_split_leaves_are_never_gathered_over_model(world, name):
    ref, (names, shape), tcfg, ranks = RUNS[name]
    cfg = world["cfgs"][ref]
    sizes = dict(zip(names, shape))
    roles = tsh.tp_roles(cfg, tsh.TRAIN_RULES, sizes,
                         tcfg.get("seq_parallel", False))
    shardings = flatten(tsh.shardings_for_specs(model_specs(cfg),
                                                tsh.TRAIN_RULES, sizes))
    assert "split" in roles.values()
    for out in world["out"][ranks]:
        for k, sh in shardings.items():
            got = tuple(out[f"{name}/local/{k}"])
            want = list(sh.shape)
            if roles[k] == "split":
                for i in range(len(want)):
                    if "model" in sh.dim_axes(i):
                        want[i] //= sizes["model"]
            assert got == tuple(want), (k, roles[k])
        # every exchange over "model" is an activation's, along the
        # sequence; no leaf is gathered over it but the MoE router (whole)
        assert set(out[f"{name}/model_gather_dims"].tolist()) <= {1}
        router = shardings.get("moe_layers/moe/router")
        allowed = {tuple(router.shape)} if router else set()
        assert {tuple(r) for r in out[f"{name}/model_leaf_gathers"]} <= \
            allowed
    if name == "lms-m14-kv":
        assert roles["dense_layers/attn/wk"] == "partial"
    if name.endswith("-sp"):
        assert roles["final_norm/scale"] == "partial"


def test_the_runs_take_the_layouts_they_name(world):
    """The fallbacks the runs above rely on: (1, 4) splits 4 heads but not
    2 KV heads, 6 heads not at all; a sequence of 15 does not divide 2."""
    pc = tsh.PartitionConstraints(tsh.TRAIN_RULES, {"data": 1, "model": 2},
                                  seq_parallel=True)
    assert pc.sp_for(16) and not pc.sp_for(15)
    m14 = {"data": 1, "model": 4}
    kv = tsh.tp_roles(world["cfgs"]["lms"], tsh.TRAIN_RULES, m14)
    assert kv["dense_layers/attn/wq"] == "split"
    assert kv["dense_layers/attn/wv"] == "partial"
    h6 = tsh.tp_roles(world["cfgs"]["lms-h6"], tsh.TRAIN_RULES, m14)
    assert h6["dense_layers/attn/wq"] == "whole"
    assert h6["dense_layers/mlp/w_down"] == "split"
    nemo = tsh.tp_roles(world["cfgs"]["nemo"], tsh.TRAIN_RULES,
                        {"data": 2, "model": 2}, True)
    assert nemo["dense_layers/attn/wk"] == "partial"
    assert nemo["dense_layers/ln1/bias"] == "partial"
    assert nemo["embed/lm_head"] == "split"
