"""The port's data-parallel train step vs the reference's single-device
step, over gloo ranks on the CPU.

Four ranks (``torch_dist_ranks``, case ``steps``) run
``make_train_step(..., mesh=)`` from the same params and global batches as
the reference's ``make_train_step`` on one device (computed here, in JAX),
three steps a run, for lms-demo (narrow: 2 layers, d=64) and the mixtral
smoke model in fp32, on:

* (4, 1) data x model: AdamW; lms-demo with labels masked unevenly across
  the ranks (the first rank's rows 80% masked, one row wholly); mixtral
  with capacity factor 0.5, so the dispatch drops triples, which the ranks
  must rank over the global batch as the reference does;
* (2, 2) data x model: lms-demo with Adafactor and 2 microbatches (its
  factored means over split dimensions) under remat ``"minimal"``,
  ``"none"`` (every gathered leaf saved for the backward) and ``"full"``,
  mixtral with AdamW;
* (2, 2) pod x data with ``grad_compression="int8"``: AdamW.

Tolerances: the loss, grad norm, param norm and lr of every step, the MoE
statistics, and every rank's pieces of the updated params against the
slices of the reference's leaves, 1e-4 relative and absolute
(``test_torch_train.STEP_TOL``: sums taken in another order, amplified by
the normalised update).  The int8 runs: step 0's per-element gap between
the compressed and the plain pod mean lies within the quantisation bound
(the mean over the pods of scale/2 of the element's row); their metrics
are held to the uncompressed reference at INT8_TOL (the MoE statistics,
which count routes, at step 0 only, at STEP_TOL), their pieces within
twice the learning rates summed over the steps (an element whose gradient
quantises to another AdamW direction moves by up to the step's lr in each
run).

Two ranks (case ``elastic``) restore the (4, 1) run's checkpoint, written
after its third step, onto a (2, 1) mesh: each rank's pieces are the
slices of the saved leaves, and the fourth step matches the reference's
fourth step (STEP_TOL).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_ranks  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.transformer import model_specs as jmodel_specs  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from test_torch_moe import _numpy_params  # noqa: E402

STEP_TOL = 1e-4
# int8 pod exchange against the uncompressed reference: the per-row
# quantisation (1/254 of a row's largest gradient at most) reaches the
# params through AdamW's normalised update
INT8_TOL = 2e-3
NARROW = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              head_dim=16, d_ff=128, vocab_size=500, vocab_pad_to=128,
              dtype="float32")
B, S, STEPS = 8, 16, 3
BASE = dict(warmup_steps=1, learning_rate=3e-3, remat_policy="minimal",
            total_steps=100)
DATA4 = (("data", "model"), (4, 1))
DM22 = (("data", "model"), (2, 2))
PD22 = (("pod", "data"), (2, 2))
# name: (model, cfg overrides, moe overrides, mesh, train config)
RUNS = {
    "lms-data4": ("lms-demo", NARROW, {}, DATA4, dict(optimizer="adamw")),
    "lms-dm22": ("lms-demo", NARROW, {}, DM22,
                 dict(optimizer="adafactor", num_microbatches=2)),
    "lms-dm22-remat-none": ("lms-demo", NARROW, {}, DM22,
                            dict(optimizer="adafactor", num_microbatches=2,
                                 remat_policy="none")),
    "lms-dm22-remat-full": ("lms-demo", NARROW, {}, DM22,
                            dict(optimizer="adafactor", num_microbatches=2,
                                 remat_policy="full")),
    "lms-pd22": ("lms-demo", NARROW, {}, PD22,
                 dict(optimizer="adamw", grad_compression="int8")),
    "mix-data4": ("mixtral-8x7b", {"dtype": "float32"},
                  {"capacity_factor": 0.5}, DATA4, dict(optimizer="adamw")),
    "mix-dm22": ("mixtral-8x7b", {"dtype": "float32"}, {}, DM22,
                 dict(optimizer="adamw")),
    "mix-pd22": ("mixtral-8x7b", {"dtype": "float32"}, {}, PD22,
                 dict(optimizer="adamw", grad_compression="int8")),
}
MOE_METRICS = ("moe_aux_loss", "moe_dropped_frac", "moe_max_load")


def _cfgs(model, cfg, moe):
    jc = dataclasses.replace(jget_config(model, smoke=True), **cfg)
    tc = dataclasses.replace(get_config(model, smoke=True), **cfg)
    if moe:
        jc.moe = dataclasses.replace(jc.moe, **moe)
        tc.moe = dataclasses.replace(tc.moe, **moe)
    return jc, tc


def _batches(vocab, seed, n=STEPS + 1, s=S):
    """Global batches of ``s`` tokens a row; labels masked unevenly: rows
    0-1 80%, row 2 wholly, the rest 10%."""
    rng = np.random.default_rng(seed)
    out = {}
    frac = np.array([0.8, 0.8, 1.0] + [0.1] * (B - 3))[:, None]
    for i in range(n):
        toks = rng.integers(1, vocab, size=(B, s + 1))
        labels = toks[:, 1:].copy()
        labels[rng.random((B, s)) < frac] = -1
        out[f"tokens{i}"] = toks[:, :-1].astype(np.int32)
        out[f"labels{i}"] = labels.astype(np.int32)
    return out


def _flat_np(tree) -> dict:
    return {k: np.asarray(v, np.float32)
            for k, v in flatten(jax.tree.map(np.asarray, tree)).items()}


def _keys(batches) -> list:
    """The entries of each step's batch (``tokens``, ``labels`` and any
    extras) in ``_batches``' ``<key><step>`` naming."""
    return sorted({k.rstrip("0123456789") for k in batches})


def _reference(jc, tcfg: dict, pn, batches, steps):
    """The reference's single-device step on the global batches (with
    their extras): the metrics of each step and the params after each
    step."""
    jcfg = jbase.TrainConfig(**{**BASE, **tcfg})
    fn = jax.jit(jstep.make_train_step(jc, jcfg)[0])
    params = jax.tree.map(jnp.asarray, pn)
    state = joptim.get_optimizer(jcfg).init(params)
    metrics, trail = [], []
    for i in range(steps):
        batch = {k: jnp.asarray(batches[f"{k}{i}"]) for k in _keys(batches)}
        params, state, m = fn(params, state, batch, i)
        metrics.append({k: float(v) for k, v in m.items()})
        trail.append(_flat_np(params))
    return metrics, trail


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("steps")
    runs, refs, cfgs = [], {}, {}
    for name, (model, cfg, moe, (names, shape), tcfg) in RUNS.items():
        jc, tc = _cfgs(model, cfg, moe)
        cfgs[name] = tc
        pn = _numpy_params(jmodel_specs(jc))
        np.savez(d / f"{name}_params.npz", **_flat_np(pn))
        batches = _batches(tc.vocab_size, seed=len(runs))
        np.savez(d / f"{name}_batches.npz", **batches)
        runs.append({"name": name, "model": model, "cfg": cfg, "moe": moe,
                     "names": names, "shape": shape,
                     "tcfg": {**BASE, **tcfg}, "steps": STEPS,
                     "params": f"{name}_params.npz",
                     "batches": f"{name}_batches.npz",
                     **({"ckpt": "ckpt"} if name == "lms-data4" else {})})
        refs[name] = (jc, tcfg, pn, batches)
    out = torch_dist_ranks.launch("steps", 4, str(d), {"runs": runs})
    # the reference, while nothing else runs; the int8 runs are held to
    # the uncompressed reference of the same model
    want = {}
    for name, (jc, tcfg, pn, batches) in refs.items():
        plain = {k: v for k, v in tcfg.items() if k != "grad_compression"}
        want[name] = _reference(jc, plain, pn, batches,
                                STEPS + (name == "lms-data4"))
    elastic = torch_dist_ranks.launch("elastic", 2, str(d), {
        "run": {**runs[0], "names": ("data", "model"), "shape": (2, 1)}})
    return {"out": out, "want": want, "cfgs": cfgs, "elastic": elastic,
            "batches": {k: v[3] for k, v in refs.items()}}


def _check_metrics(got, want, tol, moe):
    keys = ("loss", "grad_norm", "param_norm", "lr") + \
        (MOE_METRICS if moe else ())
    for k in keys:
        np.testing.assert_allclose(got[f"m/{k}"], [m[k] for m in want],
                                   rtol=tol, atol=tol, err_msg=k)


def _check_pieces(out, name, cfg, names, shape, want_leaves, tol=STEP_TOL,
                  abs_tol=None):
    from repro_torch.models.transformer import model_specs
    sizes = dict(zip(names, shape))
    shardings = flatten(tsh.shardings_for_specs(model_specs(cfg),
                                                tsh.TRAIN_RULES, sizes))
    coord = dict(zip(names, out[f"{name}/coord"].tolist()))
    n = 0
    for k, sh in shardings.items():
        got = out[f"{name}/p/{k}"]
        want = sh.cut(want_leaves[k], coord)
        assert got.shape == sh.local_shape(), k
        if abs_tol is None:
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                       err_msg=k)
        else:
            assert np.abs(got - want).max() <= abs_tol, k
        n += got.size
    return n


@pytest.mark.parametrize("name", ["lms-data4", "lms-dm22",
                                  "lms-dm22-remat-none",
                                  "lms-dm22-remat-full", "mix-data4",
                                  "mix-dm22"])
def test_dist_step_matches_the_reference(world, name):
    model, _, moe, (names, shape), _ = RUNS[name]
    metrics, trail = world["want"][name]
    held = 0
    for out in world["out"]:
        sub = {k[len(name) + 1:]: v for k, v in out.items()
               if k.startswith(f"{name}/")}
        _check_metrics(sub, metrics[:STEPS], STEP_TOL, bool(moe) or
                       model == "mixtral-8x7b")
        held += _check_pieces(out, name, world["cfgs"][name], names, shape,
                              trail[STEPS - 1], STEP_TOL)
    # every rank holds a piece; together at least the whole model
    total = sum(v.size for v in trail[STEPS - 1].values())
    assert held >= total


def test_uneven_masks_and_drops_are_what_the_reference_sees(world):
    """The runs above would pass with a mean of per-rank means only if every
    rank held the same count of labels, and with a per-rank capacity only
    if nothing dropped: neither holds here."""
    for i in range(STEPS):
        labels = world["batches"]["lms-data4"][f"labels{i}"]
        counts = (labels >= 0).reshape(4, -1).sum(1)
        assert len(set(counts.tolist())) > 1
    dropped = [m["moe_dropped_frac"] for m in world["want"]["mix-data4"][0]]
    assert min(dropped) > 0


@pytest.mark.parametrize("name", ["lms-pd22", "mix-pd22"])
def test_int8_pod_exchange_is_within_its_quantisation_bound(world, name):
    model, _, _, (names, shape), _ = RUNS[name]
    metrics, trail = world["want"][name]
    for out in world["out"]:
        gap = out[f"{name}/int8_gap"]
        assert gap.max() > 0                       # it did quantise
        # per element: |compressed - plain| <= mean over pods of scale/2
        assert out[f"{name}/int8_over_bound"].max() <= 1e-7 * max(
            1.0, float(gap.max()))
        sub = {k[len(name) + 1:]: v for k, v in out.items()
               if k.startswith(f"{name}/")}
        # step 0's loss and statistics see no compression yet; later the
        # MoE statistics count routes, which a perturbed update may flip
        first = {k: v[:1] for k, v in sub.items() if k.startswith("m/")}
        _check_metrics(first, metrics[:1], STEP_TOL, model == "mixtral-8x7b")
        _check_metrics(sub, metrics[:STEPS], INT8_TOL, False)
        _check_pieces(out, name, world["cfgs"][name], names, shape,
                      trail[STEPS - 1],
                      abs_tol=2 * sum(m["lr"] for m in metrics[:STEPS]))


def test_elastic_restore_onto_fewer_ranks(world):
    name = "lms-data4"
    metrics, trail = world["want"][name]
    cfg = world["cfgs"][name]
    for out in world["elastic"]:
        assert int(out["step"]) == STEPS
        assert tuple(out["coord"].shape) == (2,)
        restored = {f"{name}/p/{k[len('restored/'):]}": v
                    for k, v in out.items() if k.startswith("restored/")}
        restored[f"{name}/coord"] = out["coord"]
        # the pieces of the (2, 1) mesh: slices of what the 4 ranks held
        _check_pieces(restored, name, cfg, ("data", "model"), (2, 1),
                      trail[STEPS - 1], STEP_TOL)
        _check_metrics(out, metrics[STEPS:], STEP_TOL, False)
