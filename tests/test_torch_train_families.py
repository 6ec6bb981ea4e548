"""Training the hybrid (zamba2) and MoE (mixtral) families in the port vs
the JAX package, on the CPU.

The same numpy parameters (drawn over the port's spec tree, which is JAX's,
with the reference init's scales: JAX's own init folds the process's string
hash into its keys) and the same numpy batches go through both packages.
On the CPU the port's SSD scan and its gradient are the plain versions
(``ref.ssd_ref``; ``ref.ssd_bwd_ref``, autograd through the chunked plain
form); the kernels are held to them on the card.  Tolerances, all stated
here:

* fp32 loss 1e-5 and every gradient leaf 1e-4 (relative and absolute): the
  SSD sums run in another order (chunk 64 or the recurrence against the
  reference's chunk of 16), and the hybrid's gradients pass through 5
  Mamba2 layers;
* one train step (loss, grad norm, param norm, the updated params): 1e-4
  relative, as ``tests/test_torch_train.py``;
* remat "none", "minimal" and "full": the same gradients to 1e-6 (the same
  operations; only the order in which autograd sums a leaf's gradient may
  differ);
* MoE in fp32 with identical routes (the capacity dropping triples or not);
  in bf16 with every token routed to every expert (top-k = E: nothing to
  flip, see ``tests/test_torch_moe.py``): the loss 2e-2 and each leaf's
  gradient within 5e-2 of its largest magnitude (the bf16 model
  tolerance), the aux statistics 2e-2.
"""

import dataclasses
import math
from contextlib import nullcontext

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ssd  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.params import flatten, unflatten  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-4
REMAT_TOL = 1e-6
BF16_TOL = 2e-2
BF16_GRAD_TOL = 5e-2
MOE_KEYS = ("moe_aux_loss", "moe_dropped_frac", "moe_max_load")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _close_to_largest(got, want, tol, what=""):
    err = np.abs(_np(got) - _np(want)).max()
    assert err <= tol * max(np.abs(_np(want)).max(), 1e-30), (what, err)


def _cfgs(name, dtype="float32", *, hybrid=None, **change):
    """(JAX cfg, port cfg) of an arch's smoke config; ``hybrid`` replaces
    the hybrid layout, keyword ``moe_*`` fields the MoE config's."""
    moe = {k[4:]: change.pop(k) for k in list(change) if k.startswith("moe_")}
    out = []
    for get in (jget_config, get_config):
        cfg = dataclasses.replace(get(name, smoke=True), dtype=dtype,
                                  **change)
        if hybrid:
            cfg.hybrid = dataclasses.replace(cfg.hybrid, **hybrid)
        if moe:
            cfg.moe = dataclasses.replace(cfg.moe, **moe)
        out.append(cfg)
    return tuple(out)


HYBRIDS = {
    # the smoke config: 2 groups of 1 Mamba2 layer, both shared sets
    "smoke": {},
    # 2 groups of 2 and a trailing (rem) layer
    "rem": {"num_layers": 5, "hybrid": {"attn_every": 2,
                                        "num_shared_blocks": 2}},
}


def _np_params(tc, seed=0):
    """Flat numpy parameters over the port's spec tree, scaled as the
    reference's init scales them; the hybrid's decays (constants at init)
    drawn, so that they are not trivial."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in flatten(ttf.model_specs(tc)).items():
        if k.endswith(("A_log", "dt_bias")):
            a = 0.5 * rng.standard_normal(s.shape)
        elif s.init == "normal":
            std = s.scale if s.scale is not None else \
                1.0 / np.sqrt(max(int(np.prod(s.shape[:-1])), 1))
            a = std * rng.standard_normal(s.shape)
        else:
            a = np.full(s.shape, {"zeros": 0.0, "ones": 1.0}.get(
                s.init, s.value))
        out[k] = a.astype(np.float32)
    return out


def _batch(rng, vocab, b=2, s=32):
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _jax_loss_and_grads(flat, jc, batch, remat="none"):
    jp = jax.tree.map(jnp.asarray, unflatten(flat))
    (total, metrics), grads = jax.value_and_grad(jtf.loss_fn, has_aux=True)(
        jp, jc, {k: jnp.asarray(v) for k, v in batch.items()}, remat=remat)
    return total, metrics, {k: np.asarray(v) for k, v in
                            flatten(jax.tree.map(np.asarray, grads)).items()}


def _port_loss_and_grads(flat, tc, batch, remat="none"):
    leaves = {k: v.requires_grad_() for k, v in
              flatten(params_from_numpy(flat, tc, device="cpu")).items()}
    total, metrics = ttf.loss_fn(unflatten(leaves), tc,
                                 tstep.batch_to_device(batch, "cpu"),
                                 remat=remat)
    grads = torch.autograd.grad(total, list(leaves.values()))
    return total, metrics, dict(zip(leaves, grads))


# -- the hybrid (zamba2) ---------------------------------------------------------


@pytest.mark.parametrize("variant", list(HYBRIDS))
def test_hybrid_loss_and_grads_match_jax(rng, variant):
    jc, tc = _cfgs("zamba2-7b", **HYBRIDS[variant])
    flat = _np_params(tc)
    batch = _batch(rng, tc.vocab_size)
    jl, jm, jg = _jax_loss_and_grads(flat, jc, batch, remat="minimal")
    tl, tm, tg = _port_loss_and_grads(flat, tc, batch, remat="minimal")
    _close(tl, jl, LOSS_TOL)
    assert set(tm) == {"loss"} and tm["loss"] is tl
    assert set(tg) == set(jg)
    for k, g in tg.items():
        _close(g, jg[k], GRAD_TOL)
    if variant == "rem":
        assert ttf._layer_plan(tc) == {"hybrid_groups": 2, "hybrid_rem": 1}


def test_hybrid_grads_equal_under_every_remat_policy(rng):
    _, tc = _cfgs("zamba2-7b", **HYBRIDS["rem"])
    flat = _np_params(tc, seed=1)
    batch = _batch(rng, tc.vocab_size)
    runs = {r: _port_loss_and_grads(flat, tc, batch, remat=r)
            for r in ttf.REMAT_POLICIES}
    base_l, _, base_g = runs["none"]
    for remat in ("minimal", "full"):
        tl, _, tg = runs[remat]
        _close(tl, base_l, REMAT_TOL)
        for k, g in tg.items():
            _close(g, base_g[k], REMAT_TOL)


def test_hybrid_remat_reruns_the_checkpointed_blocks(rng):
    """Remat places as the reference: every Mamba2 block (groups and rem)
    re-runs in the backward, the shared attention blocks do not: SSD scan
    regions 2 x 5 per pass, a backward region per Mamba2 layer, norms 2 a
    Mamba2 block and 2 a shared application, + the final one, forward, and
    again for each re-run Mamba2 block."""
    _, tc = _cfgs("zamba2-7b", **HYBRIDS["rem"])
    flat = _np_params(tc)
    batch = _batch(rng, tc.vocab_size)
    names = []

    class Session:
        def region(self, name, counters=None):
            names.append(name)
            return nullcontext()
    prev = ops.set_kernel_markers(Session())
    try:
        _port_loss_and_grads(flat, tc, batch, remat="minimal")
    finally:
        ops.set_kernel_markers(prev)
    layers, groups = 5, 2
    norms = 2 * layers + 2 * groups + 1
    assert names.count("kernel:ssd_scan") == 2 * layers
    assert names.count("kernel:ssd_scan_backward") == layers
    assert names.count("kernel:rmsnorm") == norms + 2 * layers
    assert names.count("kernel:rmsnorm_backward") == norms
    assert names.count("kernel:flash_attention") == 0    # masked in train


def test_hybrid_step_flops_count_the_ssd_by_its_cost_model(rng, monkeypatch):
    """count_step_flops on a hybrid: the SSD scan forward (and its remat
    re-run) and backward add their cost-model flops to the counted
    products, and nothing is launched or computed."""
    _, tc = _cfgs("zamba2-7b", **HYBRIDS["rem"])
    params = params_from_numpy(_np_params(tc), tc, device="cpu")
    batch = tstep.batch_to_device(_batch(rng, tc.vocab_size), "cpu")
    tcfg = tbase.TrainConfig(remat_policy="minimal")
    ops.reset_launch_counts()
    got = tstep.count_step_flops(params, batch, tc, tcfg)
    assert not any(ops.launch_counts().values())
    assert all(v.grad is None for v in flatten(params).values())
    zero = {"flops": 0.0, "bytes": 0.0}
    monkeypatch.setattr(ssd, "cost_estimate", lambda *a, **k: zero)
    monkeypatch.setattr(ssd, "bwd_cost_estimate", lambda *a, **k: zero)
    products = tstep.count_step_flops(params, batch, tc, tcfg)
    monkeypatch.undo()
    s = tc.ssm
    shape = (2, s.num_heads(tc.d_model), 32, s.head_dim)
    fwd = ssd.cost_estimate(shape, s.n_groups, s.state_dim, 4)["flops"]
    bwd = ssd.bwd_cost_estimate(shape, s.n_groups, s.state_dim, 4)["flops"]
    assert got - products == tc.num_layers * (2 * fwd + bwd) > 0
    assert products > 0


# -- the MoE (mixtral) -----------------------------------------------------------


MOE_CASES = {"fp32": ("float32", {}),
             "fp32-drops": ("float32", {"moe_capacity_factor": 0.5}),
             "bf16-all-experts": ("bfloat16", {"moe_top_k": 4})}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_loss_aux_and_grads_match_jax(rng, case):
    """The total (loss + 0.01 aux / layers), the metrics (loss and the MoE
    statistics) and every gradient leaf, the router's through both the
    aux term and the gates."""
    dtype, change = MOE_CASES[case]
    jc, tc = _cfgs("mixtral-8x7b", dtype, **change)
    flat = _np_params(tc)
    batch = _batch(rng, tc.vocab_size)
    jl, jm, jg = _jax_loss_and_grads(flat, jc, batch, remat="minimal")
    tl, tm, tg = _port_loss_and_grads(flat, tc, batch, remat="minimal")
    assert set(tm) == {"loss", *MOE_KEYS}
    want_total = float(jm["loss"]) + 0.01 * float(jm["moe_aux_loss"]) / \
        tc.num_layers
    assert math.isclose(float(jl), want_total, rel_tol=1e-6)
    assert set(tg) == set(jg)
    if dtype == "float32":
        _close(tl, jl, LOSS_TOL)
        for k in ("loss", *MOE_KEYS):
            _close(tm[k], jm[k], LOSS_TOL)
        for k, g in tg.items():
            _close(g, jg[k], GRAD_TOL)
    else:
        _close(tl, jl, BF16_TOL)
        for k in ("loss", *MOE_KEYS):
            _close(tm[k], jm[k], BF16_TOL)
        for k, g in tg.items():
            _close_to_largest(g, jg[k], BF16_GRAD_TOL, k)
    assert float(torch.stack([g.abs().sum() for k, g in tg.items()
                              if k.endswith("router")]).sum()) > 0
    if case == "fp32-drops":
        assert float(tm["moe_dropped_frac"]) > 0.0


def test_moe_aux_term_reaches_the_router(rng):
    """With the CE loss's gradient cut off at the logits, the router still
    gets the aux term's gradient, as JAX's does."""
    jc, tc = _cfgs("mixtral-8x7b")
    flat = _np_params(tc)
    batch = _batch(rng, tc.vocab_size)

    def jaux(p):
        _, _, aux = jtf.forward(p, jc, tokens=jnp.asarray(batch["tokens"]),
                                mode="train")
        return aux["moe_aux_loss"]
    jg = jax.grad(jaux)(jax.tree.map(jnp.asarray, unflatten(flat)))
    leaves = {k: v.requires_grad_() for k, v in
              flatten(params_from_numpy(flat, tc, device="cpu")).items()}
    aux = {}
    ttf.forward(unflatten(leaves), tc, tokens=torch.from_numpy(
        batch["tokens"]).long(), mode="train", aux=aux)
    router = leaves["moe_layers/moe/router"]
    (g,) = torch.autograd.grad(aux["moe_aux_loss"], [router])
    _close(g, np.asarray(jg["moe_layers"]["moe"]["router"]), GRAD_TOL)
    assert float(g.abs().max()) > 0


# -- one train step of each family -------------------------------------------------


@pytest.mark.parametrize("name,change", [
    ("zamba2-7b", HYBRIDS["rem"]),
    ("mixtral-8x7b", {"moe_capacity_factor": 1.0})])
def test_train_step_matches_jax(rng, name, change):
    jc, tc = _cfgs(name, **change)
    cfg = tbase.TrainConfig(optimizer="adamw", warmup_steps=1,
                            learning_rate=3e-3, remat_policy="minimal")
    jcfg = jbase.TrainConfig(**dataclasses.asdict(cfg))
    flat = _np_params(tc)
    jp = jax.tree.map(jnp.asarray, unflatten(flat))
    jfn, _ = jstep.make_train_step(jc, jcfg)
    jstate = joptim.get_optimizer(jcfg).init(jp)
    tfn, topt = tstep.make_train_step(tc, cfg)
    tp = params_from_numpy(flat, tc, device="cpu")
    tstate = topt.init(tp)
    batch = _batch(rng, tc.vocab_size)
    jp, jstate, jm = jax.jit(jfn)(jp, jstate, {k: jnp.asarray(v) for k, v in
                                               batch.items()}, 0)
    tp, tstate, tm = tfn(tp, tstate, tstep.batch_to_device(batch, "cpu"), 0)
    keys = ("loss", "grad_norm", "param_norm", "lr")
    if tc.moe is not None:
        keys += MOE_KEYS
    for key in keys:
        assert math.isclose(float(tm[key]), float(jm[key]),
                            rel_tol=STEP_TOL, abs_tol=1e-7), key
    want = {k: np.asarray(v) for k, v in
            flatten(jax.tree.map(np.asarray, jp)).items()}
    for k, v in flatten(tp).items():
        _close(v, want[k], STEP_TOL)


# -- MFU from active parameters ------------------------------------------------------


class _Agent:
    def __init__(self):
        self.constants = {}

    def set_step_constants(self, **kw):
        self.constants.update(kw)

    def collect_step(self, **kw):
        pass


class _UM:
    markers = None

    def metric(self, *a, **k):
        pass

    def event(self, *a, **k):
        pass

    def flush(self):
        pass


class _Stack:
    """The hooks ``train()`` calls, keeping the step constants."""

    def __init__(self):
        self.agent = _Agent()

    def job(self, *a, **k):
        return nullcontext()

    def host_agent(self, host):
        return self.agent

    def usermetric(self, host=None):
        return _UM()

    def on_finding(self, fn):
        return fn

    def findings(self):
        return []


def test_moe_model_flops_count_active_parameters():
    """train()'s model flops are 6 N T with N the reference's
    ``_active_params`` (the top-k experts a token touches), not every
    parameter: for mixtral-8x7b itself about 12.9B of 46.7B."""
    jc, tc = _cfgs("mixtral-8x7b")
    shape = tbase.ShapeConfig("tiny", seq_len=16, global_batch=2,
                              kind="train")
    stack = _Stack()
    tloop.train(tc, tbase.TrainConfig(total_steps=1, monitor=False), shape,
                stack=stack, device="cpu", peak_flops=1e12, hbm_bw=1e11)
    tokens = shape.seq_len * shape.global_batch
    want = 6 * jloop._active_params(jc) * tokens
    assert stack.agent.constants["model_flops"] == want
    assert tc.active_param_count() < tc.param_count()
    full = get_config("mixtral-8x7b")
    assert full.active_param_count() == jloop._active_params(
        jget_config("mixtral-8x7b"))
    assert abs(full.param_count() / full.active_param_count() - 3.6) < 0.05
