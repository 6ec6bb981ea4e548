"""The port's MoE FFN and the mixtral model vs the JAX package, on the CPU.

The same numpy inputs and parameters go through ``repro.models.moe`` and
``repro_torch.models.moe``: the routing (experts, keep mask, slot of every
(token, expert) triple) must be equal, ``y`` within 1e-5 of max|y| in fp32
and 2e-2 in bf16, and the aux statistics equal to 1e-6.  The mixtral smoke
model (4 experts, top-2, a sliding window of 16 over prompts longer than
it) is held to the JAX forward in prefill and decode: fp32 1e-4, bf16 5e-2.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.params import ParamSpec  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402

Y_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the MoE configurations the dispatch is held to: the smoke default (no
# drops), a capacity that drops triples, two dispatch groups, one shared
# expert
CASES = {"default": {},
         "drops": {"capacity_factor": 0.5},
         "groups": {"dispatch_groups": 2, "capacity_factor": 1.0},
         "shared": {"num_shared_experts": 1, "d_ff_shared": 32}}


def _cfgs(name="mixtral-8x7b", dtype="float32", **moe):
    jc = dataclasses.replace(jget_config(name, smoke=True), dtype=dtype)
    tc = dataclasses.replace(get_config(name, smoke=True), dtype=dtype)
    if moe:
        jc.moe = dataclasses.replace(jc.moe, **moe)
        tc.moe = dataclasses.replace(tc.moe, **moe)
    return jc, tc


def _to_torch(tree, dtype=torch.float32):
    return {k: (_to_torch(v, dtype) if isinstance(v, dict) else
                torch.from_numpy(np.array(v)).to(dtype))
            for k, v in tree.items()}


def _numpy_params(specs, seed=0):
    """Parameters of a JAX spec tree from a numpy seed, with the init's
    scales: the JAX init folds Python's per-process string hash into each
    leaf's key, so its weights differ from process to process."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if s.init == "normal":
            fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 \
                else (s.shape[0] if s.shape else 1)
            std = s.scale if s.scale is not None else 1.0 / np.sqrt(fan_in)
            return (rng.standard_normal(s.shape) * std).astype(np.float32)
        if s.init == "constant":
            return np.full(s.shape, s.value, np.float32)
        return (np.ones if s.init == "ones" else np.zeros)(s.shape,
                                                           np.float32)
    return jax.tree.map(leaf, specs,
                        is_leaf=lambda x: isinstance(x, ParamSpec))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _routes(jc, tc, jp, tp, xn, dtype):
    """Each package's dispatch of group 0 from its own router logits."""
    m = tc.moe
    b, s, d = xn.shape
    g = m.dispatch_groups if (b * s) % m.dispatch_groups == 0 else 1
    tg = b * s // g
    cap = tmoe.capacity(tc, tg)
    assert cap == jmoe.capacity(jc, tg)
    jx = jnp.asarray(xn, getattr(jnp, dtype)).reshape(g, tg, d)
    jlog = jnp.einsum("gtd,de->gte", jx, jp["router"].astype(jnp.float32))
    _, jstate, jstats = jmoe._dispatch_group(jx[0], jlog[0], jc, cap)
    tx = torch.from_numpy(xn).to(getattr(torch, dtype)).reshape(g, tg, d)
    tlog = tx.float() @ tp["router"].float()
    _, tstate, tstats = tmoe._dispatch_group(tx[0], tlog[0], tc, cap)
    _, jexp, _ = jmoe.route_topk(jlog[0], m.top_k)
    _, texp, _ = tmoe.route_topk(tlog[0], m.top_k)
    return (np.asarray(jexp), texp.numpy(), jstate, tstate, jstats, tstats,
            m.num_experts * cap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_matches_jax(rng, case, dtype):
    jc, tc = _cfgs(dtype=dtype, **CASES[case])
    pn = _numpy_params(jmoe.moe_specs(jc))
    jp = jax.tree.map(jnp.asarray, pn)
    tp = _to_torch(pn)
    xn = rng.standard_normal((2, 40, tc.d_model)).astype(np.float32)
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(xn, getattr(jnp, dtype)), jc)
    ty, taux = tmoe.apply_moe(tp, torch.from_numpy(xn).to(
        getattr(torch, dtype)), tc)
    assert ty.dtype == getattr(torch, dtype) and ty.shape == xn.shape

    jexp, texp, jst, tst, jstats, tstats, dummy = _routes(jc, tc, pn, tp, xn,
                                                          dtype)
    np.testing.assert_array_equal(texp, jexp)           # expert choice
    jbuf, jtok, _ = (np.asarray(a) for a in jst)
    tbuf, ttok, _ = (a.numpy() for a in tst)
    np.testing.assert_array_equal(tbuf != dummy, jbuf != dummy)  # keep mask
    np.testing.assert_array_equal(tbuf, jbuf)           # slot of each triple
    np.testing.assert_array_equal(ttok, jtok)
    for k in ("aux_loss", "dropped", "max_load"):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-6, atol=1e-6)

    want = _np(jy)
    err = np.abs(_np(ty) - want).max()
    assert err <= Y_TOL[dtype] * np.abs(want).max(), err
    for k in ("moe_aux_loss", "moe_dropped_frac", "moe_max_load"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-6, atol=1e-6)
    if case == "drops":
        assert float(taux["moe_dropped_frac"]) > 0.0
    elif case != "groups":                       # capacity factor 4: none
        assert float(taux["moe_dropped_frac"]) == 0.0


def test_route_topk_ties_go_to_the_lower_expert():
    """Equal probabilities: the lower expert index first, as lax.top_k."""
    logits = np.array([[0.0, 0.0, 0.0, 0.0], [1.0, 2.0, 2.0, 0.0],
                       [3.0, -1.0, 3.0, 3.0], [0.5, 0.5, 1.0, 0.5]],
                      np.float32)
    jg, je, _ = jmoe.route_topk(jnp.asarray(logits), 2)
    tg, te, _ = tmoe.route_topk(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(te.numpy(), [[0, 1], [1, 2], [0, 2],
                                               [2, 0]])
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)


def test_capacity_matches_jax():
    jc, tc = _cfgs()
    for n in (1, 4, 7, 40, 24000):
        assert tmoe.capacity(tc, n) == jmoe.capacity(jc, n)
    full = get_config("mixtral-8x7b")
    assert tmoe.capacity(full, 24000) == 7504 and \
        tmoe.capacity(full, 8) == 8


@pytest.mark.parametrize("case", ["default", "drops"])
def test_a2a_without_a_mesh_runs_the_grouped_dispatch(rng, case):
    """``impl="a2a"`` without a mesh is the grouped dispatch, as the
    reference's ``apply_moe`` falls back to it: same output and statistics
    on the same params, and the dispatch counter says which ran."""
    jc, tc = _cfgs(impl="a2a", **CASES[case])
    pn = _numpy_params(jmoe.moe_specs(jc))
    xn = rng.standard_normal((2, 40, tc.d_model)).astype(np.float32)
    jy, jaux = jmoe.apply_moe(jax.tree.map(jnp.asarray, pn),
                              jnp.asarray(xn), jc)
    tmoe.reset_dispatch_counts()
    ty, taux = tmoe.apply_moe(_to_torch(pn), torch.from_numpy(xn), tc)
    assert tmoe.dispatch_counts() == {"grouped": 1, "a2a": 0}
    want = _np(jy)
    assert np.abs(_np(ty) - want).max() <= Y_TOL["float32"] * \
        np.abs(want).max()
    for k in ("moe_aux_loss", "moe_dropped_frac", "moe_max_load"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-6, atol=1e-6)


def test_unported_dispatch_raises():
    """The all-to-all dispatch itself needs a mesh: without one it raises
    (``apply_moe`` falls back before it gets there)."""
    _, tc = _cfgs(impl="a2a")
    p = _to_torch(jax.tree.map(np.asarray, jinit_params(
        jmoe.moe_specs(_cfgs()[0]), seed=0)))
    x = torch.zeros(1, 8, tc.d_model)
    with pytest.raises(ValueError, match="mesh"):
        tmoe.apply_moe_a2a(p, x, tc, mesh=None)


# -- the mixtral model ----------------------------------------------------------


@pytest.mark.parametrize("dtype,tol,top_k", [("float32", 1e-4, 2),
                                              ("bfloat16", 5e-2, 4)])
def test_mixtral_prefill_and_decode_match_jax(rng, dtype, tol, top_k):
    """Prompts of 40 tokens against a window of 16: prefill fills the ring
    from the prompt's tail and decode wraps it; aux statistics as JAX's.
    The cache has the compute dtype, so that in fp32 its contents are held
    to 1e-4 too (a bf16 cache rounds fp32 neighbours a unit apart).

    The top-2 routing is held in fp32.  In bf16 the two frameworks round
    each layer's activations differently, which flips a near-tied second
    expert of some token in about half of the seeds tried at this width
    and moves that token's logits by more than 5e-2; so the bf16 run routes
    every token to all 4 experts (top_k = E), which keeps the dispatch,
    the expert products, the gates and the combine in bf16 but has no
    route to flip."""
    jc, tc = _cfgs(dtype=dtype, top_k=top_k)
    cdt = getattr(torch, dtype)
    assert tc.sliding_window == 16
    pn = _numpy_params(jtf.model_specs(jc))
    jp = jax.tree.map(jnp.asarray, pn)
    tp = params_from_numpy(pn, tc, device="cpu")
    s = 40
    toks = rng.integers(0, tc.vocab_size, (2, s))
    jcache = jtf.init_cache(jc, 2, 64, dtype=getattr(jnp, dtype))
    jl, jcache, jaux = jtf.forward(jp, jc, tokens=jnp.asarray(toks, jnp.int32),
                                   mode="prefill", cache=jcache)
    tcache = ttf.init_cache(tc, 2, 64, dtype=cdt, device="cpu")
    assert tcache["moe"]["k"].shape == (tc.num_layers, 2, 16,
                                        tc.num_kv_heads, tc.head_dim)
    aux = {}
    with torch.inference_mode():
        tl, tcache = ttf.forward(tp, tc, tokens=torch.from_numpy(toks),
                                 mode="prefill", cache=tcache, aux=aux)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(tcache["moe"]["k"]),
                               _np(jcache["moe"]["k"]), rtol=tol, atol=tol)
    # in bf16 the router sees each layer's rounded activations, so the
    # statistics carry the model tolerance
    aux_tol = 1e-5 if dtype == "float32" else tol
    for k in ("moe_aux_loss", "moe_dropped_frac", "moe_max_load"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=aux_tol, atol=aux_tol)
    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    for step in range(20):                       # past the next wrap
        pos = s + step
        jl, jcache, _ = jtf.forward(
            jp, jc, tokens=jnp.asarray(nxt[:, None], jnp.int32),
            mode="decode", cache=jcache, pos=jnp.int32(pos))
        with torch.inference_mode():
            tl, tcache = ttf.forward(
                tp, tc, tokens=torch.from_numpy(nxt[:, None].copy()),
                mode="decode", cache=tcache, pos=pos)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=tol, atol=tol)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    np.testing.assert_allclose(_np(tcache["moe"]["v"]),
                               _np(jcache["moe"]["v"]), rtol=tol, atol=tol)


@pytest.mark.parametrize("router_dtype", ["float32", "bfloat16"])
def test_bridge_carries_the_moe_leaves(router_dtype):
    """Router fp32 when routing is fp32, the expert stacks cast once."""
    jc, tc = _cfgs(router_dtype=router_dtype)
    flat = flatten(jax.tree.map(np.asarray, jtf.init_model_params(jc, 0)))
    tp = flatten(params_from_numpy(flat, tc, device="cpu",
                                   compute_dtype=torch.bfloat16))
    assert set(tp) == set(flat)
    router = tp["moe_layers/moe/router"]
    assert router.dtype == (torch.float32 if router_dtype == "float32"
                            else torch.bfloat16)
    assert torch.equal(router.float(), torch.from_numpy(np.array(
        flat["moe_layers/moe/router"])).to(router.dtype).float())
    for k in ("w_gate", "w_up", "w_down"):
        leaf = tp[f"moe_layers/moe/{k}"]
        assert leaf.dtype == torch.bfloat16
        assert leaf.shape == (tc.num_layers, tc.moe.num_experts) + \
            tuple(flat[f"moe_layers/moe/{k}"].shape[2:])
    assert tp["moe_layers/ln2/scale"].dtype == torch.float32


def test_moe_config_has_the_reference_fields_and_defaults():
    from repro.configs.base import MoEConfig as JMoE
    from repro_torch.configs import MoEConfig as TMoE
    args = {"num_experts": 8, "top_k": 2, "d_ff_expert": 64}
    assert dataclasses.asdict(TMoE(**args)) == dataclasses.asdict(JMoE(**args))


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", ["phi3-medium-14b", "yi-34b",
                                  "nemotron-4-340b", "mixtral-8x7b",
                                  "deepseek-v2-236b", "qwen2-vl-7b"])
def test_new_configs_are_copies_of_the_reference(name, smoke):
    """Every field, full and smoke-reduced (mixtral's window 16, the MLA
    config and the M-RoPE sections included), and the parameter counts."""
    assert dataclasses.asdict(get_config(name, smoke=smoke)) == \
        dataclasses.asdict(jget_config(name, smoke=smoke))
    tc, jc = get_config(name, smoke=smoke), jget_config(name, smoke=smoke)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
