"""The RWKV6 family (rwkv6-1.6b) in the port vs the JAX package, on the CPU.

The same numpy inputs and parameters go through both packages (the
parameters drawn over the port's spec tree, which is JAX's; the leaves that
start as constants -- the token-shift mixes, ``w0``, the norms -- drawn
around their init values so that none is trivial).  RWKV6 runs no kernel of
its own: its WKV recurrence is plain PyTorch in the port as it is jnp in the
reference, and its final norm is an RMSNorm (the config's ``norm_type``),
whose wrapper computes the plain version on the CPU.  Tolerances, all
stated here:

* ``wkv6_chunked`` against the reference's at chunks 8, 16 and 32 and at a
  length the chunk does not divide (the gcd rule), and ``wkv6_ref`` against
  the reference's: fp32 2e-4 (the reference's own, ``tests/test_ssm.py``);
* the state carried across two segments: 1e-4;
* the time mix's token-by-token decode against its chunked form: 5e-3, as
  ``tests/test_ssm.py``; against the reference's time mix 1e-4;
* the smoke model's logits in train, prefill and decode: fp32 1e-4, bf16
  5e-2 of the largest logit; the loss 1e-5; every gradient leaf 1e-4; one
  AdamW step 1e-4 relative (``tests/test_torch_train_families.py``).
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
from repro.core import MonitoringStack  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    flatten, init_params, unflatten)
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

NAME = "rwkv6-1.6b"
WKV_TOL = 2e-4
CARRY_TOL = 1e-4
DECODE_TOL = 5e-3
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-4
PEAK_ARGS = ["--peak-flops", "989e12", "--hbm-bw", "3.35e12"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _close_to_largest(got, want, tol):
    err = np.abs(_np(got) - _np(want)).max()
    assert err <= tol * np.abs(_np(want)).max(), err


def _cfgs(dtype="float32"):
    return tuple(dataclasses.replace(get(NAME, smoke=True), dtype=dtype)
                 for get in (jget_config, get_config))


def _np_params(tc, seed=0):
    """Flat numpy parameters: "normal" leaves at their init scales, the
    others drawn around their init values (w0 around -0.7, mixes around 0,
    norm scales around 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in flatten(ttf.model_specs(tc)).items():
        if s.init == "normal":
            std = s.scale if s.scale is not None else \
                1.0 / np.sqrt(max(int(np.prod(s.shape[:-1])), 1))
            a = std * rng.standard_normal(s.shape)
        else:
            base = {"zeros": 0.0, "ones": 1.0}.get(s.init, s.value)
            a = base + 0.3 * rng.standard_normal(s.shape)
        out[k] = a.astype(np.float32)
    return out


def _wkv_inputs(rng, b=2, l=64, h=2, d=8, decay=0.5):
    r, k, v = (rng.standard_normal((b, l, h, d)).astype(np.float32)
               for _ in range(3))
    logw = (-np.abs(rng.standard_normal((b, l, h, d))) * decay).astype(
        np.float32)
    u = (0.5 * rng.standard_normal((h, d))).astype(np.float32)
    return r, k, v, logw, u


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- the WKV recurrence ----------------------------------------------------------


@pytest.mark.parametrize("chunk,length", [(8, 64), (16, 64), (32, 64),
                                          (32, 42)])
def test_wkv6_chunked_matches_jax(rng, chunk, length):
    """At 42 tokens the chunk of 32 shrinks to gcd(42, 32) = 2 in both."""
    args = _wkv_inputs(rng, l=length)
    jy, js = jssm.wkv6_chunked(*_j(*args), chunk=chunk)
    ty, ts = tssm.wkv6_chunked(*_t(*args), chunk=chunk)
    _close(ty, jy, WKV_TOL)
    _close(ts, js, WKV_TOL)
    want, _ = jref.wkv6_ref(*_j(*args))
    _close(ty, want, WKV_TOL)


def test_wkv6_ref_matches_jax(rng):
    args = _wkv_inputs(rng, l=40)
    want, none = jref.wkv6_ref(*_j(*args))
    got, state = tref.wkv6_ref(*_t(*args))
    assert none is None and state.shape == (2, 2, 8, 8)
    _close(got, want, WKV_TOL)
    _, js = jssm.wkv6_chunked(*_j(*args), chunk=8)
    _close(state, js, WKV_TOL)


def test_wkv6_state_carry(rng):
    """Two segments, the second from the first's state, against one pass;
    and against the reference's second segment."""
    r, k, v, logw, u = _wkv_inputs(rng, b=1, l=32, decay=0.3)
    y_full, s_full = tssm.wkv6_chunked(*_t(r, k, v, logw, u), chunk=8)
    half = 16
    first = _t(r[:, :half], k[:, :half], v[:, :half], logw[:, :half], u)
    second = [r[:, half:], k[:, half:], v[:, half:], logw[:, half:], u]
    y1, s1 = tssm.wkv6_chunked(*first, chunk=8)
    y2, s2 = tssm.wkv6_chunked(*_t(*second), chunk=8, init_state=s1)
    _close(torch.cat([y1, y2], dim=1), y_full, CARRY_TOL)
    _close(s2, s_full, CARRY_TOL)
    jy2, js2 = jssm.wkv6_chunked(*_j(*second), chunk=8,
                                 init_state=jnp.asarray(s1.numpy()))
    _close(y2, jy2, CARRY_TOL)
    _close(s2, js2, CARRY_TOL)


@pytest.mark.parametrize("decay", [0.05, 5.0, 50.0])
def test_wkv6_stays_finite_under_strong_decay(rng, decay):
    args = _wkv_inputs(rng, b=1, l=16, h=1, d=4, decay=decay)
    y, s = tssm.wkv6_chunked(*_t(*args), chunk=8)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    jy, _ = jssm.wkv6_chunked(*_j(*args), chunk=8)
    _close(y, jy, WKV_TOL)


def test_wkv6_gradients_match_jax(rng):
    """The within-chunk scores' hand-written backward (one query row at a
    time) inside the chunked form: the gradients of every input against
    ``jax.grad`` of the reference's ``wkv6_chunked``."""
    args = _wkv_inputs(rng, l=32)
    w = rng.standard_normal((2, 32, 2, 8)).astype(np.float32)

    def jloss(r, k, v, logw, u):
        y, s = jssm.wkv6_chunked(r, k, v, logw, u, chunk=16)
        return jnp.sum(y * jnp.asarray(w)) + jnp.sum(s)
    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*_j(*args))
    leaves = [t.requires_grad_() for t in _t(*args)]
    y, s = tssm.wkv6_chunked(*leaves, chunk=16)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum() + s.sum(),
                              leaves)
    for g, jg in zip(got, want):
        _close(g, jg, 1e-4)


def test_wkv_intra_backward_passes_gradcheck():
    gen = torch.Generator().manual_seed(0)
    rc, kc = (torch.randn((1, 2, 5, 2, 3), generator=gen,
                          dtype=torch.float64, requires_grad=True)
              for _ in range(2))
    w = -torch.rand((1, 2, 5, 2, 3), generator=gen, dtype=torch.float64)
    lp = w.cumsum(2)
    lp_excl = (lp - w).requires_grad_()
    assert torch.autograd.gradcheck(tssm._WKVIntra.apply,
                                    (rc, kc, lp_excl, lp.requires_grad_()))


# -- the time mix ------------------------------------------------------------------


def _layer_params(tc):
    """Layer 0 of the smoke model's parameters (numpy)."""
    return {k.split("/", 1)[1]: v[0] for k, v in _np_params(tc).items()
            if k.startswith("layers/")}


def test_time_mix_matches_jax_and_decode_matches_chunked(rng):
    jc, tc = _cfgs()
    layer = _layer_params(tc)
    x = (0.5 * rng.standard_normal((2, 12, tc.d_model))).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in layer.items()}
    jp = {k: jnp.asarray(v) for k, v in layer.items()}
    jy, _ = jssm.rwkv6_time_mix(jp, jnp.asarray(x), jc, mode="train")
    ty, _ = tssm.rwkv6_time_mix(tp, torch.from_numpy(x), tc, mode="train")
    _close(ty, jy, 1e-4)
    cache = init_params(tssm.rwkv6_cache_specs(tc, 2), device="cpu")
    outs = []
    for t in range(12):
        y_t, cache = tssm.rwkv6_time_mix(tp, torch.from_numpy(x[:, t:t + 1]),
                                         tc, mode="decode", cache=cache)
        outs.append(y_t)
    _close(torch.cat(outs, dim=1), ty, DECODE_TOL)


# -- the smoke model ----------------------------------------------------------------


def test_param_counts_match_jax():
    for smoke in (False, True):
        jc, tc = jget_config(NAME, smoke=smoke), get_config(NAME, smoke=smoke)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
    # the reference's count, which the port copies: 7 d x d matrices and
    # the decay LoRA twice, against 6 and once in the spec tree
    full = get_config(NAME)
    leaves = sum(math.prod(s.shape)
                 for s in flatten(ttf.model_specs(full)).values())
    assert full.param_count() == 1_706_033_152
    assert leaves == 1_599_866_880


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_train_logits_match_jax(rng, dtype):
    jc, tc = _cfgs(dtype)
    flat = _np_params(tc)
    toks = rng.integers(0, tc.vocab_size, (2, 40))
    jl, _, _ = jtf.forward(jax.tree.map(jnp.asarray, unflatten(flat)), jc,
                           tokens=jnp.asarray(toks), mode="train")
    with torch.no_grad():
        tl, _ = ttf.forward(params_from_numpy(flat, tc, device="cpu"), tc,
                            tokens=torch.from_numpy(toks), mode="train")
    _close_to_largest(tl, jl, MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_prefill_and_decode_match_jax(rng, dtype):
    """Prefill of 21 tokens (chunk gcd(21, 32) = 1 in both), then 4 decode
    steps; the caches (shifts in the compute dtype, WKV state fp32) too."""
    jc, tc = _cfgs(dtype)
    tol = MODEL_TOL[dtype]
    flat = _np_params(tc)
    jp = jax.tree.map(jnp.asarray, unflatten(flat))
    tp = params_from_numpy(flat, tc, device="cpu")
    toks = rng.integers(0, tc.vocab_size, (2, 21))
    jcache = jtf.init_cache(jc, 2, 32)
    jl, jcache, _ = jtf.forward(jp, jc, tokens=jnp.asarray(toks),
                                mode="prefill", cache=jcache)
    tcache = ttf.init_cache(tc, 2, 32, device="cpu")
    assert tcache["shift_tm"].dtype == getattr(torch, dtype)
    assert tcache["wkv"].dtype == torch.float32
    with torch.inference_mode():
        tl, tcache = ttf.forward(tp, tc, tokens=torch.from_numpy(toks),
                                 mode="prefill", cache=tcache)
    _close_to_largest(tl, jl, tol)
    _close_to_largest(tcache["wkv"], jcache["wkv"], tol)
    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    for step in range(4):
        jl, jcache, _ = jtf.forward(
            jp, jc, tokens=jnp.asarray(nxt[:, None], jnp.int32),
            mode="decode", cache=jcache, pos=jnp.int32(21 + step))
        with torch.inference_mode():
            tl, tcache = ttf.forward(
                tp, tc, tokens=torch.from_numpy(nxt[:, None].copy()),
                mode="decode", cache=tcache, pos=21 + step)
        _close_to_largest(tl, jl, tol)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    for key in ("shift_tm", "shift_cm", "wkv"):
        _close_to_largest(tcache[key], jcache[key], tol)


def _batch(rng, vocab, b=2, s=32):
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


@pytest.mark.parametrize("remat", ["none", "minimal"])
def test_rwkv6_loss_and_grads_match_jax(rng, remat):
    jc, tc = _cfgs()
    flat = _np_params(tc)
    batch = _batch(rng, tc.vocab_size)
    jp = jax.tree.map(jnp.asarray, unflatten(flat))
    (jl, _), jg = jax.value_and_grad(jtf.loss_fn, has_aux=True)(
        jp, jc, {k: jnp.asarray(v) for k, v in batch.items()}, remat=remat)
    jg = {k: np.asarray(v) for k, v in
          flatten(jax.tree.map(np.asarray, jg)).items()}
    leaves = {k: v.requires_grad_() for k, v in
              flatten(params_from_numpy(flat, tc, device="cpu")).items()}
    tl, tm = ttf.loss_fn(unflatten(leaves), tc,
                         tstep.batch_to_device(batch, "cpu"), remat=remat)
    tg = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    _close(tl, jl, LOSS_TOL)
    assert set(tm) == {"loss"}
    assert set(tg) == set(jg)
    for k, g in tg.items():
        _close(g, jg[k], GRAD_TOL)


def test_rwkv6_train_step_matches_jax(rng):
    jc, tc = _cfgs()
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
    for key in ("loss", "grad_norm", "param_norm", "lr"):
        assert math.isclose(float(tm[key]), float(jm[key]),
                            rel_tol=STEP_TOL, abs_tol=1e-7), key
    want = {k: np.asarray(v) for k, v in
            flatten(jax.tree.map(np.asarray, jp)).items()}
    for k, v in flatten(tp).items():
        _close(v, want[k], STEP_TOL)


def test_rwkv6_launches_only_the_final_norm(rng):
    """RWKV6's norms are LayerNorms but its final norm, an RMSNorm (the
    config's norm type), which goes through the RMSNorm wrapper once a
    forward; on the CPU the wrappers count no launch, so the calls are
    counted through a marker session."""
    _, tc = _cfgs()
    regions = []

    class Session:
        def region(self, name, counters=None):
            regions.append(name)
            return nullcontext()
    prev = ops.set_kernel_markers(Session())
    try:
        eng = tengine.ServingEngine(
            tc, params_from_numpy(_np_params(tc), tc, device="cpu"),
            max_batch=2, max_len=32, device="cpu")
        for n in (5, 9):
            eng.submit(rng.integers(1, tc.vocab_size, n), max_new_tokens=3)
        eng.run_until_empty()
    finally:
        ops.set_kernel_markers(prev)
    assert regions == ["kernel:rmsnorm"] * 3


def test_engine_serves_rwkv6_as_the_reference_engine(rng):
    """Greedy tokens of the two engines on the same weights and prompts
    (fp32), prompts of unequal length (right-aligned, BOS-padded)."""
    jc, tc = _cfgs()
    flat = _np_params(tc)
    prompts = [rng.integers(1, tc.vocab_size, n).astype(np.int32)
               for n in (7, 12, 3)]
    jeng = jengine.ServingEngine(jc, jax.tree.map(jnp.asarray,
                                                  unflatten(flat)),
                                 max_batch=3, max_len=32, jit=False)
    teng = tengine.ServingEngine(tc, params_from_numpy(flat, tc,
                                                       device="cpu"),
                                 max_batch=3, max_len=32, device="cpu")
    outs = []
    for eng in (jeng, teng):
        for p in prompts:
            eng.submit(p, max_new_tokens=5)
        outs.append([r.output for r in eng.run_until_empty()])
    assert outs[0] == outs[1]


# -- the CLIs -------------------------------------------------------------------------


@pytest.fixture
def stack(tmp_path):
    st = MonitoringStack.inprocess(out_dir=str(tmp_path / "lms"),
                                   serve_http=True)
    try:
        yield st
    finally:
        st.close()


def _cli_args(stack):
    return ["--smoke", "--device", "cpu", "--lms-url", stack.http.url,
            *PEAK_ARGS]


def test_serve_cli_serves_rwkv6(stack, capsys):
    assert serve_cli.main(["--arch", NAME, "--requests", "3",
                           "--max-new-tokens", "3",
                           *_cli_args(stack)]) == 0
    assert "served 3 requests" in capsys.readouterr().out


def test_train_cli_trains_rwkv6(stack, capsys):
    assert train_cli.main(["--arch", NAME, "--steps", "2", "--seq-len",
                           "16", "--global-batch", "2",
                           *_cli_args(stack)]) == 0
    assert "done: steps=2 " in capsys.readouterr().out
