"""PyTorch port's Mamba2/SSD path and hybrid (zamba2) model vs the JAX
package, on the CPU.

The same numpy inputs go through the JAX function (the Pallas SSD kernel in
interpret mode, its jnp oracle, or ``models.ssm.ssd_chunked``) and the
port's counterpart.  On a CPU tensor the port's SSD wrapper computes its
plain version (the sequential recurrence); the CUDA kernel itself is held
against that plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  Tolerances: the reference's own (tests/test_kernels.py,
tests/test_ssm.py): SSD fp32 2e-3 against the Pallas kernel and its oracle,
2e-4 against ``ssd_chunked``; layers fp32 1e-5; the mamba2 block and the
model fp32 1e-4 elementwise, bf16 5e-2 of the largest value (as
``chip_smoke.py``'s model check): in bf16 the two frameworks round the block
differently (the reference rounds the chunk products' operands, the decay
pair and, at a ragged length, each step's state contribution to bf16; the
port keeps the scan in fp32), and each bf16 run carries percent-level
rounding noise that grows with depth.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    flatten, init_params, unflatten)
from repro_torch.serve.engine import ServingEngine  # noqa: E402


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _close_to_largest(got, want, tol):
    """max |got - want| <= tol * max |want|."""
    err = np.abs(_np(got) - _np(want)).max()
    assert err <= tol * np.abs(_np(want)).max(), err


def _checker(dtype):
    return _close if dtype == "float32" else _close_to_largest


def _t(arr, dtype=torch.float32):
    return torch.from_numpy(np.array(arr)).to(dtype)


def _ssd_inputs(rng, b, l, h, p, n, g=None, decay=0.1):
    """Model-layout SSD inputs: x (B,L,H,P), a (B,L,H) <= 0, b/c (B,L,G,N)."""
    g = g or h
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    a = (-np.abs(rng.standard_normal((b, l, h))) * decay).astype(np.float32)
    bm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    return x, a, bm, cm


def _heads(m, h):
    """(B, L, G, N) -> (B, L, H, N), group broadcast as the reference does."""
    return np.repeat(m, h // m.shape[2], axis=2)


# -- the SSD scan: plain version vs the Pallas kernel, its oracle and
#    ssd_chunked -----------------------------------------------------------


@pytest.mark.parametrize("l,chunk,p,n", [(256, 64, 32, 16), (128, 128, 16, 8),
                                         (192, 64, 8, 4)])
def test_ssd_plain_matches_pallas_and_oracle(rng, l, chunk, p, n):
    b, h = 2, 3
    x, a, bm, cm = _ssd_inputs(rng, b, l, h, p, n)
    y, state = ops.ssd_chunked_kernel(_t(x), _t(a), _t(bm), _t(cm))
    assert y.shape == (b, l, h, p) and state.shape == (b, h, p, n)
    assert state.dtype == torch.float32
    jx, ja, jb, jc = (jnp.asarray(v) for v in (x, a, bm, cm))
    pallas = jops.ssd_chunked_kernel(jx, ja, jb, jc, chunk=chunk,
                                     interpret=True)
    oracle = jref.ssd_ref(jx.transpose(0, 2, 1, 3), ja.transpose(0, 2, 1),
                          jb.transpose(0, 2, 1, 3), jc.transpose(0, 2, 1, 3)
                          ).transpose(0, 2, 1, 3)
    _close(y, pallas, 2e-3)
    _close(y, oracle, 2e-3)


@pytest.mark.parametrize("l,g,init", [(37, 1, False), (50, 3, True),
                                      (61, 1, True), (1, 1, False)])
def test_ssd_final_state_and_ragged_l_match_ssd_chunked(rng, l, g, init):
    """Any L (not a multiple of any chunk), b/c shared by the heads of a
    group, an optional initial state: y and the final state against the
    reference's chunked scan (which falls back to gcd(L, chunk))."""
    b, h, p, n = 2, 6, 8, 4
    x, a, bm, cm = _ssd_inputs(rng, b, l, h, p, n, g=g, decay=0.3)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if init \
        else None
    y, state = ops.ssd_chunked_kernel(
        _t(x), _t(a), _t(bm), _t(cm), None if s0 is None else _t(s0))
    jy, jstate = jssm.ssd_chunked(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(_heads(bm, h)),
        jnp.asarray(_heads(cm, h)), chunk=16,
        init_state=None if s0 is None else jnp.asarray(s0))
    _close(y, jy, 2e-4)
    _close(state, jstate, 2e-4)


def test_ssd_prefill_then_decode_state_chaining(rng):
    """A scan over L/2 steps, then the rest from its final state, then
    recurrent steps: the same y and state as one scan over everything."""
    b, l, h, p, n = 1, 40, 2, 4, 4
    x, a, bm, cm = _ssd_inputs(rng, b, l, h, p, n, decay=0.2)
    tx, ta, tb, tc = _t(x), _t(a), _t(bm), _t(cm)
    y_full, s_full = ops.ssd_chunked_kernel(tx, ta, tb, tc)
    y1, s1 = ops.ssd_chunked_kernel(tx[:, :16], ta[:, :16], tb[:, :16],
                                    tc[:, :16])
    y2, s2 = ops.ssd_chunked_kernel(tx[:, 16:30], ta[:, 16:30], tb[:, 16:30],
                                    tc[:, 16:30], s1)
    ys, s = [y1, y2], s2
    for t in range(30, l):                     # decode, one step at a time
        yt, s = ops.ssd_chunked_kernel(tx[:, t:t + 1], ta[:, t:t + 1],
                                       tb[:, t:t + 1], tc[:, t:t + 1], s)
        ys.append(yt)
    _close(torch.cat(ys, dim=1), y_full, 1e-5)
    _close(s, s_full, 1e-5)
    jy, js = jssm.ssd_chunked(*(jnp.asarray(v) for v in (x, a, bm, cm)),
                              chunk=8)
    _close(y_full, jy, 2e-4)
    _close(s_full, js, 2e-4)


def test_ssd_strong_decay_stays_finite_and_exact(rng):
    """Brutal decay (as tests/test_kernels.py): no overflow, and the plain
    version still matches the reference oracle."""
    b, l, h, p, n = 1, 128, 1, 8, 4
    x, a, bm, cm = _ssd_inputs(rng, b, l, h, p, n, decay=20.0)
    y, state = ops.ssd_chunked_kernel(_t(x), _t(a), _t(bm), _t(cm))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    jx, ja, jb, jc = (jnp.asarray(v) for v in (x, a, bm, cm))
    want = jref.ssd_ref(jx.transpose(0, 2, 1, 3), ja.transpose(0, 2, 1),
                        jb.transpose(0, 2, 1, 3), jc.transpose(0, 2, 1, 3)
                        ).transpose(0, 2, 1, 3)
    _close(y, want, 2e-3)


def test_ssd_bf16_plain_matches_oracle(rng):
    """bf16 inputs, fp32 arithmetic, y rounded to bf16: the bf16 tolerance
    against the reference oracle fed the same bf16 values."""
    b, l, h, p, n = 2, 96, 4, 16, 8
    x, a, bm, cm = _ssd_inputs(rng, b, l, h, p, n, g=1)
    y, _ = ops.ssd_chunked_kernel(_t(x, torch.bfloat16), _t(a),
                                  _t(bm, torch.bfloat16),
                                  _t(cm, torch.bfloat16))
    assert y.dtype == torch.bfloat16
    jx, jb, jc = (jnp.asarray(v, jnp.bfloat16)
                  for v in (x, _heads(bm, h), _heads(cm, h)))
    want = jref.ssd_ref(jx.transpose(0, 2, 1, 3),
                        jnp.asarray(a).transpose(0, 2, 1),
                        jb.transpose(0, 2, 1, 3), jc.transpose(0, 2, 1, 3)
                        ).transpose(0, 2, 1, 3)
    _close(y, want, 2e-2)


def test_ssd_cost_estimate():
    """The served shape (B=8, L=910, H=112, P=N=64, one group) at the
    kernel's chunk of 64: the within-chunk products over the causal pairs
    of 14 full chunks and a 14-step tail, ~20.1 GFLOP; ~0.23 GB."""
    c = ssd.cost_estimate((8, 112, 910, 64), 1, 64, 2)
    steps = 8 * 112 * 910
    pairs = 14 * 64 * 65 // 2 + 14 * 15 // 2
    assert ssd.causal_pairs(910) == pairs
    assert c["flops"] == 8 * 112 * (2.0 * 128 * pairs) \
        + steps * 4.0 * 64 * 64
    assert c["bytes"] == (steps * 2 * 64 * 2 + 8 * 910 * 2 * 64 * 2
                          + steps * 4 + 8 * 112 * 64 * 64 * 4)
    assert abs(c["flops"] / 1e9 - 20.06) < 0.01
    assert abs(c["bytes"] / 1e9 - 0.2285) < 0.001
    with_init = ssd.cost_estimate((8, 112, 910, 64), 1, 64, 2,
                                  init_state=True)
    assert with_init["bytes"] - c["bytes"] == 8 * 112 * 64 * 64 * 4
    assert ssd.cost_estimate((1, 2, 10, 8), 2, 4, 4)["flops"] == \
        1 * 2 * (2.0 * 12 * 55 + 4.0 * 8 * 4 * 10)


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 4, 8, 16)
    a = torch.zeros(1, 4, 8)
    b = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError, match="expected"):
        ssd.ssd_scan(x, a[..., None], b, b)
    with pytest.raises(ValueError, match="does not match"):
        ssd.ssd_scan(x, torch.zeros(1, 4, 9), b, b)
    with pytest.raises(ValueError, match="multiple of groups"):
        ssd.ssd_scan(x, a, torch.zeros(1, 3, 8, 8), torch.zeros(1, 3, 8, 8))
    with pytest.raises(ValueError, match="a must be float32"):
        ssd.ssd_scan(x, a.bfloat16(), b, b)
    with pytest.raises(ValueError, match="share a dtype"):
        ssd.ssd_scan(x, a, b.bfloat16(), b)
    with pytest.raises(ValueError, match="init_state"):
        ssd.ssd_scan(x, a, b, b, torch.zeros(1, 4, 8, 16))
    with pytest.raises(ValueError, match="no steps"):
        ssd.ssd_scan(x[:, :, :0], a[:, :, :0], b[:, :, :0], b[:, :, :0])
    with pytest.raises(ValueError, match="init_state must be float32"):
        ssd.ssd_scan(x, a, b, b,
                     torch.zeros(1, 4, 16, 8, dtype=torch.bfloat16))


class _Session:
    def __init__(self):
        self.regions = []

    def region(self, name, counters=None):
        self.regions.append((name, dict(counters or {})))
        return _NullRegion()


class _NullRegion:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_cpu_ssd_launches_nothing_and_marker_carries_costs(rng):
    x, a, bm, cm = _ssd_inputs(rng, 2, 20, 4, 8, 4, g=1)
    ops.reset_launch_counts()
    session = _Session()
    prev = ops.set_kernel_markers(session)
    try:
        ops.ssd_chunked_kernel(_t(x), _t(a), _t(bm), _t(cm),
                               torch.zeros(2, 4, 8, 4))
    finally:
        assert ops.set_kernel_markers(prev) is session
    assert ops.launch_counts()["ssd_scan"] == 0
    assert session.regions == [("kernel:ssd_scan", ssd.cost_estimate(
        (2, 4, 20, 8), 1, 4, 4, init_state=True))]


# -- layers of the Mamba2 block ----------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_rmsnorm_gated_matches_jax(rng, dtype, tol):
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    z = rng.standard_normal((2, 5, 48)).astype(np.float32)
    sc = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    want = jlayers.rmsnorm_gated(jnp.asarray(sc),
                                 jnp.asarray(x, getattr(jnp, dtype)),
                                 jnp.asarray(z, getattr(jnp, dtype)))
    got = tlayers.rmsnorm_gated(_t(sc), _t(x, getattr(torch, dtype)),
                                _t(z, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, tol)


@pytest.mark.parametrize("l,history", [(9, False), (9, True), (1, True),
                                       (2, False)])
def test_causal_conv_matches_jax(rng, l, history):
    xbc = rng.standard_normal((2, l, 24)).astype(np.float32)
    w = (0.5 * rng.standard_normal((4, 24))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(24)).astype(np.float32)
    s0 = rng.standard_normal((2, 3, 24)).astype(np.float32) if history \
        else None
    jy, js = jssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                               jnp.asarray(bias),
                               None if s0 is None else jnp.asarray(s0))
    ty, ts = tssm._causal_conv(_t(xbc), _t(w), _t(bias),
                               None if s0 is None else _t(s0))
    _close(ty, jy, 1e-5)
    _close(ts, js, 1e-5)


def _mamba_params(rng, cfg):
    """Random Mamba2 block params (numpy), with non-trivial decays."""
    specs = tssm.mamba2_specs(cfg)
    p = {}
    for k, s in specs.items():
        scale = 0.5 if k == "conv_w" else 1.0 / np.sqrt(s.shape[0])
        p[k] = (scale * rng.standard_normal(s.shape)).astype(np.float32)
    p["A_log"] = (0.5 * rng.standard_normal(p["A_log"].shape)).astype(
        np.float32)
    p["norm_scale"] = (1 + 0.1 * rng.standard_normal(
        p["norm_scale"].shape)).astype(np.float32)
    return p


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_mamba2_block_prefill_and_decode_match_jax(rng, dtype, tol):
    """Prefill of a ragged length from the zero cache, then 12 decode steps
    through the cache: outputs, conv tail and SSM state against JAX."""
    jc = dataclasses.replace(jget_config("zamba2-7b", smoke=True), dtype=dtype)
    tc = dataclasses.replace(get_config("zamba2-7b", smoke=True), dtype=dtype)
    p = _mamba_params(rng, tc)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    check = _checker(dtype)
    b, l = 2, 13
    xs = rng.standard_normal((b, l + 12, tc.d_model)).astype(np.float32)
    jcache = jssm.mamba2_init_cache(jc, b, dtype=jdt)
    tcache = init_params(tssm.mamba2_cache_specs(tc, b, tdt), device="cpu")
    with torch.inference_mode():
        jy, jcache = jssm.mamba2_block(jp, jnp.asarray(xs[:, :l], jdt), jc,
                                       mode="prefill", cache=jcache)
        ty, tcache = tssm.mamba2_block(tp, _t(xs[:, :l], tdt), tc,
                                       mode="prefill", cache=tcache)
        check(ty, jy, tol)
        check(tcache["conv"], jcache["conv"], tol)
        check(tcache["ssm"], jcache["ssm"], tol)
        for t in range(l, l + 12):
            jy, jcache = jssm.mamba2_block(
                jp, jnp.asarray(xs[:, t:t + 1], jdt), jc, mode="decode",
                cache=jcache)
            ty, tcache = tssm.mamba2_block(tp, _t(xs[:, t:t + 1], tdt), tc,
                                           mode="decode", cache=tcache)
            check(ty, jy, tol)
        check(tcache["ssm"], jcache["ssm"], tol)
        check(tcache["conv"], jcache["conv"], tol)
    assert tcache["ssm"].dtype == torch.float32


# -- the hybrid model --------------------------------------------------------


def _hybrid_cfgs(dtype):
    """zamba2-7b smoke widths, 5 Mamba2 layers in 2 groups of 2 (each group
    followed by a shared attention block, the two weight sets alternating)
    and 1 layer after the last group."""
    change = dict(num_layers=5, dtype=dtype)
    jc = dataclasses.replace(jget_config("zamba2-7b", smoke=True), **change)
    tc = dataclasses.replace(get_config("zamba2-7b", smoke=True), **change)
    hyb = dict(attn_every=2, num_shared_blocks=2)
    jc.hybrid = dataclasses.replace(jc.hybrid, **hyb)
    tc.hybrid = dataclasses.replace(tc.hybrid, **hyb)
    return jc, tc


def _np_params(tc, seed=0):
    """Random hybrid parameters from numpy, flat, over the port's spec tree
    (which is JAX's: ``test_model_specs_match_jax_layouts``), scaled as the
    reference's init scales them, with non-trivial decays (``A_log`` and
    ``dt_bias`` are constants at init).  JAX's own init seeds each leaf
    from the process's string hash, so it differs between processes."""
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


def test_hybrid_layer_plan_uses_both_shared_sets_and_rem():
    _, tc = _hybrid_cfgs("float32")
    assert ttf._layer_plan(tc) == {"hybrid_groups": 2, "hybrid_rem": 1}
    specs = flatten(ttf.model_specs(tc))
    assert specs["groups/in_proj"].shape[:2] == (2, 2)
    assert specs["rem/in_proj"].shape[0] == 1
    assert specs["shared/attn/wq"].shape[0] == 2


def _hybrid_run(params, cfg, toks, nxt_tokens=None, *, jax_side):
    """Prefill on ``toks``, then 4 decode steps: the logits of the last
    position at each step and the caches.  The decode tokens are the
    prefill's and each step's argmax, unless ``nxt_tokens`` gives them."""
    b, s = toks.shape
    outs, fed = [], []
    if jax_side:
        cache = jtf.init_cache(cfg, b, 24)
        logits, cache, _ = jtf.forward(params, cfg, tokens=jnp.asarray(
            toks, jnp.int32), mode="prefill", cache=cache)
    else:
        cache = ttf.init_cache(cfg, b, 24, device="cpu")
        logits, cache = ttf.forward(params, cfg, tokens=torch.from_numpy(
            toks), mode="prefill", cache=cache)
    # the port writes its caches in place: keep the prefill's as a copy
    caches = [cache if jax_side else
              unflatten({k: v.clone() for k, v in flatten(cache).items()})]
    for step in range(5):
        last = _np(logits[:, -1])
        outs.append(last)
        if step == 4:
            break
        nxt = np.argmax(last, axis=-1)[:, None] if nxt_tokens is None \
            else nxt_tokens[step]
        fed.append(nxt)
        if jax_side:
            logits, cache, _ = jtf.forward(
                params, cfg, tokens=jnp.asarray(nxt, jnp.int32),
                mode="decode", cache=cache, pos=jnp.int32(s + step))
        else:
            logits, cache = ttf.forward(
                params, cfg, tokens=torch.from_numpy(nxt.copy()),
                mode="decode", cache=cache, pos=s + step)
    caches.append(cache)
    return outs, fed, caches


def test_hybrid_forward_prefill_and_decode_match_jax_fp32(rng):
    """Prefill plus 4 decode steps, fp32: logits, SSM states and conv
    tails elementwise at 1e-4; the KV caches are bf16 in both (rounded
    from near-equal fp32 values), so they are held at the bf16 2e-2."""
    jc, tc = _hybrid_cfgs("float32")
    flat = _np_params(tc)
    toks = rng.integers(0, tc.vocab_size, (2, 11))
    want, fed, jcaches = _hybrid_run(
        jax.tree.map(jnp.asarray, unflatten(flat)), jc, toks, jax_side=True)
    with torch.inference_mode():
        got, _, tcaches = _hybrid_run(
            params_from_numpy(flat, tc, device="cpu"), tc, toks, fed,
            jax_side=False)
    for g, w in zip(got, want):
        _close(g, w, 1e-4)
    for tcache, jcache in zip(tcaches, jcaches):    # after prefill, at end
        for part in ("groups", "rem"):
            _close(tcache[part]["ssm"], jcache[part]["ssm"], 1e-4)
            _close(tcache[part]["conv"], jcache[part]["conv"], 1e-4)
        _close(tcache["shared_attn"]["k"], jcache["shared_attn"]["k"], 2e-2)
        _close(tcache["shared_attn"]["v"], jcache["shared_attn"]["v"], 2e-2)
    assert tcaches[-1]["groups"]["ssm"].dtype == torch.float32
    assert tcaches[-1]["shared_attn"]["k"].dtype == torch.bfloat16


def test_hybrid_forward_prefill_and_decode_match_jax_bf16(rng):
    """Prefill plus 4 decode steps in bf16, on the same decode tokens, at
    5e-2 of the largest logit, on the zamba2-7b smoke config (2 groups of
    one Mamba2 layer, each followed by a shared block; both weight sets).
    The bf16 rounding noise grows with depth: on the 5-layer config the
    reference's own bf16 run sits 3-6% of the largest logit from its fp32
    run, the size of the tolerance, while here both stay within ~3%."""
    jc = dataclasses.replace(jget_config("zamba2-7b", smoke=True),
                             dtype="bfloat16")
    tc = dataclasses.replace(get_config("zamba2-7b", smoke=True),
                             dtype="bfloat16")
    flat = _np_params(tc)
    toks = rng.integers(0, tc.vocab_size, (2, 11))
    want, fed, _ = _hybrid_run(jax.tree.map(jnp.asarray, unflatten(flat)),
                               jc, toks, jax_side=True)
    with torch.inference_mode():
        got, _, tcaches = _hybrid_run(
            params_from_numpy(flat, tc, device="cpu"), tc, toks, fed,
            jax_side=False)
    for g, w in zip(got, want):
        _close_to_largest(g, w, 5e-2)
    assert tcaches[-1]["groups"]["conv"].dtype == torch.bfloat16
    assert tcaches[-1]["groups"]["ssm"].dtype == torch.float32


def test_hybrid_greedy_tokens_match_jax_engine(rng):
    jc, tc = _hybrid_cfgs("float32")
    flat = _np_params(tc, seed=1)
    jp = jax.tree.map(jnp.asarray, unflatten(flat))
    tp = params_from_numpy(flat, tc, device="cpu")
    prompts = [rng.integers(1, 500, size=n).astype(np.int32)
               for n in (5, 9, 3, 12, 7)]
    jeng = JaxEngine(jc, jp, max_batch=4, max_len=32)
    teng = ServingEngine(tc, tp, max_batch=4, max_len=32, device="cpu")
    for p in prompts:
        jeng.submit(p, max_new_tokens=5)
        teng.submit(p, max_new_tokens=5)
    want = [r.output for r in jeng.run_until_empty()]
    got = [r.output for r in teng.run_until_empty()]
    assert got == want
    assert all(len(o) == 5 for o in got)


def test_hybrid_bridge_keeps_decay_and_norm_leaves_fp32():
    jc, tc = _hybrid_cfgs("bfloat16")
    flat = flatten(jax.tree.map(np.asarray, jtf.init_model_params(jc, 0)))
    tp = flatten(params_from_numpy(flat, tc, device="cpu",
                                   compute_dtype=torch.bfloat16))
    assert set(tp) == set(flat)
    for k, v in tp.items():
        leaf = k.rsplit("/", 1)[-1]
        fp32 = leaf in ("scale", "norm_scale", "A_log", "dt_bias")
        assert v.dtype == (torch.float32 if fp32 else torch.bfloat16), k
        assert tuple(v.shape) == flat[k].shape
    # the doubly stacked leaves carry over value for value
    np.testing.assert_array_equal(tp["groups/A_log"].numpy(),
                                  flat["groups/A_log"])
    init = flatten(ttf.init_model_params(tc, device="cpu",
                                         compute_dtype=torch.bfloat16))
    assert init["groups/dt_bias"].dtype == torch.float32
    assert init["rem/norm_scale"].dtype == torch.float32
    assert init["groups/in_proj"].dtype == torch.bfloat16


def test_hybrid_kernel_markers_count_per_forward(rng):
    """One prefill: an ssd_scan region per Mamba2 layer, a flash region per
    shared-attention application, and 2 * layers + 2 * groups + 1 norms."""
    jc, tc = _hybrid_cfgs("float32")
    tp = params_from_numpy(_np_params(tc), tc, device="cpu")
    session = _Session()
    prev = ops.set_kernel_markers(session)
    try:
        with torch.inference_mode():
            ttf.forward(tp, tc, tokens=torch.from_numpy(
                rng.integers(0, 500, (1, 6))), mode="prefill",
                cache=ttf.init_cache(tc, 1, 8, device="cpu"))
    finally:
        ops.set_kernel_markers(prev)
    names = [n for n, _ in session.regions]
    assert names.count("kernel:ssd_scan") == 5
    assert names.count("kernel:flash_attention") == 2
    assert names.count("kernel:rmsnorm") == 2 * 5 + 2 * 2 + 1
