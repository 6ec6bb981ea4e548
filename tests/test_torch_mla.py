"""The MLA family (deepseek-v2-236b) in the port vs the JAX package, on the
CPU.

The same numpy parameters and inputs go through both packages.  On the CPU
the flash adapter runs around the plain attention (``ref.attention_ref``),
V zero-padded to Q's and K's head dim as on the card; the JAX prefill runs
``chunked_attention``.  Tolerances, all stated here:

* ``mla_attention`` (smoke width: qk 16 + 8, v 16, lora 32 / 48) in train,
  prefill (the latent caches written) and decode (the absorbed form):
  fp32 2e-5, the reference's attention tolerance; bf16 2e-2 of the largest
  output (the two frameworks round the bf16 products at other places);
* the flash adapter with Dv < Dqk against JAX's ``chunked_attention``:
  fp32 2e-5;
* the smoke model's logits in train, prefill and decode: fp32 1e-4, bf16
  5e-2 with every expert routed (top-k = E: a near-tied expert cannot flip
  in bf16, see ``tests/test_torch_moe.py``);
* the loss (with the MoE aux term) 1e-5 and every gradient leaf 1e-4, as
  ``tests/test_torch_train_families.py``; one AdamW and one Adafactor
  train step 1e-4 relative.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.params import flatten, unflatten  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

NAME = "deepseek-v2-236b"
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-4
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


def _cfgs(dtype="float32", **moe):
    out = []
    for get in (jget_config, get_config):
        cfg = dataclasses.replace(get(NAME, smoke=True), dtype=dtype)
        if moe:
            cfg.moe = dataclasses.replace(cfg.moe, **moe)
        out.append(cfg)
    return tuple(out)


def _np_params(specs, seed=0):
    """Flat numpy parameters over a spec tree, with the reference init's
    scales; the norm scales drawn near 1, so that they are not trivial."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in flatten(specs).items():
        if s.init == "normal":
            std = s.scale if s.scale is not None else \
                1.0 / np.sqrt(max(int(np.prod(s.shape[:-1])), 1))
            a = std * rng.standard_normal(s.shape)
        elif s.init == "ones":
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            a = np.zeros(s.shape)
        out[k] = a.astype(np.float32)
    return out


def _rope(cfg, pos0, s, jax_side):
    pos = np.arange(pos0, pos0 + s)[None, :]
    hd = cfg.mla.qk_rope_head_dim
    if jax_side:
        return jlayers.rope_table(jnp.asarray(pos), hd, cfg.rope_theta)
    return tlayers.rope_table(torch.from_numpy(pos), hd, cfg.rope_theta)


# -- the attention block -----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,attn_impl", [(12, "masked"), (512, "recursive")])
def test_mla_attention_train_matches_jax(rng, dtype, s, attn_impl):
    jc, tc = _cfgs(dtype)
    pn = _np_params(tattn.mla_specs(tc))
    x = rng.standard_normal((2, s, tc.d_model)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jy, _ = jattn.mla_attention(
        {k: jnp.asarray(v) for k, v in pn.items()}, jnp.asarray(x, jdt), jc,
        rope=_rope(jc, 0, s, True), mode="train", attn_impl=attn_impl)
    ty, _ = tattn.mla_attention(
        {k: torch.from_numpy(v) for k, v in pn.items()},
        torch.from_numpy(x).to(tdt), tc, rope=_rope(tc, 0, s, False),
        mode="train", attn_impl=attn_impl)
    assert ty.dtype == tdt and ty.shape == x.shape
    _close_to_largest(ty, jy, ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attention_prefill_and_decode_match_jax(rng, dtype):
    """Prefill writes ckv / krope into slots [0, S) in place; then decode
    steps attend in the latent space against the caches; outputs and cache
    contents at every step."""
    jc, tc = _cfgs(dtype)
    pn = _np_params(tattn.mla_specs(tc))
    jp = {k: jnp.asarray(v) for k, v in pn.items()}
    tp = {k: torch.from_numpy(v) for k, v in pn.items()}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = ATTN_TOL[dtype]
    b, s, max_len = 2, 10, 16
    a = tc.mla
    jcache = {"ckv": jnp.zeros((b, max_len, a.kv_lora_rank), jdt),
              "krope": jnp.zeros((b, max_len, a.qk_rope_head_dim), jdt)}
    tcache = {"ckv": torch.zeros((b, max_len, a.kv_lora_rank), dtype=tdt),
              "krope": torch.zeros((b, max_len, a.qk_rope_head_dim),
                                   dtype=tdt)}
    x = rng.standard_normal((b, s, tc.d_model)).astype(np.float32)
    jy, jcache = jattn.mla_attention(jp, jnp.asarray(x, jdt), jc,
                                     rope=_rope(jc, 0, s, True),
                                     mode="prefill", cache=jcache)
    ptrs = {k: v.data_ptr() for k, v in tcache.items()}
    ty, out = tattn.mla_attention(tp, torch.from_numpy(x).to(tdt), tc,
                                  rope=_rope(tc, 0, s, False),
                                  mode="prefill", cache=tcache)
    assert out is tcache and {k: v.data_ptr() for k, v in out.items()} == \
        ptrs
    _close_to_largest(ty, jy, tol)
    for k in ("ckv", "krope"):
        _close_to_largest(tcache[k], jcache[k], tol)
        assert not tcache[k][:, s:].any()
    for step in range(3):
        pos = s + step
        x = rng.standard_normal((b, 1, tc.d_model)).astype(np.float32)
        jy, jcache = jattn.mla_attention(jp, jnp.asarray(x, jdt), jc,
                                         rope=_rope(jc, pos, 1, True),
                                         mode="decode", cache=jcache,
                                         pos=jnp.int32(pos))
        ty, tcache = tattn.mla_attention(tp, torch.from_numpy(x).to(tdt), tc,
                                         rope=_rope(tc, pos, 1, False),
                                         mode="decode", cache=tcache,
                                         pos=pos)
        _close_to_largest(ty, jy, tol)
        for k in ("ckv", "krope"):
            _close_to_largest(tcache[k], jcache[k], tol)


def test_mla_norms_run_through_the_rmsnorm_wrapper_at_eps_1e6(rng,
                                                             monkeypatch):
    """q_norm and kv_norm go through the kernel wrapper (with ln1 and ln2
    4 launches a layer on the card) at eps 1e-6; kv_norm reads the latent
    in place, the first kv_lora_rank columns of the wkv_a output's rows, as
    rows of that output's stride (``rms.rows``), with no copy."""
    _, tc = _cfgs()
    pn = _np_params(tattn.mla_specs(tc))
    calls = []
    rmsnorm = ops._rmsnorm

    def spy(x, scale, eps):
        calls.append((tuple(x.shape), eps, x.is_contiguous(), rms.rows(x)))
        return rmsnorm(x, scale, eps)
    monkeypatch.setattr(ops, "_rmsnorm", spy)
    x = torch.from_numpy(rng.standard_normal((2, 5, tc.d_model)).astype(
        np.float32))
    tattn.mla_attention({k: torch.from_numpy(v) for k, v in pn.items()}, x,
                        tc, rope=_rope(tc, 0, 5, False), mode="train")
    a = tc.mla
    latent = a.kv_lora_rank + a.qk_rope_head_dim
    assert calls == [((2, 5, a.q_lora_rank), 1e-6, True,
                      (10, a.q_lora_rank)),
                     ((2, 5, a.kv_lora_rank), 1e-6, False, (10, latent))]


# -- the flash adapter with a narrower V ---------------------------------------------


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2)])
def test_flash_adapter_with_narrower_v_matches_chunked_attention(rng, h, kv):
    """Q and K 24 wide, V 16: the adapter pads V for the kernel's one head
    dim and returns its first 16 columns; the scale stays 1/sqrt(24)."""
    b, s = 2, 37
    q = rng.standard_normal((b, s, h, 24)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, 24)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, 16)).astype(np.float32)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True)
    got = ops.flash_attention_bshd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True)
    assert got.shape == (b, s, h, 16)
    _close(got, want, ATTN_TOL["float32"])


def test_flash_adapter_refuses_a_wider_v():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="wider"):
        ops.flash_attention_bshd(q, q, torch.zeros(1, 8, 2, 24))


def test_flash_cost_counts_v_at_its_own_width():
    """deepseek's MLA prefill: 2 (192 + 128) operations an attended pair,
    q and k read at 192, v read and o written at 128."""
    pairs = 910 * 911 // 2
    got = fa.cost_estimate((8, 128, 910, 192), 128, 2, causal=True, dv=128)
    assert got["flops"] == 2.0 * 8 * 128 * (192 + 128) * pairs
    assert got["bytes"] == 2.0 * 8 * 910 * 128 * (2 * 192 + 2 * 128)
    same = fa.cost_estimate((8, 32, 910, 128), 8, 2, causal=True)
    assert same == fa.cost_estimate((8, 32, 910, 128), 8, 2, causal=True,
                                    dv=128)


# -- the smoke model ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepseek_prefill_and_decode_match_jax(rng, dtype):
    """Prefill, then 4 decode steps (the absorbed form against the latent
    caches), from numpy params on both sides; caches in the compute dtype
    so that fp32 holds them to 1e-4 too."""
    top_k = {"float32": 2, "bfloat16": 4}[dtype]
    jc, tc = _cfgs(dtype, top_k=top_k)
    tol = MODEL_TOL[dtype]
    flat = _np_params(ttf.model_specs(tc))
    jp = jax.tree.map(jnp.asarray, unflatten(flat))
    tp = params_from_numpy(flat, tc, device="cpu")
    toks = rng.integers(0, tc.vocab_size, (2, 12))
    jcache = jtf.init_cache(jc, 2, 24, dtype=getattr(jnp, dtype))
    jl, jcache, jaux = jtf.forward(jp, jc, tokens=jnp.asarray(toks, jnp.int32),
                                   mode="prefill", cache=jcache)
    tcache = ttf.init_cache(tc, 2, 24, dtype=getattr(torch, dtype),
                            device="cpu")
    assert set(tcache) == {"dense", "moe"}
    assert tcache["moe"]["ckv"].shape == (1, 2, 24, tc.mla.kv_lora_rank)
    with torch.inference_mode():
        tl, tcache = ttf.forward(tp, tc, tokens=torch.from_numpy(toks),
                                 mode="prefill", cache=tcache)
    _close_to_largest(tl, jl, tol)
    for g in ("dense", "moe"):
        for k in ("ckv", "krope"):
            _close_to_largest(tcache[g][k], jcache[g][k], tol)
    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    for step in range(4):
        pos = 12 + step
        jl, jcache, _ = jtf.forward(
            jp, jc, tokens=jnp.asarray(nxt[:, None], jnp.int32),
            mode="decode", cache=jcache, pos=jnp.int32(pos))
        with torch.inference_mode():
            tl, tcache = ttf.forward(
                tp, tc, tokens=torch.from_numpy(nxt[:, None].copy()),
                mode="decode", cache=tcache, pos=pos)
        _close_to_largest(tl, jl, tol)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))


def _batch(rng, vocab, b=2, s=32):
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepseek_train_logits_match_jax(rng, dtype):
    top_k = {"float32": 2, "bfloat16": 4}[dtype]
    jc, tc = _cfgs(dtype, top_k=top_k)
    flat = _np_params(ttf.model_specs(tc))
    toks = _batch(rng, tc.vocab_size)["tokens"]
    jl, _, jaux = jtf.forward(jax.tree.map(jnp.asarray, unflatten(flat)), jc,
                              tokens=jnp.asarray(toks), mode="train")
    aux = {}
    with torch.no_grad():
        tl, _ = ttf.forward(params_from_numpy(flat, tc, device="cpu"), tc,
                            tokens=torch.from_numpy(toks).long(),
                            mode="train", aux=aux)
    _close_to_largest(tl, jl, MODEL_TOL[dtype])
    for k in MOE_KEYS:
        _close(aux[k], jaux[k], 1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("remat", ["none", "minimal"])
def test_deepseek_loss_aux_and_grads_match_jax(rng, remat):
    """fp32, identical routes: the total (loss + 0.01 aux / layers), the
    MoE statistics and every gradient leaf (the MLA leaves, q_norm and
    kv_norm included) against ``jax.value_and_grad``."""
    jc, tc = _cfgs()
    flat = _np_params(ttf.model_specs(tc))
    batch = _batch(rng, tc.vocab_size)
    jp = jax.tree.map(jnp.asarray, unflatten(flat))
    (jl, jm), jg = jax.value_and_grad(jtf.loss_fn, has_aux=True)(
        jp, jc, {k: jnp.asarray(v) for k, v in batch.items()}, remat=remat)
    jg = {k: np.asarray(v) for k, v in
          flatten(jax.tree.map(np.asarray, jg)).items()}
    leaves = {k: v.requires_grad_() for k, v in
              flatten(params_from_numpy(flat, tc, device="cpu")).items()}
    tl, tm = ttf.loss_fn(unflatten(leaves), tc,
                         tstep.batch_to_device(batch, "cpu"), remat=remat)
    tg = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    _close(tl, jl, LOSS_TOL)
    assert set(tm) == {"loss", *MOE_KEYS}
    for k in ("loss", *MOE_KEYS):
        _close(tm[k], jm[k], LOSS_TOL)
    assert set(tg) == set(jg)
    for k, g in tg.items():
        _close(g, jg[k], GRAD_TOL)
    assert float(tg["moe_layers/attn/kv_norm"].abs().max()) > 0


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_deepseek_train_step_matches_jax(rng, optimizer):
    jc, tc = _cfgs(capacity_factor=1.0)
    cfg = tbase.TrainConfig(optimizer=optimizer, warmup_steps=1,
                            learning_rate=3e-3, remat_policy="minimal")
    jcfg = jbase.TrainConfig(**dataclasses.asdict(cfg))
    flat = _np_params(ttf.model_specs(tc))
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
    for key in ("loss", "grad_norm", "param_norm", "lr", *MOE_KEYS):
        assert math.isclose(float(tm[key]), float(jm[key]),
                            rel_tol=STEP_TOL, abs_tol=1e-7), key
    want = {k: np.asarray(v) for k, v in
            flatten(jax.tree.map(np.asarray, jp)).items()}
    for k, v in flatten(tp).items():
        _close(v, want[k], STEP_TOL)


# -- configs, the bridge, MFU ----------------------------------------------------------


def test_bridge_carries_every_mla_leaf_and_keeps_the_latent_norms_fp32():
    jc, tc = _cfgs()
    flat = flatten(jax.tree.map(np.asarray, jtf.init_model_params(jc, 0)))
    tp = flatten(params_from_numpy(flat, tc, device="cpu",
                                   compute_dtype=torch.bfloat16))
    assert set(tp) == set(flat)
    mla = {k for k in tp if "/attn/" in k}
    assert {k.rsplit("/", 1)[-1] for k in mla} == {
        "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}
    for k in mla:
        want = torch.from_numpy(np.array(flat[k]))
        if k.endswith(("q_norm", "kv_norm")):
            assert tp[k].dtype == torch.float32 and torch.equal(tp[k], want)
        else:
            assert tp[k].dtype == torch.bfloat16
            assert torch.equal(tp[k], want.to(torch.bfloat16))
    assert {"q_norm", "kv_norm"} <= set(tparams.fp32_leaves(tc))


@pytest.mark.parametrize("smoke", [False, True])
def test_param_counts_match_the_reference(smoke):
    jc, tc = jget_config(NAME, smoke=smoke), get_config(NAME, smoke=smoke)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count() == \
        jloop._active_params(jc)
    if not smoke:
        assert tc.active_param_count() < tc.param_count() / 9
