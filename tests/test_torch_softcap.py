"""The attention logit softcap in the port vs the JAX package, on the CPU.

No shipped config sets ``attn_logit_softcap``, so the tests set it on smoke
configs.  Scores become ``cap * tanh(scores / cap)`` before the mask in
every plain attention path, in both packages; a capped GQA model prefills
through ``chunked_attention`` (the reference's prefill, whose kernel takes
no cap) and never trains through flash; MLA ignores the cap, as the
reference's ``mla_attention`` does.  Tolerances, all stated here: the
attention functions in fp32 2e-5 (the reference's attention tolerance);
the capped models' logits fp32 1e-4 and bf16 5e-2 of the largest logit, the
loss 1e-5 and every gradient leaf 1e-4, as the other model tests.
"""

import dataclasses
from contextlib import nullcontext

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.params import flatten, unflatten  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ATTN_TOL = 2e-5
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
CAP = 2.0          # small against the scores, so that the cap bites


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _close_to_largest(got, want, tol):
    err = np.abs(_np(got) - _np(want)).max()
    assert err <= tol * np.abs(_np(want)).max(), err


def _qkv(rng, b=2, s=24, h=4, kv=2, d=16, scale=3.0):
    return [(scale * rng.standard_normal((b, s, n, d))).astype(np.float32)
            for n in (h, kv, kv)]


def _both(arrays):
    return [jnp.asarray(a) for a in arrays], \
        [torch.from_numpy(a) for a in arrays]


# -- the attention functions ------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"causal": True}, {"causal": False}, {"causal": True, "window": 5},
    {"causal": False, "kv_valid": 10, "q_offset": 9}])
def test_full_attention_softcap_matches_jax(rng, kw):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(rng))
    if "kv_valid" in kw:
        jq, tq = jq[:, :1], tq[:, :1]
    want = jattn.full_attention(jq, jk, jv, softcap=CAP, **kw)
    got = tattn.full_attention(tq, tk, tv, softcap=CAP, **kw)
    _close(got, want, ATTN_TOL)
    uncapped = tattn.full_attention(tq, tk, tv, **kw)
    assert float((uncapped - got).abs().max()) > 1e-2      # the cap bites


@pytest.mark.parametrize("s,levels", [(256, 1), (512, 3)])
def test_recursive_causal_attention_softcap_matches_jax(rng, s, levels):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(rng, b=1, s=s))
    want = jattn.recursive_causal_attention(jq, jk, jv, levels=levels,
                                            softcap=CAP)
    got = tattn.recursive_causal_attention(tq, tk, tv, levels=levels,
                                           softcap=CAP)
    _close(got, want, ATTN_TOL)
    _close(got, tattn.full_attention(tq, tk, tv, softcap=CAP), ATTN_TOL)


@pytest.mark.parametrize("s,chunk_k,kw", [
    (48, 16, {"causal": True}), (48, 20, {"causal": True}),
    (40, 1024, {"causal": True, "window": 7}), (33, 8, {"causal": False})])
@pytest.mark.parametrize("cap", [0.0, CAP])
def test_chunked_attention_matches_jax(rng, s, chunk_k, kw, cap):
    """A chunk that does not divide S shrinks to gcd(S, chunk) in both."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(rng, s=s))
    want = jattn.chunked_attention(jq, jk, jv, chunk_k=chunk_k, softcap=cap,
                                   **kw)
    got = tattn.chunked_attention(tq, tk, tv, chunk_k=chunk_k, softcap=cap,
                                  **kw)
    _close(got, want, ATTN_TOL)


# -- capped models ------------------------------------------------------------------


def _cfgs(name="lms-demo", dtype="float32", cap=CAP):
    return tuple(dataclasses.replace(get(name, smoke=True), dtype=dtype,
                                     attn_logit_softcap=cap)
                 for get in (jget_config, get_config))


def _np_params(tc, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in flatten(ttf.model_specs(tc)).items():
        if k.endswith(("attn/wq", "attn/wk")):
            # 3x the init's scale, so that the scores pass the cap
            a = 3.0 / np.sqrt(tc.d_model) * rng.standard_normal(s.shape)
        elif s.init == "normal":
            std = s.scale if s.scale is not None else \
                1.0 / np.sqrt(max(int(np.prod(s.shape[:-1])), 1))
            a = std * rng.standard_normal(s.shape)
        else:
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        out[k] = a.astype(np.float32)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_capped_model_prefill_and_decode_match_jax(rng, dtype):
    """The capped prefill runs the plain chunked path (no flash call: the
    wrapper's marker region never opens), then decode steps; both against
    the reference's, whose logits differ from the uncapped model's."""
    jc, tc = _cfgs(dtype=dtype)
    tol = MODEL_TOL[dtype]
    flat = _np_params(tc)
    jp = jax.tree.map(jnp.asarray, unflatten(flat))
    tp = params_from_numpy(flat, tc, device="cpu")
    toks = rng.integers(0, tc.vocab_size, (2, 20))
    jcache = jtf.init_cache(jc, 2, 32, dtype=getattr(jnp, dtype))
    jl, jcache, _ = jtf.forward(jp, jc, tokens=jnp.asarray(toks),
                                mode="prefill", cache=jcache)
    regions = []

    class Session:
        def region(self, name, counters=None):
            regions.append(name)
            return nullcontext()
    prev = ops.set_kernel_markers(Session())
    try:
        tcache = ttf.init_cache(tc, 2, 32, dtype=getattr(torch, dtype),
                                device="cpu")
        with torch.inference_mode():
            tl, tcache = ttf.forward(tp, tc, tokens=torch.from_numpy(toks),
                                     mode="prefill", cache=tcache)
    finally:
        ops.set_kernel_markers(prev)
    assert "kernel:flash_attention" not in regions
    _close_to_largest(tl, jl, tol)
    uncapped, _, _ = jtf.forward(jp, _cfgs(dtype=dtype, cap=0.0)[0],
                                 tokens=jnp.asarray(toks), mode="train")
    assert float(jnp.abs(uncapped[:, -1] - jl[:, -1]).max()) > \
        10 * tol * float(jnp.abs(jl).max())
    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    for step in range(3):
        jl, jcache, _ = jtf.forward(
            jp, jc, tokens=jnp.asarray(nxt[:, None], jnp.int32),
            mode="decode", cache=jcache, pos=jnp.int32(20 + step))
        with torch.inference_mode():
            tl, tcache = ttf.forward(
                tp, tc, tokens=torch.from_numpy(nxt[:, None].copy()),
                mode="decode", cache=tcache, pos=20 + step)
        _close_to_largest(tl, jl, tol)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))


@pytest.mark.parametrize("attn_impl", ["masked", "recursive", "flash"])
def test_capped_model_train_logits_match_jax(rng, attn_impl):
    """Train mode with the cap: "flash" runs the masked path (as the
    reference's), so it differentiates; "recursive" takes the cap at 512
    tokens."""
    jc, tc = _cfgs()
    flat = _np_params(tc)
    toks = rng.integers(0, tc.vocab_size, (1, 512))
    jl, _, _ = jtf.forward(jax.tree.map(jnp.asarray, unflatten(flat)), jc,
                           tokens=jnp.asarray(toks), mode="train",
                           attn_impl=attn_impl)
    leaves = {k: v.requires_grad_() for k, v in
              flatten(params_from_numpy(flat, tc, device="cpu")).items()}
    tl, _ = ttf.forward(unflatten(leaves), tc, tokens=torch.from_numpy(toks),
                        mode="train", attn_impl=attn_impl)
    _close_to_largest(tl, jl, MODEL_TOL["float32"])
    tl.sum().backward()                   # never the forward-only kernel
    assert leaves["dense_layers/attn/wq"].grad is not None


def test_capped_model_loss_and_grads_match_jax(rng):
    jc, tc = _cfgs()
    flat = _np_params(tc)
    toks = rng.integers(0, tc.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    (jl, _), jg = jax.value_and_grad(jtf.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, unflatten(flat)), jc,
        {k: jnp.asarray(v) for k, v in batch.items()}, remat="minimal")
    jg = {k: np.asarray(v) for k, v in
          flatten(jax.tree.map(np.asarray, jg)).items()}
    leaves = {k: v.requires_grad_() for k, v in
              flatten(params_from_numpy(flat, tc, device="cpu")).items()}
    tl, _ = ttf.loss_fn(unflatten(leaves), tc,
                        tstep.batch_to_device(batch, "cpu"), remat="minimal")
    tg = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    _close(tl, jl, LOSS_TOL)
    for k, g in tg.items():
        _close(g, jg[k], GRAD_TOL)


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_capped_mla_gives_the_reference_uncapped_result(rng, mode):
    """The reference's ``mla_attention`` never reads the cap: a capped
    deepseek smoke model gives its uncapped logits there, and so in the
    port."""
    jc, tc = _cfgs("deepseek-v2-236b")
    flat = _np_params(tc)
    toks = rng.integers(0, tc.vocab_size, (2, 12))
    jp = jax.tree.map(jnp.asarray, unflatten(flat))
    jl, _, _ = jtf.forward(jp, jc, tokens=jnp.asarray(toks), mode="train")
    j0, _, _ = jtf.forward(jp, _cfgs("deepseek-v2-236b", cap=0.0)[0],
                           tokens=jnp.asarray(toks), mode="train")
    np.testing.assert_array_equal(np.asarray(jl), np.asarray(j0))
    with torch.no_grad():
        tl, _ = ttf.forward(params_from_numpy(flat, tc, device="cpu"), tc,
                            tokens=torch.from_numpy(toks), mode=mode)
    _close_to_largest(tl, jl, MODEL_TOL["float32"])
