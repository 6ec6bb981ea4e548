"""The encoder-decoder family (seamless-m4t-large-v2) in the port vs the JAX
package, on the CPU, and the plumbing its source frames need.

The same numpy parameters, tokens and source frames (``src_frames``, the
audio frontend's stub output) go through both packages.  The decoder's
prefill self-attention runs the flash kernel's wrapper (its plain version
on the CPU) where the reference runs ``chunked_attention``; the encoder
runs the plain bidirectional masked attention in both, and so does the
cross-attention.  The cross K/V cache is bf16 after prefill whatever the
compute dtype, in both.  Tolerances, all stated here: ``_sinusoidal``
3e-5 (positions up to 300: an fp32 angle near 300 rad is rounded to
3e-5); ``encode``, ``cross_kv`` and the logits in train, prefill and decode
fp32 1e-4, bf16 5e-2 of the largest value; the loss 1e-5, every gradient
leaf 1e-4 and one AdamW step 1e-4 relative, as
``tests/test_torch_train_families.py``.
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
from repro.core import MonitoringStack  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.params import flatten, unflatten  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

NAME = "seamless-m4t-large-v2"
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
    """Flat numpy parameters at the init's scales; norm scales and biases
    drawn around 1 and 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in flatten(ttf.model_specs(tc)).items():
        if s.init == "normal":
            std = s.scale if s.scale is not None else \
                1.0 / np.sqrt(max(int(np.prod(s.shape[:-1])), 1))
            a = std * rng.standard_normal(s.shape)
        else:
            base = {"zeros": 0.0, "ones": 1.0}.get(s.init, s.value)
            a = base + 0.1 * rng.standard_normal(s.shape)
        out[k] = a.astype(np.float32)
    return out


def _frames(rng, tc, b=2):
    return (0.5 * rng.standard_normal(
        (b, tc.encdec_source_len, tc.d_model))).astype(np.float32)


def _pair(flat, tc):
    return (jax.tree.map(jnp.asarray, unflatten(flat)),
            params_from_numpy(flat, tc, device="cpu"))


# -- pieces ------------------------------------------------------------------------


def test_sinusoidal_matches_jax():
    pos = np.arange(0, 300, 7)[None, :]
    for d in (64, 1024):
        want = jtf._sinusoidal(jnp.asarray(pos), d)
        got = ttf._sinusoidal(torch.from_numpy(pos), d)
        assert got.dtype == torch.float32 and got.shape == (1, 43, d)
        _close(got, want, 3e-5)


def test_param_counts_match_jax():
    for smoke in (False, True):
        jc, tc = jget_config(NAME, smoke=smoke), get_config(NAME, smoke=smoke)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
    # the count puts the cross-attention term on the encoder layers; with
    # 24 of each the total is that of the spec tree's matrices
    full = get_config(NAME)
    assert full.param_count() == 1_635_778_560
    assert sum(math.prod(s.shape) for s in flatten(
        ttf.model_specs(full)).values()) == 1_636_028_416


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_cross_kv_match_jax(rng, dtype):
    jc, tc = _cfgs(dtype)
    flat = _np_params(tc)
    jp, tp = _pair(flat, tc)
    frames = _frames(rng, tc)
    jenc = jtf.encode(jp, jc, jnp.asarray(frames))
    jcross = jtf.encdec_cross_caches(jp, jc, jenc)
    with torch.no_grad():
        tenc = ttf.encode(tp, tc, torch.from_numpy(frames))
        tcross = ttf.encdec_cross_caches(tp, tc, tenc)
    assert tenc.dtype == getattr(torch, dtype)
    _close_to_largest(tenc, jenc, MODEL_TOL[dtype])
    assert len(tcross) == tc.num_layers
    for i, c in enumerate(tcross):
        for key in ("k", "v"):
            _close_to_largest(c[key], jcross[key][i], MODEL_TOL[dtype])


def test_bidirectional_and_cross_attention_match_jax(rng):
    jc, tc = _cfgs()
    d, hd = tc.d_model, tc.head_dim
    p = {k: (rng.standard_normal(s.shape) / np.sqrt(d)).astype(np.float32)
         for k, s in tattn.attn_specs(tc).items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    enc = rng.standard_normal((2, 13, d)).astype(np.float32)
    jy, _ = jattn.gqa_attention(jp, jnp.asarray(x), jc, mode="train",
                                bidirectional=True)
    ty, _ = tattn.gqa_attention(tp, torch.from_numpy(x), tc, mode="train",
                                bidirectional=True)
    _close(ty, jy, 2e-5)
    jkv = jattn.cross_kv(jp, jnp.asarray(enc), jc)
    tkv = tattn.cross_kv(tp, torch.from_numpy(enc), tc)
    assert tkv["k"].shape == (2, 13, tc.num_kv_heads, hd)
    for key in ("k", "v"):
        _close(tkv[key], jkv[key], 2e-5)
    jy = jattn.cross_attention(jp, jnp.asarray(x), jkv, jc)
    ty = tattn.cross_attention(tp, torch.from_numpy(x), tkv, tc)
    _close(ty, jy, 2e-5)


# -- the smoke model -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seamless_train_logits_match_jax(rng, dtype):
    jc, tc = _cfgs(dtype)
    flat = _np_params(tc)
    jp, tp = _pair(flat, tc)
    toks = rng.integers(0, tc.vocab_size, (2, 24))
    frames = _frames(rng, tc)
    jl, _, _ = jtf.forward(jp, jc, tokens=jnp.asarray(toks), mode="train",
                           extras={"src_frames": jnp.asarray(frames)})
    with torch.no_grad():
        tl, _ = ttf.forward(tp, tc, tokens=torch.from_numpy(toks),
                            mode="train",
                            extras={"src_frames": torch.from_numpy(frames)})
    _close_to_largest(tl, jl, MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seamless_prefill_and_decode_match_jax(rng, dtype):
    """Prefill with the source frames (the cross K/V written to the cache
    in bf16, as the reference's prefill casts them), then 4 decode steps
    that read them from the cache; self caches in the compute dtype."""
    jc, tc = _cfgs(dtype)
    tol = MODEL_TOL[dtype]
    flat = _np_params(tc)
    jp, tp = _pair(flat, tc)
    toks = rng.integers(0, tc.vocab_size, (2, 11))
    frames = _frames(rng, tc)
    jcache = jtf.init_cache(jc, 2, 24, dtype=getattr(jnp, dtype))
    jl, jcache, _ = jtf.forward(jp, jc, tokens=jnp.asarray(toks),
                                mode="prefill", cache=jcache,
                                extras={"src_frames": jnp.asarray(frames)})
    tcache = ttf.init_cache(tc, 2, 24, dtype=getattr(torch, dtype),
                            device="cpu")
    with torch.inference_mode():
        tl, tcache = ttf.forward(
            tp, tc, tokens=torch.from_numpy(toks), mode="prefill",
            cache=tcache, extras={"src_frames": torch.from_numpy(frames)})
    _close_to_largest(tl, jl, tol)
    assert jcache["cross"]["k"].dtype == jnp.bfloat16
    assert tcache["cross"]["k"].dtype == torch.bfloat16
    # bf16 in both: values that agree to 1e-6 may round one bf16 unit
    # apart (3.9e-3 relative), so the bf16 tolerance holds in fp32 too
    for key in ("k", "v"):
        _close_to_largest(tcache["cross"][key],
                          jcache["cross"][key].astype(jnp.float32),
                          MODEL_TOL["bfloat16"])
    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    for step in range(4):
        jl, jcache, _ = jtf.forward(
            jp, jc, tokens=jnp.asarray(nxt[:, None], jnp.int32),
            mode="decode", cache=jcache, pos=jnp.int32(11 + step))
        with torch.inference_mode():
            tl, tcache = ttf.forward(
                tp, tc, tokens=torch.from_numpy(nxt[:, None].copy()),
                mode="decode", cache=tcache, pos=11 + step)
        _close_to_largest(tl, jl, tol)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    _close_to_largest(tcache["self"]["v"], jcache["self"]["v"], tol)


def _batch(rng, tc, b=2, s=24):
    toks = rng.integers(0, tc.vocab_size, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": toks[:, :-1], "labels": labels,
            "src_frames": _frames(rng, tc, b)}


@pytest.mark.parametrize("remat", ["none", "minimal"])
def test_seamless_loss_and_grads_match_jax(rng, remat):
    jc, tc = _cfgs()
    flat = _np_params(tc)
    batch = _batch(rng, tc)
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


def test_seamless_train_step_matches_jax(rng):
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
    batch = _batch(rng, tc)
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


def test_microbatches_split_the_source_frames(rng):
    """Two microbatches take their rows of ``src_frames`` as of the tokens:
    the step's loss is the whole batch's."""
    _, tc = _cfgs()
    flat = _np_params(tc)
    batch = _batch(rng, tc, b=4)
    batch["labels"][0, :3] = batch["tokens"][0, 1:4]   # every label counts
    batch = tstep.batch_to_device(batch, "cpu")
    losses = []
    for nm in (1, 2):
        step, opt = tstep.make_train_step(
            tc, TrainConfig(num_microbatches=nm, remat_policy="none"))
        params = params_from_numpy(flat, tc, device="cpu")
        _, _, m = step(params, opt.init(params), batch, 0)
        losses.append(float(m["loss"]))
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[0])


# -- serving ---------------------------------------------------------------------------


def test_serve_fns_take_the_source_frames(rng):
    """prefill(..., {"src_frames": ...}) and decode without extras against
    the reference's serve functions."""
    jc, tc = _cfgs()
    flat = _np_params(tc)
    jp, tp = _pair(flat, tc)
    toks = rng.integers(1, tc.vocab_size, (2, 9))
    frames = _frames(rng, tc)
    jpre, jdec = jengine.make_serve_fns(jc)
    tpre, tdec = tengine.make_serve_fns(tc)
    jlast, jcache = jpre(jp, jnp.asarray(toks),
                         jtf.init_cache(jc, 2, 16, dtype=jnp.float32),
                         {"src_frames": jnp.asarray(frames)})
    with torch.inference_mode():
        tlast, tcache = tpre(tp, torch.from_numpy(toks),
                             ttf.init_cache(tc, 2, 16, dtype=torch.float32,
                                            device="cpu"),
                             {"src_frames": torch.from_numpy(frames)})
    _close(tlast, jlast, MODEL_TOL["float32"])
    nxt = np.asarray(jnp.argmax(jlast, axis=-1))[:, None].copy()
    jlog, _ = jdec(jp, jcache, jnp.asarray(nxt, jnp.int32), jnp.int32(9))
    with torch.inference_mode():
        tlog, _ = tdec(tp, tcache, torch.from_numpy(nxt), 9)
    _close(tlog, jlog, MODEL_TOL["float32"])


def test_engine_raises_for_seamless_as_the_reference_engine():
    """The engines pass no extras, so the encoder finds no source frames:
    both raise a KeyError naming ``src_frames``."""
    jc, tc = _cfgs()
    flat = _np_params(tc)
    jp, tp = _pair(flat, tc)
    jeng = jengine.ServingEngine(jc, jp, max_batch=1, max_len=16, jit=False)
    teng = tengine.ServingEngine(tc, tp, max_batch=1, max_len=16,
                                 device="cpu")
    for eng in (jeng, teng):
        eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2)
        with pytest.raises(KeyError, match="src_frames"):
            eng.run_until_empty()


# -- the loop and the CLIs ------------------------------------------------------------


def test_extras_fn_gives_the_reference_source_frames():
    for shape in (ShapeConfig("a", 32, 2, "train"),
                  ShapeConfig("b", 4, 3, "train")):
        want = jloop._extras_fn(jget_config(NAME, smoke=True), shape)(3, 2)
        got = tloop.stub_extras(get_config(NAME, smoke=True), shape)(3, 2)
        assert set(got) == set(want) == {"src_frames"}
        assert got["src_frames"].dtype == want["src_frames"].dtype
        np.testing.assert_array_equal(got["src_frames"], want["src_frames"])


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


def test_train_cli_trains_seamless(stack, capsys):
    """The loop supplies the stub source frames."""
    assert train_cli.main(["--arch", NAME, "--steps", "2", "--seq-len",
                           "16", "--global-batch", "2",
                           *_cli_args(stack)]) == 0
    assert "done: steps=2 " in capsys.readouterr().out


def test_serve_cli_raises_for_seamless(stack):
    with pytest.raises(KeyError, match="src_frames"):
        serve_cli.main(["--arch", NAME, "--requests", "1",
                        *_cli_args(stack)])
