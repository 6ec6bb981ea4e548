"""The port's training slice vs the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through both packages; JAX
parameters are carried into the port with the bridge.  The models are
lms-demo cut to 2 layers at narrow widths (d=64, 4/2 heads of 16, d_ff 128,
vocab 500 padded to 512) in fp32.  Tolerances, all stated here:

* elementwise fp32 math (cross entropy, the RMSNorm backward, optimizer
  updates, clipping, the schedule): 1e-5 relative and absolute (sums taken
  in another order);
* loss and gradients of the model, attention: 1e-5 (the reference's fp32
  attention tolerance is 2e-5; measured differences are ~1e-7);
* three train steps (the loss, gradient norm and param norm series): 1e-4
  relative (JAX's compiled step fuses and reorders the sums, and AdamW's
  normalised update turns a last-bit difference in a small gradient into a
  small parameter difference);
* bf16: 2e-2 (the reference's bf16 kernel tolerance);
* checkpoints: bit-exact.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import MonitoringStack  # noqa: E402
from repro.core.marker import CALIB_REGION, MARKER_MEASUREMENT  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.ckpt import checkpoint as tckpt  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.params import flatten, unflatten  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

TOL = 1e-5
STEP_TOL = 1e-4
BF16_TOL = 2e-2
NARROW = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              head_dim=16, d_ff=128, vocab_size=500, vocab_pad_to=128,
              dtype="float32")
TINY = tbase.ShapeConfig("tiny", seq_len=32, global_batch=4, kind="train")
PEAKS = {"peak_flops": 2e12, "hbm_bw": 1e11}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _cfgs(**kw):
    over = dict(NARROW, **kw)
    return (dataclasses.replace(jget_config("lms-demo"), **over),
            dataclasses.replace(get_config("lms-demo"), **over))


def _flat_np(tree) -> dict:
    return {k: np.asarray(v) for k, v in
            flatten(jax.tree.map(np.asarray, tree)).items()}


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, port cfg, JAX params) of the narrow 2-layer lms-demo."""
    jc, tc = _cfgs()
    return jc, tc, jtf.init_model_params(jc, seed=0)


def _port_params(jp, tc):
    return params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")


def _batch(rng, b=4, s=32, vocab=500, masked=True):
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    if masked:
        labels[0, :5] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return tstep.batch_to_device(batch, "cpu")


# -- configs and data ----------------------------------------------------------


def test_train_configs_are_copies_of_the_reference():
    assert dataclasses.asdict(tbase.TrainConfig()) == \
        dataclasses.asdict(jbase.TrainConfig())
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert dataclasses.asdict(tbase.SMOKE_SHAPE) == \
        dataclasses.asdict(jbase.SMOKE_SHAPE)
    for name in ("lms-demo", "granite-3-8b", "zamba2-7b"):
        # no MoE in the port: every parameter is active
        assert get_config(name).param_count() == \
            jget_config(name).param_count() == \
            jget_config(name).active_param_count()
    # MLA, RWKV6 and the encoder-decoder are counted as the reference
    # counts them
    for name in ("deepseek-v2-236b", "rwkv6-1.6b", "seamless-m4t-large-v2"):
        assert get_config(name).param_count() == \
            jget_config(name).param_count()
    for change in ({"family": "ssm", "attention_type": "none",
                    "rwkv": tbase.RWKVConfig()},
                   {"family": "encdec", "num_encoder_layers": 2}):
        assert dataclasses.replace(get_config("lms-demo"),
                                   **change).param_count() == \
            dataclasses.replace(jget_config("lms-demo"),
                                **change).param_count()


@pytest.mark.parametrize("dtype,seq_len", [(np.uint16, 16), (np.uint32, 7),
                                           (np.uint16, 600)])
def test_memmap_source_gives_the_reference_windows(tmp_path, dtype, seq_len):
    """A token file the test writes: the same windows, bit for bit, from
    both packages' ``MemmapTokenSource`` at several steps and seeds, and
    through ``make_batch_fn``; a window longer than the file (600 of 500
    tokens) takes what there is, as the reference's."""
    path = tmp_path / "tokens.bin"
    vocab = 60000 if dtype == np.uint16 else 200000
    np.random.default_rng(1).integers(0, vocab, 500).astype(dtype).tofile(
        path)
    for seed in (0, 4):
        js = jdata.MemmapTokenSource(str(path), dtype=dtype, seed=seed)
        ts = tdata.MemmapTokenSource(str(path), dtype=dtype, seed=seed)
        for step in (0, 3, 11):
            want, got = js.batch(step, 5, seq_len), ts.batch(step, 5, seq_len)
            assert got.dtype == want.dtype == np.int32
            assert got.tobytes() == want.tobytes()
    shape = tbase.ShapeConfig("m", seq_len, 4, "train")
    jb = jdata.make_batch_fn(js, None, shape)(2, slice(0, 4))
    tb = tdata.make_batch_fn(ts, None, shape)(2, slice(0, 4))
    for k in jb:
        assert tb[k].tobytes() == jb[k].tobytes()


def test_data_pipeline_gives_the_reference_batches():
    js, ts = (jdata.SyntheticTokenSource(500, seed=3),
              tdata.SyntheticTokenSource(500, seed=3))
    for step in (0, 5, 17):
        np.testing.assert_array_equal(ts.batch(step, 4, 16),
                                      js.batch(step, 4, 16))
    jfn = jdata.make_batch_fn(js, None, TINY)
    tfn = tdata.make_batch_fn(ts, None, TINY)
    rows = slice(2, 4)
    for k, v in jfn(7, rows).items():
        np.testing.assert_array_equal(tfn(7, rows)[k], v)
    jl = jdata.DataLoader(jfn, global_batch=4, host_index=1, host_count=2,
                          start_step=3)
    tl = tdata.DataLoader(tfn, global_batch=4, host_index=1, host_count=2,
                          start_step=3)
    try:
        for _ in range(3):
            (js_step, jb), (ts_step, tb) = next(jl), next(tl)
            assert js_step == ts_step
            for k in jb:
                assert tb[k].tobytes() == jb[k].tobytes()
    finally:
        jl.close()
        tl.close()


# -- loss ------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("vocab", [500, 512])
def test_cross_entropy_matches_jax(rng, masked, vocab):
    jc, tc = _cfgs(vocab_size=vocab)
    logits = rng.standard_normal((3, 7, jc.vocab_padded)).astype(np.float32)
    targets = rng.integers(0, vocab, (3, 7))
    mask = rng.random((3, 7)) > 0.3 if masked else None
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                 jc, None if mask is None
                                 else jnp.asarray(mask))
    got = tlayers.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(targets), tc,
                                None if mask is None
                                else torch.from_numpy(mask))
    _close(got, want, TOL)


@pytest.mark.parametrize("remat", ["none", "minimal", "full"])
def test_loss_fn_value_and_grads_match_jax(model, rng, remat):
    jc, tc, jp = model
    batch = _batch(rng)
    (jl, _), jg = jax.value_and_grad(jtf.loss_fn, has_aux=True)(
        jp, jc, _jbatch(batch), remat=remat)
    leaves = {k: v.requires_grad_() for k, v in
              flatten(_port_params(jp, tc)).items()}
    tl, metrics = ttf.loss_fn(unflatten(leaves), tc, _tbatch(batch),
                              remat=remat)
    tl.backward()
    _close(tl, jl, TOL)
    assert metrics["loss"] is tl
    want = _flat_np(jg)
    assert set(want) == set(leaves)
    for k, leaf in leaves.items():
        _close(leaf.grad, want[k], TOL)


def test_train_mode_logits_match_prefill(model, rng):
    """Train and prefill compute the same causal function (prefill through
    the flash wrapper's plain version on the CPU)."""
    jc, tc, jp = model
    tp = _port_params(jp, tc)
    toks = torch.from_numpy(rng.integers(0, 500, (2, 40)))
    with torch.no_grad():
        train_logits, cache = ttf.forward(tp, tc, tokens=toks, mode="train")
        pre, _ = ttf.forward(tp, tc, tokens=toks, mode="prefill")
    assert cache is None
    _close(train_logits, pre, TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", BF16_TOL)])
def test_recursive_train_attention_matches_masked_and_jax(rng, dtype, tol):
    """S = 512 takes the recursive decomposition (3 levels of halves)."""
    shape_q, shape_kv = (2, 512, 4, 16), (2, 512, 2, 16)
    qn, kn, vn = (rng.standard_normal(s).astype(np.float32)
                  for s in (shape_q, shape_kv, shape_kv))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in (qn, kn, vn))
    got = tattn.recursive_causal_attention(q, k, v)
    want = jattn.recursive_causal_attention(
        *(jnp.asarray(a).astype(jdt) for a in (qn, kn, vn)))
    _close(got, np.asarray(want.astype(jnp.float32)), tol)
    _close(got, tattn.full_attention(q, k, v, causal=True), tol)


def test_model_recursive_attention_matches_jax(rng):
    jc, tc = _cfgs(num_layers=1)
    jp = jtf.init_model_params(jc, seed=1)
    batch = _batch(rng, b=1, s=512)
    (jl, _), jg = jax.value_and_grad(jtf.loss_fn, has_aux=True)(
        jp, jc, _jbatch(batch), attn_impl="recursive")
    leaves = {k: v.requires_grad_() for k, v in
              flatten(_port_params(jp, tc)).items()}
    tl, _ = ttf.loss_fn(unflatten(leaves), tc, _tbatch(batch),
                        attn_impl="recursive")
    tl.backward()
    _close(tl, jl, TOL)
    want = _flat_np(jg)
    for k, leaf in leaves.items():
        _close(leaf.grad, want[k], TOL)


def test_flash_train_attention_is_forward_only(model, rng):
    jc, tc, jp = model
    toks = torch.from_numpy(rng.integers(0, 500, (2, 16)))
    leaves = {k: v.requires_grad_() for k, v in
              flatten(_port_params(jp, tc)).items()}
    with pytest.raises(NotImplementedError, match="forward-only"):
        ttf.forward(unflatten(leaves), tc, tokens=toks, mode="train",
                    attn_impl="flash")
    with torch.no_grad():
        flash, _ = ttf.forward(unflatten(leaves), tc, tokens=toks,
                               mode="train", attn_impl="flash")
        masked, _ = ttf.forward(unflatten(leaves), tc, tokens=toks,
                                mode="train")
    _close(flash, masked, TOL)
    with pytest.raises(ValueError, match="attn_impl"):
        ttf.forward(unflatten(leaves), tc, tokens=toks, mode="train",
                    attn_impl="chunked")


def test_unported_training_raises(model):
    jc, tc, jp = model
    toks = torch.zeros((1, 8), dtype=torch.long)
    unported = dataclasses.replace(get_config("lms-demo", smoke=True),
                                   family="ssm")
    with pytest.raises(NotImplementedError, match="family"):
        ttf.forward({}, unported, tokens=toks, mode="train")
    with pytest.raises(ValueError, match="remat"):
        ttf.forward(_port_params(jp, tc), tc, tokens=toks, mode="train",
                    remat="some")
    # a mesh trains data-parallel (tests/test_torch_dist_step.py), and
    # tensor- and sequence-parallel for every family (tests/test_torch_tp*.py;
    # the recurrent ones in tests/test_torch_tp_recurrent.py): a hybrid
    # with seq_parallel passes to the mesh's checks, the step's type check
    # and the loop's process group
    hybrid = get_config("zamba2-7b", smoke=True)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tstep.make_train_step(hybrid, tbase.TrainConfig(seq_parallel=True),
                              mesh=object())
    with pytest.raises(ValueError, match="process group"):
        tloop.train(hybrid, tbase.TrainConfig(seq_parallel=True), TINY,
                    stack=None, mesh=object(), device="cpu", **PEAKS)
    # so does a dense model: the next check is the mesh's type
    with pytest.raises(TypeError, match="DeviceMesh"):
        tstep.make_train_step(tc, tbase.TrainConfig(seq_parallel=True),
                              mesh=object())
    with pytest.raises(ValueError, match="peak"):
        tloop.train(tc, tbase.TrainConfig(), TINY, stack=None, device="cpu")


# -- the RMSNorm gradient ----------------------------------------------------------


@pytest.mark.parametrize("shape", [(5, 24), (2, 9, 512)])
@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", BF16_TOL)])
def test_rmsnorm_bwd_ref_matches_autograd_and_jax(rng, shape, dtype, tol):
    xn = rng.standard_normal(shape).astype(np.float32)
    dyn = rng.standard_normal(shape).astype(np.float32)
    sn = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    x, dy = torch.from_numpy(xn).to(tdt), torch.from_numpy(dyn).to(tdt)
    scale = torch.from_numpy(sn)
    dx, dscale = ref.rmsnorm_bwd_ref(x, scale, dy)
    assert dx.dtype == tdt and dscale.dtype == torch.float32
    # autograd through the plain forward
    xr, sr = x.clone().requires_grad_(), scale.clone().requires_grad_()
    ref.rmsnorm_ref(xr, sr).backward(dy)
    _close(dx, xr.grad, tol)
    _close(dscale, sr.grad, tol)
    # jax.grad of the reference norm
    _, vjp = jax.vjp(lambda a, s: jref.rmsnorm_ref(a, s),
                     jnp.asarray(xn).astype(jdt), jnp.asarray(sn))
    jdx, jds = vjp(jnp.asarray(dyn).astype(jdt))
    _close(dx, np.asarray(jdx.astype(jnp.float32)), tol)
    _close(dscale, np.asarray(jds), tol)
    # the wrapper's plain version on the CPU is the same function
    wdx, wds = rms.rmsnorm_bwd(x, scale, dy)
    assert torch.equal(wdx, dx) and torch.equal(wds, dscale)


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


def test_fused_rmsnorm_takes_the_autograd_path_only_under_grad(rng):
    x = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    scale = torch.ones(16, requires_grad=True)
    ops.reset_launch_counts()
    session = _Session()
    prev = ops.set_kernel_markers(session)
    try:
        y = ops.fused_rmsnorm(x, scale)
        assert type(y.grad_fn).__name__ == "RMSNormFunctionBackward"
        y.sum().backward()
        with torch.inference_mode():
            assert ops.fused_rmsnorm(x, scale).grad_fn is None
        with torch.no_grad():
            assert ops.fused_rmsnorm(x, scale).grad_fn is None
        assert ops.fused_rmsnorm(x, scale.detach()).grad_fn is None
    finally:
        assert ops.set_kernel_markers(prev) is session
    assert [n for n, _ in session.regions] == [
        "kernel:rmsnorm", "kernel:rmsnorm_backward", "kernel:rmsnorm",
        "kernel:rmsnorm", "kernel:rmsnorm"]
    assert session.regions[1][1] == rms.bwd_cost_estimate((3, 16), 4)
    assert ops.launch_counts()["rmsnorm_backward"] == 0     # CPU: plain
    xr, sr = x.clone().requires_grad_(), torch.ones(16, requires_grad=True)
    ref.rmsnorm_ref(xr, sr).sum().backward()
    _close(scale.grad, sr.grad, TOL)


def test_rmsnorm_bwd_cost_estimate():
    c = rms.bwd_cost_estimate((16384, 4096), 2)
    assert c["bytes"] == 3 * 16384 * 4096 * 2 + 8 * 4096
    assert c["flops"] == 10.0 * 16384 * 4096
    # the scratch's rows: a block for each slots' worth of rows, at most
    # the blocks that fit on the card at once
    slots = rms.plan(16384, 4096, 2, backward=True)[2]
    assert rms.grid_blocks(16384, slots, 132) == 132
    assert rms.grid_blocks(5, 3, 264) == 2
    assert rms.grid_blocks(17, 16, 264) == 2


# -- optimizers ----------------------------------------------------------------------


def _opt_tree(rng):
    """A param-shaped tree with factored (2-D, 3-D) and unfactored leaves."""
    return {"a": {"w": rng.standard_normal((6, 5)).astype(np.float32),
                  "s": (1 + 0.1 * rng.standard_normal(5)).astype(np.float32)},
            "b": rng.standard_normal((2, 4, 3)).astype(np.float32),
            "c": rng.standard_normal((1, 7)).astype(np.float32)}


def test_lr_schedule_matches_jax():
    cfg = tbase.TrainConfig(learning_rate=3e-3, warmup_steps=10,
                            total_steps=50)
    jfn = joptim.lr_schedule(jbase.TrainConfig(**dataclasses.asdict(cfg)))
    tfn = toptim.lr_schedule(cfg)
    for step in (0, 1, 9, 10, 11, 30, 49, 50, 80):
        assert math.isclose(tfn(step), float(jfn(step)), rel_tol=TOL,
                            abs_tol=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(rng, max_norm):
    tree = _opt_tree(rng)
    jt, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                        max_norm)
    tt, tn = toptim.clip_by_global_norm(
        unflatten({k: torch.from_numpy(v.copy())
                   for k, v in flatten(tree).items()}), max_norm)
    _close(tn, jn, TOL)
    want = _flat_np(jt)
    for k, v in flatten(tt).items():
        _close(v, want[k], TOL)
    _close(toptim.global_norm(tt), joptim.global_norm(jt), TOL)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_steps_match_jax(rng, name):
    cfg = tbase.TrainConfig(optimizer=name, learning_rate=1e-2)
    jopt = joptim.get_optimizer(jbase.TrainConfig(**dataclasses.asdict(cfg)))
    topt = toptim.get_optimizer(cfg)
    tree = _opt_tree(rng)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = unflatten({k: torch.from_numpy(v.copy())
                    for k, v in flatten(tree).items()})
    js, ts = jopt.init(jp), topt.init(tp)
    assert set(_flat_np(js)) == set(flatten(ts))
    for step in range(5):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in flatten(tree).items()}
        jp, js = jopt.update(unflatten({k: jnp.asarray(v) for k, v in
                                        grads.items()}), js, jp, 1e-2)
        tp, ts = topt.update(unflatten({k: torch.from_numpy(v) for k, v in
                                        grads.items()}), ts, tp, 1e-2)
    want_p, want_s = _flat_np(jp), _flat_np(js)
    for k, v in flatten(tp).items():
        _close(v, want_p[k], TOL)
    for k, v in flatten(ts).items():
        tol = BF16_TOL if v.dtype == torch.bfloat16 else TOL
        _close(v, want_s[k].astype(np.float32), tol)
    assert int(ts["count"]) == int(js["count"]) == 5


# -- train and eval steps -----------------------------------------------------------


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(model, rng, optimizer, microbatches):
    jc, tc, jp = model
    cfg = tbase.TrainConfig(optimizer=optimizer, warmup_steps=1,
                            learning_rate=3e-3, num_microbatches=microbatches,
                            remat_policy="minimal")
    jfn, _ = jstep.make_train_step(jc, jbase.TrainConfig(
        **dataclasses.asdict(cfg)))
    jfn = jax.jit(jfn)
    tfn, topt = tstep.make_train_step(tc, cfg)
    jopt_state = joptim.get_optimizer(jbase.TrainConfig(
        **dataclasses.asdict(cfg))).init(jp)
    tp = _port_params(jp, tc)
    topt_state = topt.init(tp)
    jparams = jp
    for step in range(3):
        batch = _batch(rng)
        jparams, jopt_state, jm = jfn(jparams, jopt_state, _jbatch(batch),
                                      step)
        tp, topt_state, tm = tfn(tp, topt_state, _tbatch(batch), step)
        for key in ("loss", "grad_norm", "param_norm", "lr"):
            assert math.isclose(float(tm[key]), float(jm[key]),
                                rel_tol=STEP_TOL), (step, key)
    want = _flat_np(jparams)
    for k, v in flatten(tp).items():
        _close(v, want[k], STEP_TOL)


def test_grad_sync_dtype_bf16_matches_jax(model, rng):
    jc, tc, jp = model
    cfg = tbase.TrainConfig(grad_sync_dtype="bfloat16", warmup_steps=0,
                            grad_clip_norm=0.0, remat_policy="none")
    jcfg = jbase.TrainConfig(**dataclasses.asdict(cfg))
    batch = _batch(rng)
    jgrads, _ = jstep._grads_and_metrics(jp, _jbatch(batch), jc, jcfg, None)
    tgrads, _ = tstep._grads_and_metrics(_port_params(jp, tc),
                                         _tbatch(batch), tc, cfg)
    want = _flat_np(jgrads)
    for k, v in flatten(tgrads).items():
        assert v.dtype == torch.float32
        # both round the same fp32 gradient to bf16: equal up to a rounding
        # step where the fp32 gradients differ in their last bits
        _close(v, want[k], BF16_TOL)


def test_eval_step_matches_jax(model, rng):
    jc, tc, jp = model
    batch = _batch(rng)
    jm = jstep.make_eval_step(jc, jbase.TrainConfig())(jp, _jbatch(batch))
    tm = tstep.make_eval_step(tc, tbase.TrainConfig())(
        _port_params(jp, tc), _tbatch(batch))
    _close(tm["loss"], jm["loss"], TOL)
    assert tm["loss"].grad_fn is None


@pytest.mark.parametrize("remat", ["none", "minimal", "full"])
def test_step_flops_count_on_meta_copies(model, rng, remat):
    """count_step_flops runs on meta copies: the same count as a counted
    pass over the real tensors (exact: counts depend on shapes only),
    remat recomputes included, and no launch or gradient on the real ones."""
    _, tc, jp = model
    tcfg = tbase.TrainConfig(remat_policy=remat, num_microbatches=2)
    params, batch = _port_params(jp, tc), _tbatch(_batch(rng))
    with FlopCounterMode(display=False) as counter:
        tstep._grads_and_metrics(params, batch, tc, tcfg)
    ops.reset_launch_counts()
    got = tstep.count_step_flops(params, batch, tc, tcfg)
    assert got == counter.get_total_flops() > 0
    assert not any(ops.launch_counts().values())
    assert all(v.device.type == "cpu" and v.grad is None
               for v in flatten(params).values())
    if remat != "none":
        plain = tstep.count_step_flops(
            params, batch, tc, dataclasses.replace(tcfg, remat_policy="none"))
        assert got > plain


# -- checkpoints ------------------------------------------------------------------------


def _trees(model, optimizer):
    jc, tc, jp = model
    cfg = tbase.TrainConfig(optimizer=optimizer)
    jstate = joptim.get_optimizer(jbase.TrainConfig(
        **dataclasses.asdict(cfg))).init(jp)
    # a state that is not all zeros: one update with ones as gradients
    jp2, jstate = joptim.get_optimizer(jbase.TrainConfig(
        **dataclasses.asdict(cfg))).update(
            jax.tree.map(jnp.ones_like, jp), jstate, jp, 1e-3)
    tp = _port_params(jp2, tc)
    tstate = toptim.get_optimizer(cfg).init(tp)
    return jp2, jstate, tp, tstate


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_port_checkpoint_loads_in_jax(model, tmp_path, optimizer):
    jp, jstate, tp, tstate = _trees(model, optimizer)
    # the port's trees hold the JAX values (bf16 momentum included) and are
    # written by the port
    jckpt.save_checkpoint(str(tmp_path / "j"), 3,
                          {"params": jp, "opt_state": jstate})
    _, trees = tckpt.load_checkpoint(str(tmp_path / "j"),
                                     {"params": tp, "opt_state": tstate})
    tckpt.save_checkpoint(str(tmp_path / "t"), 7, trees, {"arch": "x"})
    step, loaded = jckpt.load_checkpoint(
        str(tmp_path / "t"), {"params": jp, "opt_state": jstate})
    assert step == 7
    for group, want in (("params", jp), ("opt_state", jstate)):
        got, want = _flat_np(loaded[group]), flatten(
            jax.tree.map(np.asarray, want))
        assert set(got) == set(want)
        for k in got:
            assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_jax_checkpoint_loads_in_the_port(model, tmp_path, optimizer):
    jp, jstate, tp, tstate = _trees(model, optimizer)
    jckpt.save_checkpoint(str(tmp_path), 5,
                          {"params": jp, "opt_state": jstate})
    step, loaded = tckpt.load_checkpoint(str(tmp_path),
                                         {"params": tp, "opt_state": tstate})
    assert step == 5
    for group, want in (("params", jp), ("opt_state", jstate)):
        want = flatten(jax.tree.map(np.asarray, want))
        for k, v in flatten(loaded[group]).items():
            assert v.dtype == flatten(
                {"params": tp, "opt_state": tstate}[group])[k].dtype
            assert tckpt.to_numpy(v).tobytes() == \
                np.asarray(want[k]).tobytes(), k


def test_checkpoint_manager_is_atomic_and_keeps_k(tmp_path, rng):
    tree = {"w": torch.from_numpy(rng.standard_normal((3, 4)).astype(
        np.float32)), "m": torch.zeros(4, dtype=torch.bfloat16)}
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    for step in (2, 4, 6):
        tree["w"] += 1
        mgr.save(step, {"params": tree})
    mgr.wait()
    assert tckpt.available_steps(str(tmp_path)) == [4, 6]
    (tmp_path / ".tmp-8").mkdir()             # a crash mid-save
    assert mgr.latest_step() == 6
    step, got = mgr.restore({"params": tree})
    assert step == 6 and torch.equal(got["params"]["w"], tree["w"])
    assert got["params"]["m"].dtype == torch.bfloat16
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint(str(tmp_path / "none"), {"params": tree})
    with pytest.raises(KeyError, match="missing leaf"):
        tckpt.load_checkpoint(str(tmp_path), {"params": {"x": tree["w"]}})


def test_checkpoint_manager_saves_the_values_of_the_save_call(tmp_path, rng):
    """The host copy is the writer's own: an in-place update right after
    ``save`` (the next optimizer step) does not reach the file."""
    w = torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32))
    m = torch.from_numpy(rng.standard_normal(64).astype(np.float32)).to(
        torch.bfloat16)
    want = {"w": w.clone(), "m": m.clone()}
    for leaf in (w, m):
        assert not np.shares_memory(tckpt.to_numpy(leaf),
                                    leaf.view(torch.int16).numpy()
                                    if leaf.dtype == torch.bfloat16
                                    else leaf.numpy())
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, {"params": {"w": w, "m": m}})
    w.mul_(3.0).add_(1.0)
    m.add_(1.0)
    _, got = mgr.restore({"params": {"w": w, "m": m}})
    assert torch.equal(got["params"]["w"], want["w"])
    assert torch.equal(got["params"]["m"], want["m"])


# -- the monitored loop ----------------------------------------------------------------


def test_train_loop_emits_metrics_mfu_and_markers(tmp_path):
    cfg = get_config("lms-demo", smoke=True)
    tcfg = tbase.TrainConfig(total_steps=4, warmup_steps=1,
                             learning_rate=5e-3)
    stack = MonitoringStack.inprocess(out_dir=str(tmp_path))
    try:
        losses = []
        r = tloop.train(cfg, tcfg, TINY, stack=stack, device="cpu",
                        job_id="tj", step_callback=lambda s, m: losses.append(
                            float(m["loss"])), **PEAKS)
        assert r.steps_run == 4 and r.final_step == 4
        assert r.last_loss == losses[-1] and losses[-1] < losses[0]
        db = stack.backend.db("global")
        train_pts = db.select("train", ["loss", "grad_norm", "lr"])
        assert len(train_pts[0].values["loss"]) == 4
        hpm = db.select("hpm", ["mfu", "hw_flops_util", "step_time_s",
                                "tokens_per_s"])[0]
        assert hpm.tags["jobid"] == "tj"
        model_flops = 6 * cfg.param_count() * \
            TINY.global_batch * TINY.seq_len
        for mfu, t in zip(hpm.values["mfu"], hpm.values["step_time_s"]):
            assert math.isclose(mfu, model_flops / t / PEAKS["peak_flops"],
                                rel_tol=1e-9)
        assert all(u > 0 for u in hpm.values["hw_flops_util"])
        # the step's counted bytes: the MEM group is derived
        mem = db.select("hpm", ["hbm_bw_util"])[0]
        assert len(mem.values["hbm_bw_util"]) == 4
        assert all(u > 0 for u in mem.values["hbm_bw_util"])
        regions = set(db.tag_values(MARKER_MEASUREMENT, "region"))
        assert {"train_step", "data_wait"} <= regions
        step_pts = db.select(MARKER_MEASUREMENT, ["flops", "calls"],
                             tags={"region": "train_step"})[0]
        assert step_pts.tags.get("jobid") == "tj"
        assert sum(step_pts.values["flops"]) > 0
    finally:
        stack.close()


def _loop_cfg(tmp_path, **kw):
    return tbase.TrainConfig(total_steps=5, warmup_steps=1,
                             learning_rate=3e-3, ckpt_dir=str(tmp_path),
                             ckpt_interval=2, **kw)


def test_train_loop_matches_the_jax_loop(model, tmp_path):
    """Both loops resume from one step-0 checkpoint of the same params, so
    they train the same model on the same batches: the same series."""
    jc, tc, jp = model
    out = {}
    for name, pkg, cfg in (("jax", jloop, jc), ("port", tloop, tc)):
        tcfg = _loop_cfg(tmp_path / name)
        jstate = joptim.get_optimizer(jbase.TrainConfig(
            **dataclasses.asdict(tcfg))).init(jp)
        jckpt.save_checkpoint(tcfg.ckpt_dir, 0,
                              {"params": jp, "opt_state": jstate})
        stack = MonitoringStack.inprocess(out_dir=str(tmp_path / f"l{name}"))
        try:
            kw = dict(device="cpu", **PEAKS) if name == "port" else {}
            r = pkg.train(cfg, tcfg if name == "port" else jbase.TrainConfig(
                **dataclasses.asdict(tcfg)), TINY, stack=stack,
                job_id=name, **kw)
            assert r.resumed_from == 0 and r.final_step == 5
            db = stack.backend.db("global")
            ev = [v for s in db.select("run_state")
                  for v in s.values["event"]]
            out[name] = {
                "train": db.select("train", ["loss", "grad_norm",
                                             "lr"])[0].values,
                "measurements": set(db.measurements()),
                "regions": set(db.tag_values(MARKER_MEASUREMENT, "region")),
                "events": ev}
        finally:
            stack.close()
    jv, tv = out["jax"], out["port"]
    assert tv["measurements"] == jv["measurements"]
    # the port also records its device's peaks as the calibration point
    # (the reference run has no device peaks to record)
    assert tv["regions"] == jv["regions"] | {CALIB_REGION}
    assert tv["events"] == jv["events"]
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(tv["train"][key], jv["train"][key],
                                   rtol=STEP_TOL)
    assert tckpt.available_steps(str(tmp_path / "port")) == [0, 2, 4]


def test_train_loop_resumes_after_injected_failure(model, tmp_path):
    jc, tc, jp = model
    tcfg = _loop_cfg(tmp_path / "a")
    stack = MonitoringStack.inprocess(out_dir=str(tmp_path / "la"))
    try:
        with pytest.raises(tloop.InjectedFailure):
            tloop.train(tc, tcfg, TINY, stack=stack, device="cpu",
                        fail_at_step=3, job_id="a1", **PEAKS)
    finally:
        stack.close()
    assert tckpt.latest_step(tcfg.ckpt_dir) == 2
    stack = MonitoringStack.inprocess(out_dir=str(tmp_path / "lb"))
    try:
        r = tloop.train(tc, tcfg, TINY, stack=stack, device="cpu",
                        job_id="a2", **PEAKS)
        texts = [v for s in stack.backend.db("global").select("run_state")
                 for v in s.values["event"]]
    finally:
        stack.close()
    assert r.resumed_from == 2 and r.final_step == 5 and r.steps_run == 3
    assert any("starting" in t and "step 2" in t for t in texts)
    # an uninterrupted run ends at the same params
    whole = _loop_cfg(tmp_path / "b", ckpt_keep=5)
    stack = MonitoringStack.inprocess(out_dir=str(tmp_path / "lc"))
    try:
        tloop.train(tc, whole, TINY, stack=stack, device="cpu", job_id="b",
                    **PEAKS)
    finally:
        stack.close()
    templates = {"params": ttf.init_model_params(tc, device="cpu")}
    _, resumed = tckpt.load_checkpoint(tcfg.ckpt_dir, templates, 4)
    _, straight = tckpt.load_checkpoint(whole.ckpt_dir, templates, 4)
    for k, v in flatten(resumed["params"]).items():
        assert torch.equal(v, flatten(straight["params"])[k]), k
