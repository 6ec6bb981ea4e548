"""The VLM family (qwen2-vl-7b) in the port vs the JAX package, on the CPU,
and the plumbing its extras need (``patches``, ``mrope_pos``).

The same numpy parameters, tokens, patch embeddings and M-RoPE positions go
through both packages.  The positions follow Qwen2-VL's rule, so their
three components differ: BOS at (0, 0, 0), an image of R x C patches at
(1, 1 + r, 1 + c), text after it at t = h = w = 1 + max(R, C) + j; decode
continues the text positions, which differ from the cache slot.
Tolerances, all stated here: ``mrope_table`` 1e-6; the smoke model's
logits in train, prefill (patches merged) and decode fp32 1e-4, bf16 5e-2;
the loss 1e-5 and every gradient leaf 1e-4, as
``tests/test_torch_train_families.py``.
"""

import dataclasses
from contextlib import nullcontext

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import MonitoringStack  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.configs import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.params import flatten, unflatten  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

NAME = "qwen2-vl-7b"
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ROWS, COLS = 2, 4                  # the smoke image: 8 = vlm_num_patches
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


def grid_positions(b, rows, cols, text):
    """(b, 1 + rows * cols + text, 3) int32 M-RoPE positions: BOS, an image
    of rows x cols patches, then ``text`` text tokens."""
    img = [(1, 1 + r, 1 + c) for r in range(rows) for c in range(cols)]
    start = 1 + max(rows, cols)
    txt = [(start + j,) * 3 for j in range(text)]
    pos = np.array([(0, 0, 0)] + img + txt, np.int32)
    return np.broadcast_to(pos, (b,) + pos.shape).copy()


def _np_params(tc, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in flatten(ttf.model_specs(tc)).items():
        if s.init == "normal":
            std = s.scale if s.scale is not None else \
                1.0 / np.sqrt(max(int(np.prod(s.shape[:-1])), 1))
            a = std * rng.standard_normal(s.shape)
        else:
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        out[k] = a.astype(np.float32)
    return out


def _inputs(rng, tc, b=2, text=11):
    p = ROWS * COLS
    toks = rng.integers(0, tc.vocab_size, (b, 1 + p + text))
    patches = (0.5 * rng.standard_normal((b, p, tc.d_model))).astype(
        np.float32)
    return toks, {"patches": patches,
                  "mrope_pos": grid_positions(b, ROWS, COLS, text)}


def _jx(extras):
    return {k: jnp.asarray(v) for k, v in extras.items()}


def _tx(extras):
    return {k: torch.from_numpy(v) for k, v in extras.items()}


# -- M-RoPE -----------------------------------------------------------------------


@pytest.mark.parametrize("head_dim,sections,theta", [
    (16, (4, 2, 2), 1e6),           # the smoke config's
    (128, (16, 24, 24), 1e6)])      # qwen2-vl-7b's
def test_mrope_table_matches_jax_on_grid_positions(head_dim, sections,
                                                   theta):
    """Positions whose three components differ, so that a band taking its
    angle from the wrong component shows."""
    pos = grid_positions(2, 3, 5, 7)
    assert not (pos[..., 0] == pos[..., 1]).all()
    assert not (pos[..., 1] == pos[..., 2]).all()
    jcos, jsin = jlayers.mrope_table(jnp.asarray(pos), head_dim, theta,
                                     sections)
    tcos, tsin = tlayers.mrope_table(torch.from_numpy(pos), head_dim, theta,
                                     sections)
    assert tcos.shape == (2, pos.shape[1], head_dim // 2)
    _close(tcos, jcos, 1e-6)
    _close(tsin, jsin, 1e-6)
    with pytest.raises(ValueError, match="sum"):
        tlayers.mrope_table(torch.from_numpy(pos), head_dim, theta, (1, 1, 1))


# -- the smoke model --------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen2_vl_train_logits_match_jax(rng, dtype):
    jc, tc = _cfgs(dtype)
    flat = _np_params(tc)
    toks, extras = _inputs(rng, tc)
    jl, _, _ = jtf.forward(jax.tree.map(jnp.asarray, unflatten(flat)), jc,
                           tokens=jnp.asarray(toks), mode="train",
                           extras=_jx(extras))
    with torch.no_grad():
        tl, _ = ttf.forward(params_from_numpy(flat, tc, device="cpu"), tc,
                            tokens=torch.from_numpy(toks), mode="train",
                            extras=_tx(extras))
    _close_to_largest(tl, jl, MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen2_vl_prefill_and_decode_match_jax(rng, dtype):
    """Prefill with the patches merged and grid positions, then 4 decode
    steps whose M-RoPE positions (the text's) differ from the cache slot;
    caches in the compute dtype so that fp32 holds them to 1e-4 too."""
    jc, tc = _cfgs(dtype)
    tol = MODEL_TOL[dtype]
    flat = _np_params(tc)
    jp = jax.tree.map(jnp.asarray, unflatten(flat))
    tp = params_from_numpy(flat, tc, device="cpu")
    toks, extras = _inputs(rng, tc)
    s = toks.shape[1]
    jcache = jtf.init_cache(jc, 2, 32, dtype=getattr(jnp, dtype))
    jl, jcache, _ = jtf.forward(jp, jc, tokens=jnp.asarray(toks),
                                mode="prefill", cache=jcache,
                                extras=_jx(extras))
    tcache = ttf.init_cache(tc, 2, 32, dtype=getattr(torch, dtype),
                            device="cpu")
    with torch.inference_mode():
        tl, tcache = ttf.forward(tp, tc, tokens=torch.from_numpy(toks),
                                 mode="prefill", cache=tcache,
                                 extras=_tx(extras))
    _close_to_largest(tl, jl, tol)
    _close_to_largest(tcache["dense"]["k"], jcache["dense"]["k"], tol)
    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    text_pos = int(extras["mrope_pos"][0, -1, 0]) + 1
    for step in range(4):
        pos = s + step
        mpos = {"mrope_pos": np.full((2, 1, 3), text_pos + step, np.int32)}
        assert text_pos + step != pos
        jl, jcache, _ = jtf.forward(
            jp, jc, tokens=jnp.asarray(nxt[:, None], jnp.int32),
            mode="decode", cache=jcache, pos=jnp.int32(pos), extras=_jx(mpos))
        with torch.inference_mode():
            tl, tcache = ttf.forward(
                tp, tc, tokens=torch.from_numpy(nxt[:, None].copy()),
                mode="decode", cache=tcache, pos=pos, extras=_tx(mpos))
        _close_to_largest(tl, jl, tol)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    _close_to_largest(tcache["dense"]["v"], jcache["dense"]["v"], tol)


@pytest.mark.parametrize("remat", ["none", "minimal"])
def test_qwen2_vl_loss_and_grads_match_jax(rng, remat):
    """Patches and grid positions as batch entries: the loss and every
    gradient leaf against ``jax.value_and_grad`` (the patches take none:
    they are an input)."""
    jc, tc = _cfgs()
    flat = _np_params(tc)
    toks, extras = _inputs(rng, tc)
    labels = np.roll(toks, -1, axis=1)
    labels[:, :1 + ROWS * COLS] = -1            # no loss on BOS and patches
    batch = {"tokens": toks.astype(np.int32), "labels": labels, **extras}
    jp = jax.tree.map(jnp.asarray, unflatten(flat))
    (jl, _), jg = jax.value_and_grad(jtf.loss_fn, has_aux=True)(
        jp, jc, _jx(batch), remat=remat)
    jg = {k: np.asarray(v) for k, v in
          flatten(jax.tree.map(np.asarray, jg)).items()}
    leaves = {k: v.requires_grad_() for k, v in
              flatten(params_from_numpy(flat, tc, device="cpu")).items()}
    tbatch = tstep.batch_to_device(batch, "cpu")
    tl, tm = ttf.loss_fn(unflatten(leaves), tc, tbatch, remat=remat)
    tg = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    _close(tl, jl, LOSS_TOL)
    assert set(tm) == {"loss"}
    assert set(tg) == set(jg)
    for k, g in tg.items():
        _close(g, jg[k], GRAD_TOL)


def test_patches_that_do_not_fit_raise(rng):
    """P > S - 1 makes the reference's merged sequence 1 + P long, which its
    S positions then fail to broadcast against; the port refuses the
    patches by name."""
    jc, tc = _cfgs()
    flat = _np_params(tc)
    toks = rng.integers(0, tc.vocab_size, (1, 5))
    extras = {"patches": np.zeros((1, 5, tc.d_model), np.float32),
              "mrope_pos": grid_positions(1, 1, 1, 3)}
    with pytest.raises(TypeError, match="broadcast"):
        jtf.forward(jax.tree.map(jnp.asarray, unflatten(flat)), jc,
                    tokens=jnp.asarray(toks), mode="train",
                    extras=_jx(extras))
    with pytest.raises(ValueError, match="patches"):
        ttf.forward(params_from_numpy(flat, tc, device="cpu"), tc,
                    tokens=torch.from_numpy(toks), mode="train",
                    extras=_tx(extras))


# -- plumbing ---------------------------------------------------------------------


def test_batch_to_device_keeps_patches_floating():
    batch = {"tokens": np.zeros((2, 4), np.int32),
             "labels": np.zeros((2, 4), np.int32),
             "mrope_pos": np.zeros((2, 4, 3), np.int32),
             "patches": np.full((2, 2, 8), 0.25, np.float32)}
    out = tstep.batch_to_device(batch, "cpu")
    assert {k: v.dtype for k, v in out.items()} == {
        "tokens": torch.int64, "labels": torch.int64,
        "mrope_pos": torch.int64, "patches": torch.float32}
    assert float(out["patches"].sum()) == 0.25 * 32


def test_extras_fn_gives_the_reference_arrays():
    for name in (NAME, "lms-demo"):
        for shape in (ShapeConfig("a", 32, 2, "train"),
                      ShapeConfig("b", 4, 3, "train")):
            jfn = jloop._extras_fn(jget_config(name, smoke=True), shape)
            tfn = tloop.stub_extras(get_config(name, smoke=True), shape)
            if jfn is None:
                assert tfn is None
                continue
            want, got = jfn(3, 2), tfn(3, 2)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_microbatches_split_the_extras(rng):
    """Two microbatches: each takes its rows of every entry (the
    reference's interleaved split), so the step's loss is the one of the
    whole batch."""
    _, tc = _cfgs()
    flat = _np_params(tc)
    toks, extras = _inputs(rng, tc, b=4)
    batch = tstep.batch_to_device({"tokens": toks, "labels": toks,
                                   **extras}, "cpu")
    losses = []
    for nm in (1, 2):
        cfg = TrainConfig(num_microbatches=nm, remat_policy="none")
        step, opt = tstep.make_train_step(tc, cfg)
        params = params_from_numpy(flat, tc, device="cpu")
        _, _, m = step(params, opt.init(params), batch, 0)
        losses.append(float(m["loss"]))
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[0])


def test_serve_fns_forward_the_extras(rng):
    """prefill(..., extras) and decode(..., extras) against the reference's
    serve functions with the same extras."""
    jc, tc = _cfgs()
    flat = _np_params(tc)
    toks, extras = _inputs(rng, tc)
    jpre, jdec = jengine.make_serve_fns(jc)
    tpre, tdec = tengine.make_serve_fns(tc)
    jp = jax.tree.map(jnp.asarray, unflatten(flat))
    tp = params_from_numpy(flat, tc, device="cpu")
    s = toks.shape[1]
    jlast, jcache = jpre(jp, jnp.asarray(toks), jtf.init_cache(
        jc, 2, 24, dtype=jnp.float32), _jx(extras))
    with torch.inference_mode():
        tlast, tcache = tpre(tp, torch.from_numpy(toks), ttf.init_cache(
            tc, 2, 24, dtype=torch.float32, device="cpu"), _tx(extras))
    _close(tlast, jlast, MODEL_TOL["float32"])
    nxt = np.asarray(jnp.argmax(jlast, axis=-1))[:, None].copy()
    mpos = {"mrope_pos": np.full((2, 1, 3), 40, np.int32)}
    jlog, _ = jdec(jp, jcache, jnp.asarray(nxt, jnp.int32), jnp.int32(s),
                   _jx(mpos))
    with torch.inference_mode():
        tlog, _ = tdec(tp, tcache, torch.from_numpy(nxt), s, _tx(mpos))
    _close(tlog, jlog, MODEL_TOL["float32"])


def test_engine_raises_for_a_vlm_as_the_reference_engine():
    """The engines pass no extras, so an M-RoPE model finds no positions:
    both raise a KeyError naming ``mrope_pos``."""
    jc, tc = _cfgs()
    flat = _np_params(tc)
    prompt = np.arange(1, 9, dtype=np.int32)
    jeng = jengine.ServingEngine(jc, jax.tree.map(jnp.asarray,
                                                  unflatten(flat)),
                                 max_batch=1, max_len=16, jit=False)
    teng = tengine.ServingEngine(tc, params_from_numpy(flat, tc,
                                                       device="cpu"),
                                 max_batch=1, max_len=16, device="cpu")
    for eng in (jeng, teng):
        eng.submit(prompt, max_new_tokens=2)
        with pytest.raises(KeyError, match="mrope_pos"):
            eng.run_until_empty()


# -- the CLIs and the loop ------------------------------------------------------------


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


def test_serve_cli_serves_deepseek_and_raises_for_qwen2_vl(stack, capsys):
    assert serve_cli.main(["--arch", "deepseek-v2-236b", "--requests", "3",
                           "--max-new-tokens", "3",
                           *_cli_args(stack)]) == 0
    assert "served 3 requests" in capsys.readouterr().out
    with pytest.raises(KeyError, match="mrope_pos"):
        serve_cli.main(["--arch", NAME, "--requests", "1",
                        *_cli_args(stack)])


@pytest.mark.parametrize("arch", [NAME, "deepseek-v2-236b"])
def test_train_cli_trains_both_families(stack, capsys, arch):
    assert train_cli.main(["--arch", arch, "--steps", "2", "--seq-len",
                           "16", "--global-batch", "2",
                           *_cli_args(stack)]) == 0
    out = capsys.readouterr().out
    assert "done: steps=2 " in out


def test_train_loop_batches_carry_the_extras(monkeypatch):
    """train() on the VLM feeds ``stub_extras``'s patches and positions to
    every step, on the batch's rows."""
    _, tc = _cfgs()
    seen = []
    real = tstep.batch_to_device

    def spy(np_batch, device):
        seen.append({k: (v.shape, v.dtype) for k, v in np_batch.items()})
        return real(np_batch, device)
    monkeypatch.setattr(tloop, "batch_to_device", spy)

    class Stack:
        class _Agent:
            def set_step_constants(self, **kw):
                pass

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

        def job(self, *a, **k):
            return nullcontext()

        def host_agent(self, host):
            return self._Agent()

        def usermetric(self, host=None):
            return self._UM()

        def on_finding(self, fn):
            return fn

        def findings(self):
            return []

    shape = ShapeConfig("tiny", seq_len=16, global_batch=2, kind="train")
    res = tloop.train(tc, TrainConfig(total_steps=2, monitor=False), shape,
                      stack=Stack(), device="cpu", peak_flops=1e12,
                      hbm_bw=1e11)
    assert res.steps_run == 2 and np.isfinite(res.last_loss)
    assert seen == [{"tokens": ((2, 16), np.int32),
                     "labels": ((2, 16), np.int32),
                     "patches": ((2, 8, tc.d_model), np.float32),
                     "mrope_pos": ((2, 16, 3), np.int32)}] * 2
