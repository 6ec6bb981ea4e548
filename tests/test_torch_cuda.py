"""The port's hand-written CUDA kernels on the card (marker ``cuda``).

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch: ``PYTHONPATH=src python -m pytest -m cuda --noconftest
tests/test_torch_cuda.py``.  Each kernel is held against its plain PyTorch
version on the same inputs, at the reference's tolerances (fp32 attention
2e-5, fp32 rmsnorm 1e-5, fp32 SSD 2e-3, bf16 2e-2, model logits fp32 1e-4
and bf16 5e-2; the hybrid model's bf16 logits relative to the largest, as
in ``chip_smoke.py``).  The RMSNorm backward takes the forward's
tolerances, relative to (1 + |want|) as ``chip_smoke.compare`` does, and
for dscale, a sum over every row, relative to (1 + the sum of its terms'
magnitudes); the SSD backward 2e-3 in fp32 (1e-2 under strong decay, the
chunked algorithm's own fp32 error there) and 2e-2 in bf16, relative to
(1 + |want|), and where autograd adds per-head db/dc that were each
rounded to the dtype, one unit of the dtype at each term more;
training steps on the card against the same steps on the CPU in fp32 take
1e-4 relative; an MLA block's outputs and caches take the attention
tolerances relative to the largest (1 at least).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    mla_attention, mla_specs)
from repro_torch.models.layers import rope_table  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    flatten, init_params, unflatten)
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    forward, init_cache, init_model_params)
from repro_torch.serve.engine import ServingEngine  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

TOL = {"attn": {"float32": 2e-5, "bfloat16": 2e-2},
       "rms": {"float32": 1e-5, "bfloat16": 2e-2},
       "ssd": {"float32": 2e-3, "bfloat16": 2e-2},
       # the SSD backward (chip_smoke.TOL's note); under strong decay the
       # fp32 chunked algorithm's own error reaches ~1.5e-3 kernel vs plain
       "ssd_bwd": {"float32": 2e-3, "bfloat16": 2e-2},
       "ssd_bwd_strong_decay": {"float32": 1e-2, "bfloat16": 2e-2}}
# the statistic-from-outside kernels, which no path here launches
NO_SPLIT = {"rmsnorm_split": 0, "rmsnorm_split_backward": 0}


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


# The bf16 kernel's boundaries: its tiles are 128 query rows (two
# warpgroups of 64) by 128 keys (64 at D = 192), so S runs across one row,
# the warpgroup split, the tile edges and a second tile; every head dim it is
# built for; GQA groups 1 and 4; windows that are not a multiple of the
# tile, and long windowed sequences (mixtral's band, many skipped tiles);
# and non-causal with and without a window.
FLASH_EDGES = [(2, 4, 4, s, d, True, 0) for s in (1, 63, 64, 65, 127, 128, 129,
                                                 910)
               for d in (64, 112, 128, 192)] + \
    [(1, 8, 2, s, d, True, 0) for s in (1, 63, 64, 65, 127, 128, 129, 910)
     for d in (64, 112, 128, 192)] + \
    [(1, 8, 1, 910, 192, True, 300), (1, 4, 1, 1500, 128, True, 1024),
     (1, 4, 1, 1500, 192, True, 1000), (1, 4, 2, 700, 192, False, 200),
     (1, 4, 1, 4500, 128, True, 4096)] + \
    [(1, 8, 2, 910, 128, True, 100), (1, 8, 2, 910, 112, True, 200),
     (1, 4, 4, 910, 64, True, 100), (2, 4, 1, 910, 128, True, 200),
     (2, 4, 1, 300, 128, False, 0), (1, 4, 4, 129, 112, False, 0),
     (1, 8, 2, 910, 64, False, 150)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,d,causal,window", [
    (2, 8, 2, 128, 64, True, 0), (1, 8, 4, 37, 128, True, 0),
    (2, 4, 4, 200, 64, False, 0), (1, 8, 2, 300, 128, True, 100),
    (1, 4, 4, 150, 112, True, 0), (2, 8, 8, 64, 112, False, 0),
    *FLASH_EDGES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain(cuda, rng, b, h, kv, s, d, causal,
                                    window, dtype):
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda, dt) for shape in
        ((b, h, s, d), (b, kv, s, d), (b, kv, s, d)))
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    _close(got, ref.attention_ref(q, k, v, causal=causal, window=window),
           TOL["attn"][dtype])


@pytest.mark.cuda
def test_flash_kernel_reads_bshd_views_without_copies(cuda, rng):
    q = torch.from_numpy(rng.standard_normal((2, 70, 8, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((2, 70, 2, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    got = ops.flash_attention_bshd(q, k, k)
    assert got.is_contiguous() and got.shape == q.shape
    want = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             k.transpose(1, 2)).transpose(1, 2)
    _close(got, want, TOL["attn"]["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("s", [65, 910])
@pytest.mark.parametrize("d", [64, 112, 128, 192])
def test_flash_kernel_bshd_views_match_plain(cuda, rng, s, d):
    """The model's path: (B, S, H, D) activations through
    ``ops.flash_attention_bshd``, which hands the kernel transposed views
    (its tensor maps read them through their strides), GQA group 4."""
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda, torch.bfloat16) for shape in
        ((2, s, 8, d), (2, s, 2, d), (2, s, 2, d)))
    before = fa.launches
    got = ops.flash_attention_bshd(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.shape == q.shape and got.stride() == q.stride()
    want = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2)).transpose(1, 2)
    _close(got, want, TOL["attn"]["bfloat16"])


# The forward's plans: decode rows (at most rms.DECODE_ROWS, one or two
# vectors a thread: 1, 8, 33, 64), narrow rows a warp each in slots of 8
# (65, 1003: not a multiple of the slots), wide rows (7168; 1032 and 2056,
# whose vectors do not divide the threads: a ragged tail) and a short row.
@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(8, 4096), (1000, 512), (5, 1032),
                                 (1, 4096), (33, 4096), (64, 512),
                                 (65, 512), (1003, 512), (3, 7168),
                                 (100, 7168), (77, 2056), (300, 1032),
                                 (7, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain(cuda, rng, n, d, dtype):
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    x = x.to(cuda, dt)
    scale = torch.from_numpy(
        (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(cuda)
    before = rms.launches
    got = rms.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert rms.launches == before + 1
    _close(got, ref.rmsnorm_ref(x, scale), TOL["rms"][dtype])


def _rel_close(got, want, tol, magnitude=None):
    """|got - want| <= tol * (1 + m), m = |want| or given magnitudes."""
    g, w = got.float().cpu(), want.float().cpu()
    m = w.abs() if magnitude is None else magnitude.float().cpu()
    assert bool(((g - w).abs() <= tol * (1 + m)).all()), \
        float((g - w).abs().max())


def _dscale_magnitude(x, dy, eps=1e-5):
    """Sum over rows of |dy x r|: dscale's rounding grows with it, where a
    small dscale (terms that cancel) would hide it."""
    xf = x.float().reshape(-1, x.shape[-1])
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (dy.float().reshape(xf.shape).abs() * xf.abs() * r).sum(dim=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(8, 4096), (1000, 512), (5, 1032),
                                 (4097, 1032), (3, 7168), (7, 24),
                                 (300, 16384), (1003, 512), (9001, 512),
                                 (33, 4096), (2000, 4096), (77, 2056)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_backward_kernel_matches_plain(cuda, rng, n, d, dtype):
    """Narrow rows (a warp each, 16 slots a block; 1003 not a multiple of
    them, 9001 more rows than the card's slots, so each slot walks several
    and sums dscale across them) and wide rows, ragged n and d (1032, 2056:
    a ragged tail of vectors), slot sums beyond the default shared-memory
    window, one slot of 8 vectors a thread (16384 fp32)."""
    dt = getattr(torch, dtype)
    x, dy = (torch.from_numpy(rng.standard_normal((n, d)).astype(
        np.float32)).to(cuda, dt) for _ in range(2))
    scale = torch.from_numpy(
        (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(cuda)
    before = rms.bwd_launches
    dx, dscale = rms.rmsnorm_bwd(x, scale, dy)
    torch.cuda.synchronize()
    assert rms.bwd_launches == before + 1
    assert dx.dtype == dt and dscale.dtype == torch.float32
    want_dx, want_ds = ref.rmsnorm_bwd_ref(x, scale, dy)
    _rel_close(dx, want_dx, TOL["rms"][dtype])
    # dscale is an fp32 sum in the kernel and the plain version alike:
    # fp32's tolerance whatever x's dtype
    _rel_close(dscale, want_ds, TOL["rms"]["float32"],
               _dscale_magnitude(x, dy))
    again = rms.rmsnorm_bwd(x, scale, dy)[1]
    assert torch.equal(again, dscale)              # no atomics: same bits


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernels_read_strided_rows(cuda, rng, dtype):
    """MLA's latent: the first 512 columns of (B, S, 576) rows, read in
    place by both kernels (dy strided too); the outputs are contiguous."""
    dt = getattr(torch, dtype)
    x, dy = (torch.from_numpy(rng.standard_normal((3, 37, 576)).astype(
        np.float32)).to(cuda, dt)[..., :512] for _ in range(2))
    scale = torch.from_numpy(
        (1.0 + 0.1 * rng.standard_normal(512)).astype(np.float32)).to(cuda)
    assert rms.rows(x) == (3 * 37, 576)
    before = (rms.launches, rms.bwd_launches)
    y = rms.rmsnorm(x, scale)
    dx, dscale = rms.rmsnorm_bwd(x, scale, dy)
    torch.cuda.synchronize()
    assert (rms.launches, rms.bwd_launches) == (before[0] + 1,
                                                 before[1] + 1)
    assert y.is_contiguous() and dx.is_contiguous()
    _close(y, ref.rmsnorm_ref(x, scale), TOL["rms"][dtype])
    want_dx, want_ds = ref.rmsnorm_bwd_ref(x, scale, dy)
    _rel_close(dx, want_dx, TOL["rms"][dtype])
    _rel_close(dscale, want_ds, TOL["rms"]["float32"],
               _dscale_magnitude(x, dy))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["stride", "offset", "transposed",
                                    "leading"])
def test_rmsnorm_kernels_refuse_unreadable_rows(cuda, dtype, layout):
    """A row stride that is not a multiple of 16 bytes, rows that start off
    a 16-byte boundary, a last dim that is not contiguous, leading dims
    that do not flatten to one stride: ValueError, and no launch."""
    dt = getattr(torch, dtype)
    vec = 16 // torch.tensor([], dtype=dt).element_size()
    if layout == "stride":
        x = torch.randn(8, 512 + vec // 2, device=cuda).to(dt)[:, :512]
    elif layout == "offset":
        x = torch.randn(8 * 512 + 1, device=cuda).to(dt)[1:].view(8, 512)
    elif layout == "transposed":
        x = torch.randn(512, 8, device=cuda).to(dt).t()
    else:
        x = torch.randn(4, 3, 512, device=cuda).to(dt).transpose(0, 1)
    assert rms.rows(x) is None
    scale = torch.ones(512, device=cuda)
    before = (rms.launches, rms.bwd_launches)
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        rms.rmsnorm(x, scale)
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        rms.rmsnorm_bwd(x, scale, x)
    assert (rms.launches, rms.bwd_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_under_grad_runs_the_backward_kernel(cuda, rng, dtype):
    dt = getattr(torch, dtype)
    xn = rng.standard_normal((3, 11, 512)).astype(np.float32)
    x = torch.from_numpy(xn).to(cuda, dt).requires_grad_()
    scale = torch.ones(512, device=cuda, requires_grad=True)
    dy = torch.from_numpy(rng.standard_normal((3, 11, 512)).astype(
        np.float32)).to(cuda, dt)
    ops.reset_launch_counts()
    y = ops.fused_rmsnorm(x, scale)
    assert y.grad_fn is not None
    y.backward(dy)
    assert ops.launch_counts()["rmsnorm"] == 1
    assert ops.launch_counts()["rmsnorm_backward"] == 1
    xr = x.detach().clone().requires_grad_()
    sr = scale.detach().clone().requires_grad_()
    ref.rmsnorm_ref(xr, sr).backward(dy)
    _rel_close(x.grad, xr.grad, TOL["rms"][dtype])
    _rel_close(scale.grad, sr.grad, TOL["rms"]["float32"],
               _dscale_magnitude(x.detach(), dy))
    with torch.inference_mode():
        ops.fused_rmsnorm(x, scale)
    assert ops.launch_counts()["rmsnorm_backward"] == 1


def _split_rows(rng, cuda, n, d, dt):
    """x, dy (n, 2d) and scale (2d,) on the card: two "model" ranks'
    columns of rows of 2d."""
    x, dy = (torch.from_numpy(rng.standard_normal((n, 2 * d)).astype(
        np.float32)).to(cuda, dt) for _ in range(2))
    scale = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(2 * d)).astype(
        np.float32)).to(cuda)
    return x, dy, scale


# the statistic from outside at zamba2's rank rows (d_inner 7168 on two
# "model" ranks: 3584 columns a rank): the TP world's training rows, phase
# 4's, a decode batch, and ragged row counts
SPLIT_ROWS = [(8192, 3584), (16384, 3584), (8, 3584), (1003, 3584),
              (4097, 512), (7, 1032)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", SPLIT_ROWS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_split_kernels_match_plain(cuda, rng, n, d, dtype):
    """Rank 0's d columns of rows of 2d (read with a row stride of 2d),
    its statistic completed by the other half's sums through ``reduce``:
    the forward against the plain norm of the whole rows cut to its
    columns, and against ``ref.rmsnorm_split_ref``; the backward's dx and
    dscale against the whole rows' plain gradient cut likewise, dscale the
    same bits on a second call.  One launch each counted."""
    dt = getattr(torch, dtype)
    full, dy_full, scale_full = _split_rows(rng, cuda, n, d, dt)
    x, dy, scale = full[:, :d], dy_full[:, :d], scale_full[:d]
    other = full[:, d:].float()
    other_ss = other.square().sum(-1)
    other_dot = (other * dy_full[:, d:].float() * scale_full[d:]).sum(-1)
    before = (rms.split_launches, rms.split_bwd_launches)
    y, ss = rms.rmsnorm_split(x, scale, width=2 * d,
                              reduce=lambda t: t + other_ss)
    dx, dscale = rms.rmsnorm_split_bwd(x, scale, dy, ss, width=2 * d,
                                       reduce=lambda t: t + other_dot)
    torch.cuda.synchronize()
    assert (rms.split_launches, rms.split_bwd_launches) == (
        before[0] + 1, before[1] + 1)
    assert y.dtype == dt and y.is_contiguous() and dx.is_contiguous()
    _close(y, ref.rmsnorm_ref(full, scale_full)[:, :d], TOL["rms"][dtype])
    plain_y, plain_ss = ref.rmsnorm_split_ref(
        x, scale, width=2 * d, reduce=lambda t: t + other_ss)
    _close(y, plain_y, TOL["rms"][dtype])
    _rel_close(ss, plain_ss, TOL["rms"]["float32"])
    want_dx, want_ds = ref.rmsnorm_bwd_ref(full, scale_full, dy_full)
    _rel_close(dx, want_dx[:, :d], TOL["rms"][dtype])
    _rel_close(dscale, want_ds[:d], TOL["rms"]["float32"],
               _dscale_magnitude(full, dy_full)[:d])
    again = rms.rmsnorm_split_bwd(x, scale, dy, ss, width=2 * d,
                                  reduce=lambda t: t + other_dot)[1]
    assert torch.equal(again, dscale)              # no atomics: same bits


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_split_under_grad_runs_its_kernels(cuda, rng, dtype):
    """``ops.fused_rmsnorm_split`` on a one-rank "model" axis (the
    statistic is the row's own, width = d): its forward and backward
    kernels launch once each under grad, none of the fused kernels, and
    the gradients are the fused RMSNorm's plain ones."""
    dt = getattr(torch, dtype)
    xn = rng.standard_normal((3, 11, 512)).astype(np.float32)
    x = torch.from_numpy(xn).to(cuda, dt).requires_grad_()
    scale = torch.ones(512, device=cuda, requires_grad=True)
    dy = torch.from_numpy(rng.standard_normal((3, 11, 512)).astype(
        np.float32)).to(cuda, dt)
    ops.reset_launch_counts()
    y = ops.fused_rmsnorm_split(x, scale, width=512, mesh=None)
    y.backward(dy)
    counts = ops.launch_counts()
    assert (counts["rmsnorm_split"], counts["rmsnorm_split_backward"],
            counts["rmsnorm"], counts["rmsnorm_backward"]) == (1, 1, 0, 0)
    xr = x.detach().clone().requires_grad_()
    sr = scale.detach().clone().requires_grad_()
    ref.rmsnorm_ref(xr, sr).backward(dy)
    _close(y.detach(), ref.rmsnorm_ref(x.detach(), scale.detach()),
           TOL["rms"][dtype])
    _rel_close(x.grad, xr.grad, TOL["rms"][dtype])
    _rel_close(scale.grad, sr.grad, TOL["rms"]["float32"],
               _dscale_magnitude(x.detach(), dy))


@pytest.mark.cuda
def test_train_flash_attention_raises_under_grad(cuda):
    cfg = _two_layer_lms_demo("bfloat16")
    p = init_model_params(cfg, seed=0, device=cuda)
    leaf = p["dense_layers"]["attn"]["wq"].requires_grad_()
    toks = torch.zeros((1, 64), dtype=torch.long, device=cuda)
    with pytest.raises(NotImplementedError, match="forward-only"):
        forward(p, cfg, tokens=toks, mode="train", attn_impl="flash")
    with torch.no_grad():
        logits, _ = forward(p, cfg, tokens=toks, mode="train",
                            attn_impl="flash")
    assert logits.shape == (1, 64, cfg.vocab_padded)
    assert leaf.requires_grad


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_train_steps_on_card_match_cpu(cuda, rng, optimizer):
    """Two layers at lms-demo widths in fp32: three steps (2 microbatches,
    remat "minimal") through the kernels on the card against the plain
    versions on the CPU, same params and batches."""
    cfg = _two_layer_lms_demo("float32")
    tcfg = TrainConfig(optimizer=optimizer, warmup_steps=0,
                       learning_rate=1e-3, num_microbatches=2)
    toks = rng.integers(0, cfg.vocab_size, (3, 4, 65))
    out = {}
    for dev in ("cpu", cuda):
        p = init_model_params(cfg, seed=0, device="cpu")
        p = unflatten({k: v.to(dev) for k, v in flatten(p).items()})
        step_fn, opt = make_train_step(cfg, tcfg)
        state = opt.init(p)
        out[str(dev)] = []
        for i in range(3):
            t = torch.from_numpy(toks[i]).to(dev)
            p, state, m = step_fn(p, state, {"tokens": t[:, :-1],
                                             "labels": t[:, 1:]}, i)
            out[str(dev)].append([float(m[k]) for k in
                                  ("loss", "grad_norm", "param_norm")])
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [65, 910])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_adapter_with_narrower_v_on_card_matches_cpu(cuda, rng, s,
                                                           dtype):
    """MLA's prefill: q and k 192 wide, v 128.  The adapter pads V to 192
    for the D = 192 instance and returns the first 128 columns, on the card
    as on the CPU (around the plain version there); one launch."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dt) for shape in
        ((2, s, 4, 192), (2, s, 4, 192), (2, s, 4, 128)))
    want = ops.flash_attention_bshd(q, k, v)
    before = fa.launches
    got = ops.flash_attention_bshd(q.to(cuda), k.to(cuda), v.to(cuda))
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.shape == (2, s, 4, 128) and got.dtype == dt
    _close(got, want, TOL["attn"][dtype])
    with pytest.raises(ValueError, match="wider"):
        ops.flash_attention_bshd(q.to(cuda)[..., :128],
                                 k.to(cuda)[..., :128], v.to(cuda)[..., :1]
                                 .expand(2, s, 4, 192))
    with pytest.raises(ValueError, match="head dim"):     # no D = 24
        ops.flash_attention_bshd(q.to(cuda)[..., :24], k.to(cuda)[..., :24],
                                 v.to(cuda)[..., :16])
    assert fa.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_mla_block_prefill_and_decode_on_card_match_cpu(cuda, rng, dtype,
                                                        tol):
    """One MLA block at deepseek's head and latent widths (qk 128 + 64, v
    128, lora 512 / 1536), 4 heads: a 45-token prefill through the flash
    adapter and the RMSNorm kernel (q_norm, kv_norm), then 3 absorbed decode
    steps, on the card against the CPU; outputs relative to the largest,
    the caches too."""
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), d_model=512,
                              num_heads=4, num_kv_heads=4, dtype=dtype)
    dt = getattr(torch, dtype)
    a = cfg.mla
    p_cpu = init_params(mla_specs(cfg), seed=0, device="cpu")
    p_gpu = {k: v.to(cuda) for k, v in p_cpu.items()}
    xs = [torch.from_numpy(rng.standard_normal((2, n, 512)).astype(
        np.float32)).to(dt) for n in (45, 1, 1, 1)]
    ops.reset_launch_counts()
    outs = {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
        cache = {"ckv": torch.zeros((2, 64, a.kv_lora_rank), dtype=dt,
                                    device=dev),
                 "krope": torch.zeros((2, 64, a.qk_rope_head_dim), dtype=dt,
                                      device=dev)}
        ys, pos = [], 0
        with torch.inference_mode():
            for mode, x in zip(("prefill", "decode", "decode", "decode"),
                               xs):
                n = x.shape[1]
                rope = rope_table(torch.arange(pos, pos + n, device=dev)
                                  [None], a.qk_rope_head_dim, cfg.rope_theta)
                y, cache = mla_attention(p, x.to(dev), cfg, rope=rope,
                                         mode=mode, cache=cache,
                                         pos=None if mode == "prefill"
                                         else pos)
                ys.append(y.float().cpu())
                pos += n
        outs[dev] = ys + [cache["ckv"].float().cpu(),
                          cache["krope"].float().cpu()]
    for want, got in zip(outs["cpu"], outs["cuda"]):
        err = float((got - want).abs().max())
        assert err <= tol * max(1.0, float(want.abs().max())), err
    assert ops.launch_counts() == {"flash_attention": 1, "rmsnorm": 2 * 4,
                                   "rmsnorm_backward": 0, "ssd_scan": 0,
                                   "ssd_scan_backward": 0, **NO_SPLIT}


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 4, 16, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q[:, :2], q[:, :2])
    x = torch.zeros(4, 12, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        rms.rmsnorm(x, torch.ones(12, device=cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rms.rmsnorm(x.half()[:, :8].contiguous(), torch.ones(8, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        rms.rmsnorm_bwd(x, torch.ones(12, device=cuda), x)
    y = torch.zeros(4, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        rms.rmsnorm_bwd(y, torch.ones(16, device=cuda), y.t().contiguous().t())
    with pytest.raises(ValueError, match="does not match"):
        rms.rmsnorm_bwd(y, torch.ones(16, device=cuda), y.float())


def _two_layer_lms_demo(dtype):
    return dataclasses.replace(get_config("lms-demo"), num_layers=2,
                               dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_model_on_card_matches_plain_on_cpu(cuda, rng, dtype, tol):
    """lms-demo widths (d=512, head_dim 64), 2 layers: prefill + 3 decode
    steps through the kernels on the card vs the plain versions on the
    CPU, same weights."""
    cfg = _two_layer_lms_demo(dtype)
    p_cpu = init_model_params(cfg, seed=0, device="cpu")
    p_gpu = unflatten({k: v.to(cuda) for k, v in flatten(p_cpu).items()})
    toks = rng.integers(0, cfg.vocab_size, (2, 45))
    ops.reset_launch_counts()
    with torch.inference_mode():
        outs = []
        for dev, p in (("cpu", p_cpu), (cuda, p_gpu)):
            cache = init_cache(cfg, 2, 64, device=dev)
            t = torch.from_numpy(toks).to(dev)
            logits, cache = forward(p, cfg, tokens=t, mode="prefill",
                                    cache=cache)
            seq = [logits[:, -1]]
            nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
            for step in range(3):
                logits, cache = forward(p, cfg, tokens=nxt, mode="decode",
                                        cache=cache, pos=45 + step)
                seq.append(logits[:, -1])
                nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
            outs.append(seq)
    for a, b in zip(*outs):
        _close(b, a, tol)
    assert ops.launch_counts() == {"flash_attention": 2,
                                   "rmsnorm": 4 * (2 * 2 + 1),
                                   "rmsnorm_backward": 0, "ssd_scan": 0,
                                   "ssd_scan_backward": 0, **NO_SPLIT}


@pytest.mark.cuda
def test_engine_on_card_matches_engine_on_cpu(cuda, rng):
    cfg = _two_layer_lms_demo("float32")
    p_cpu = init_model_params(cfg, seed=1, device="cpu")
    p_gpu = unflatten({k: v.to(cuda) for k, v in flatten(p_cpu).items()})
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in (9, 30, 17)]
    outs = []
    for dev, p in (("cpu", p_cpu), (cuda, p_gpu)):
        eng = ServingEngine(cfg, p, max_batch=2, max_len=64, device=dev)
        for pr in prompts:
            eng.submit(pr, max_new_tokens=5)
        outs.append([r.output for r in eng.run_until_empty()])
    assert outs[0] == outs[1]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,g,decay,init", [
    (2, 200, 8, 1, 0.1, True),      # b/c shared by every head, ragged L
    (1, 37, 6, 3, 0.1, False),      # 3 groups, L shorter than a chunk
    (2, 128, 4, 1, 20.0, True),     # strong decay
    (2, 1, 4, 1, 0.5, True)])       # one step, as a decode would
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain(cuda, rng, b, l, h, g, decay, init, dtype):
    """Model-layout views as the served path passes them: x (B,L,H,P)
    transposed, b/c strided slices of one activation; y and the final
    state against the sequential recurrence."""
    dt = getattr(torch, dtype)
    p = n = 64

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda)
    x = arr(b, l, h, p).to(dt)
    a = -decay * arr(b, l, h).abs()
    bc = arr(b, l, 2 * g * n).to(dt)
    bm, cm = bc[..., :g * n].view(b, l, g, n), bc[..., g * n:].view(b, l, g, n)
    s0 = arr(b, h, p, n) if init else None
    before = ssd.launches
    y, state = ops.ssd_chunked_kernel(x, a, bm, cm, s0)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    assert y.shape == x.shape and y.dtype == dt
    want_y, want_state = ref.ssd_ref(x.transpose(1, 2), a.transpose(1, 2),
                                     bm.transpose(1, 2), cm.transpose(1, 2),
                                     s0)
    _close(y, want_y.transpose(1, 2), TOL["ssd"][dtype])
    _close(state, want_state, TOL["ssd"][dtype])
    assert bool(torch.isfinite(y.float()).all())


# The bf16 kernel's boundaries: chunks of 64 steps in a ring of two stages,
# two heads of one group per block.  L runs across one chunk, the ring and
# a ragged tail; head counts the two heads a block takes do not divide
# (7 heads of one group; 2 groups of 3); one step; strong decay.
SSD_EDGES = [(1, l, 4, 1, 0.1) for l in (63, 64, 65, 127, 128, 129, 192,
                                         193, 300)] + \
    [(2, 150, 7, 1, 0.1), (1, 130, 6, 2, 0.1), (2, 1, 7, 1, 0.5),
     (1, 257, 4, 2, 20.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,g,decay", SSD_EDGES)
@pytest.mark.parametrize("init", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_edges_match_plain(cuda, rng, b, l, h, g, decay, init,
                                      dtype):
    """(B, H, L, P) inputs as the wrapper takes them, b/c with G groups;
    y and the final state against the sequential recurrence."""
    dt = getattr(torch, dtype)

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda)
    x = arr(b, h, l, 64).to(dt)
    a = -decay * arr(b, h, l).abs()
    bm, cm = arr(b, g, l, 64).to(dt), arr(b, g, l, 64).to(dt)
    s0 = arr(b, h, 64, 64) if init else None
    before = ssd.launches
    y, state = ssd.ssd_scan(x, a, bm, cm, s0)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    want_y, want_state = ref.ssd_ref(x, a, bm, cm, s0)
    _close(y, want_y, TOL["ssd"][dtype])
    _close(state, want_state, TOL["ssd"][dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_reads_a_zero_head_stride(cuda, rng, dtype):
    """b/c broadcast over heads as an expanded view (head stride 0) give
    what the grouped layout gives."""
    b, l, h, n = 1, 70, 4, 64
    x, bm, cm = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(cuda, getattr(torch, dtype))
        for s in ((b, l, h, 64), (b, l, 1, n), (b, l, 1, n)))
    a = -0.1 * torch.rand((b, l, h), device=cuda)
    y1, s1 = ops.ssd_chunked_kernel(x, a, bm, cm)
    y2, s2 = ops.ssd_chunked_kernel(x, a, bm.expand(b, l, h, n),
                                    cm.expand(b, l, h, n))
    torch.testing.assert_close(y1, y2)
    torch.testing.assert_close(s1, s2)


@pytest.mark.cuda
def test_ssd_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(1, 2, 8, 16, device=cuda)
    a = torch.zeros(1, 2, 8, device=cuda)
    bm = torch.zeros(1, 1, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="built for"):
        ssd.ssd_scan(x, a, bm, bm)
    x = torch.zeros(1, 2, 8, 64, device=cuda, dtype=torch.bfloat16)
    wide = torch.zeros(1, 1, 8, 65, device=cuda, dtype=torch.bfloat16)
    bm = wide[..., 1:]                  # rows not 16-byte aligned
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_scan(x, a, bm, bm)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ssd.ssd_scan(x.half(), a, bm.half(), bm.half())


def _small_hybrid(dtype, num_layers, attn_every):
    """zamba2-7b's layout at small width with the kernels' head dims
    (Mamba2 P = N = 64, 2 shared attention blocks of head dim 112)."""
    from repro_torch.configs import HybridConfig
    cfg = get_config("zamba2-7b")
    return dataclasses.replace(
        cfg, num_layers=num_layers, d_model=256, num_heads=2, num_kv_heads=2,
        head_dim=112, d_ff=512, vocab_size=500, vocab_pad_to=128,
        hybrid=HybridConfig(attn_every=attn_every, num_shared_blocks=2),
        dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,num_layers,attn_every", [
    ("float32", 1e-4, 5, 2),        # 2 groups of 2 and 1 trailing layer
    ("bfloat16", 5e-2, 2, 1)])      # 2 groups of 1: bf16 noise grows with depth
def test_hybrid_model_on_card_matches_plain_on_cpu(cuda, rng, dtype, tol,
                                                   num_layers, attn_every):
    """Prefill + 3 decode steps through the kernels on the card vs the
    plain versions on the CPU, same weights (decays made non-trivial) and
    decode tokens; fp32 elementwise, bf16 relative to the largest logit."""
    cfg = _small_hybrid(dtype, num_layers, attn_every)
    flat = flatten(init_model_params(cfg, seed=0, device="cpu"))
    for k in flat:
        if k.endswith(("A_log", "dt_bias")):
            flat[k] = torch.from_numpy(
                0.5 * rng.standard_normal(tuple(flat[k].shape))).float()
    p_cpu = unflatten(flat)
    p_gpu = unflatten({k: v.to(cuda) for k, v in flat.items()})
    toks = rng.integers(0, cfg.vocab_size, (2, 45))
    ops.reset_launch_counts()
    fed = []                        # decode tokens, chosen on the CPU
    with torch.inference_mode():
        outs = []
        for dev, p in (("cpu", p_cpu), (cuda, p_gpu)):
            cache = init_cache(cfg, 2, 64, device=dev)
            t = torch.from_numpy(toks).to(dev)
            logits, cache = forward(p, cfg, tokens=t, mode="prefill",
                                    cache=cache)
            seq = [logits[:, -1].float().cpu()]
            for step in range(3):
                if dev == "cpu":
                    fed.append(torch.argmax(seq[-1], dim=-1)[:, None])
                logits, cache = forward(p, cfg, tokens=fed[step].to(dev),
                                        mode="decode", cache=cache,
                                        pos=45 + step)
                seq.append(logits[:, -1].float().cpu())
            outs.append(seq)
    for want, got in zip(*outs):
        if dtype == "float32":
            _close(got, want, tol)
        else:
            err = float((got - want).abs().max())
            assert err <= tol * float(want.abs().max()), err
    groups = num_layers // attn_every
    assert ops.launch_counts() == {
        "flash_attention": groups,
        "rmsnorm": 4 * (2 * num_layers + 2 * groups + 1),
        "rmsnorm_backward": 0, "ssd_scan": num_layers,
        "ssd_scan_backward": 0, **NO_SPLIT}


@pytest.mark.cuda
def test_compat_raw_stream_is_the_current_stream(cuda):
    from repro_torch import compat
    assert compat.current_raw_stream(torch.cuda.current_device()) == \
        torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert compat.current_raw_stream(torch.cuda.current_device()) == \
            side.cuda_stream


def _small(name, dtype, **kw):
    """A model of ``name``'s family at widths the kernels have instances
    for, 2 layers."""
    return dataclasses.replace(get_config(name), num_layers=2, dtype=dtype,
                               vocab_size=500, vocab_pad_to=128, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype,tol,kw", [
    # nemotron's head dim 192, LayerNorm and squared ReLU
    ("nemotron-4-340b", "float32", 1e-4,
     {"d_model": 768, "num_heads": 4, "num_kv_heads": 1, "d_ff": 1024}),
    ("nemotron-4-340b", "bfloat16", 5e-2,
     {"d_model": 768, "num_heads": 4, "num_kv_heads": 1, "d_ff": 1024}),
    # mixtral's MoE with a window of 32 under 45-token prompts: the windowed
    # flash kernel, the ring filled from the tail and wrapped by decode
    ("mixtral-8x7b", "float32", 1e-4,
     {"d_model": 512, "num_heads": 4, "num_kv_heads": 2, "d_ff": 256,
      "sliding_window": 32})])
def test_window_and_moe_models_on_card_match_plain_on_cpu(cuda, rng, name,
                                                         dtype, tol, kw):
    """Prefill + 3 decode steps through the kernels on the card vs the
    plain versions on the CPU, same weights and decode tokens."""
    cfg = _small(name, dtype, **kw)
    if cfg.moe is not None:
        cfg.moe = dataclasses.replace(cfg.moe, d_ff_expert=256)
    p_cpu = init_model_params(cfg, seed=0, device="cpu")
    p_gpu = unflatten({k: v.to(cuda) for k, v in flatten(p_cpu).items()})
    toks = rng.integers(0, cfg.vocab_size, (2, 45))
    ops.reset_launch_counts()
    fed = []
    with torch.inference_mode():
        outs = []
        for dev, p in (("cpu", p_cpu), (cuda, p_gpu)):
            cache = init_cache(cfg, 2, 64, dtype=getattr(torch, dtype),
                               device=dev)
            logits, cache = forward(p, cfg, tokens=torch.from_numpy(toks).to(
                dev), mode="prefill", cache=cache)
            seq = [logits[:, -1].float().cpu()]
            for step in range(3):
                if dev == "cpu":
                    fed.append(torch.argmax(seq[-1], dim=-1)[:, None])
                logits, cache = forward(p, cfg, tokens=fed[step].to(dev),
                                        mode="decode", cache=cache,
                                        pos=45 + step)
                seq.append(logits[:, -1].float().cpu())
            outs.append(seq)
    for want, got in zip(*outs):
        err = float((got - want).abs().max())
        assert err <= tol * max(1.0, float(want.abs().max())), err
    norms = 0 if cfg.norm_type == "layernorm" else 4 * (2 * 2 + 1)
    assert ops.launch_counts() == {"flash_attention": 2, "rmsnorm": norms,
                                   "rmsnorm_backward": 0, "ssd_scan": 0,
                                   "ssd_scan_backward": 0, **NO_SPLIT}


# The SSD backward kernel: the chunk loop forward and in reverse, ragged
# tails, one step, groups of several heads (db/dc summed over them), strong
# decay, with and without an initial state (and then a final state's
# gradient).
SSD_BWD_CASES = [(2, 200, 8, 2, 0.1, True), (1, 150, 6, 3, 0.1, False),
                 (2, 64, 4, 1, 0.1, True), (1, 1, 4, 1, 0.5, True),
                 (1, 300, 7, 1, 20.0, False), (2, 129, 4, 4, 0.1, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,g,decay,init", SSD_BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_backward_kernel_matches_plain(cuda, rng, b, l, h, g, decay,
                                           init, dtype):
    """ssd.ssd_scan_bwd on model-layout views (x, a, dy transposed; b/c
    strided slices of one activation) against ref.ssd_bwd_ref on the same
    tensors: every gradient within TOL["ssd_bwd"] (strong decay:
    TOL["ssd_bwd_strong_decay"]), relative to (1 + |want|)."""
    dt = getattr(torch, dtype)
    p = n = 64

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda)
    x = arr(b, l, h, p).to(dt).transpose(1, 2)
    a = (-decay * arr(b, l, h).abs()).transpose(1, 2)
    bc = arr(b, l, 2 * g * n).to(dt)
    bm = bc[..., :g * n].view(b, l, g, n).transpose(1, 2)
    cm = bc[..., g * n:].view(b, l, g, n).transpose(1, 2)
    dy = arr(b, l, h, p).to(dt).transpose(1, 2)
    s0 = arr(b, h, p, n) if init else None
    ds = arr(b, h, p, n) if init else None
    before = ssd.bwd_launches
    got = ssd.ssd_scan_bwd(x, a, bm, cm, dy, s0, ds)
    torch.cuda.synchronize()
    assert ssd.bwd_launches == before + 1
    want = ref.ssd_bwd_ref(x, a, bm, cm, dy, s0, ds)
    assert got[0].dtype == dt and got[2].dtype == dt
    assert (got[4] is None) == (not init)
    tol = TOL["ssd_bwd" if decay < 1 else "ssd_bwd_strong_decay"][dtype]
    for g_, w in zip(got, want):
        if w is not None:
            _close(g_, w, tol)


# The 64 log decays of one chunk, drawn as -0.1 |N(0, 1)|, in which step 35
# (-1.1e-7) lies under one fp32 unit of the running sum (-2.297): acs is
# flat there, and a scan in another order than the sequential one can put
# acs_35 one unit above acs_34, a positive exponent the clamp at 0 binds.
FLAT_DECAYS = [
    -0.02196592, -0.16631137, -0.017171094, -0.0350335, -0.014462319,
    -0.03026332, -0.089864545, -0.08432474, -0.07017319, -0.050736774,
    -0.07065414, -0.019057384, -0.14043254, -0.027747605, -0.01907371,
    -0.17038898, -0.0127023235, -0.12130983, -0.062215514,
    -0.00047918796, -0.011967825, -0.003344342, -0.08618801,
    -0.015381331, -0.006760118, -0.061740793, -0.090830095, -0.2524493,
    -0.027608816, -0.014809215, -0.2551609, -0.06942038, -0.08597249,
    -0.015629275, -0.07582728, -1.1174713e-07, -0.012556513,
    -0.017205805, -0.00062338583, -0.026602585, -0.15916131,
    -0.0070993486, -0.028744107, -0.03292632, -0.01430026, -0.08070573,
    -0.012243589, -0.004591552, -0.064832576, -0.09030425, -0.05492563,
    -0.23361889, -0.036197644, -0.03126057, -0.017037516, -0.10073451,
    -0.047760636, -0.09129375, -0.006059023, -0.0369002, -0.10791872,
    -0.009841478, -0.2267011, -0.0029887669]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_backward_counts_a_decay_under_an_fp32_unit(cuda, rng, dtype):
    """A chunk whose acs stays flat across a tiny decay: the gradient is
    the unclamped function's, as the plain version's (exp of the segment
    sums, no clamp), so every term counts even where rounding makes an
    exponent positive.  Dropping that pair's term moves da at the flat
    step by ~14 (4.31 against 18.65 in fp32 and fp64)."""
    dt = getattr(torch, dtype)
    b, l, h, g, p, n = 1, 128, 2, 1, 64, 64

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda)
    a = (-0.1 * arr(b, h, l).abs()).contiguous()
    a[:, :, 64:] = torch.tensor(np.array(FLAT_DECAYS, np.float32),
                                device=cuda)
    x, dy = (arr(b, h, l, p).to(dt) for _ in range(2))
    bm, cm = (arr(b, g, l, n).to(dt) for _ in range(2))
    got = ssd.ssd_scan_bwd(x, a, bm, cm, dy)
    want = ref.ssd_bwd_ref(x, a, bm, cm, dy)
    for g_, w in zip(got, want):
        if w is not None:
            _close(g_, w, TOL["ssd_bwd"][dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,h,g,parts", [
    ("bfloat16", 112, 1, 56),     # zamba2: blocks of two heads
    ("bfloat16", 21, 3, 12),      # 7 heads a group: 4 blocks, one lone head
    ("float32", 112, 1, 112)])    # one partial a head
def test_ssd_bwd_partials(cuda, dtype, h, g, parts):
    """The library's count of the backward's db/dc partials a batch row,
    which sizes the scratch; an uneven split of heads is refused."""
    assert ssd.bwd_partials(getattr(torch, dtype), h, g) == parts
    with pytest.raises(ValueError):
        ssd.bwd_partials(getattr(torch, dtype), 10, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,g,broadcast", [
    (2, 260, 10, 2, False),     # 5 heads a group: blocks of 2, 2 and 1
    (1, 200, 6, 1, False),      # 6 heads of one group: 3 partials a row
    (2, 150, 4, 4, True)])      # b/c expanded over 4 groups: stride 0
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_backward_kernel_group_sums(cuda, rng, b, l, h, g, broadcast,
                                        dtype):
    """db/dc summed over a group's heads where the bf16 kernel's blocks of
    two heads leave several partials (and a lone head) a group, and where
    b/c reach ``ssd.ssd_scan_bwd`` as one group expanded over G groups
    (group stride 0: each group's gradient is still its own heads' sum),
    with an initial state and a final state's gradient; against
    ref.ssd_bwd_ref at TOL["ssd_bwd"]."""
    dt = getattr(torch, dtype)
    p = n = 64

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda)
    x = arr(b, l, h, p).to(dt).transpose(1, 2)
    a = (-0.1 * arr(b, l, h).abs()).transpose(1, 2)
    if broadcast:
        one = arr(b, l, 2, n).to(dt)
        bm = one[:, :, :1].expand(b, l, g, n).transpose(1, 2)
        cm = one[:, :, 1:].expand(b, l, g, n).transpose(1, 2)
        assert bm.stride(1) == cm.stride(1) == 0
    else:
        bc = arr(b, l, 2 * g * n).to(dt)
        bm = bc[..., :g * n].view(b, l, g, n).transpose(1, 2)
        cm = bc[..., g * n:].view(b, l, g, n).transpose(1, 2)
    dy = arr(b, l, h, p).to(dt).transpose(1, 2)
    s0, ds = arr(b, h, p, n), arr(b, h, p, n)
    got = ssd.ssd_scan_bwd(x, a, bm, cm, dy, s0, ds)
    torch.cuda.synchronize()
    want = ref.ssd_bwd_ref(x, a, bm, cm, dy, s0, ds)
    assert tuple(got[2].shape) == tuple(got[3].shape) == (b, g, l, n)
    for g_, w in zip(got, want):
        _close(g_, w, TOL["ssd_bwd"][dtype])


def _close_sum_of_rounded(got, want, terms, tol):
    """A sum over dim 2 of ``terms``, each rounded to its dtype before the
    sum: |got - want| <= tol * (1 + |want|) plus one unit of the dtype at
    each term (``terms`` the two sides' terms, the larger magnitude taken),
    since a term may round the other way on each side."""
    mag = torch.maximum(*(t.float().cpu().abs() for t in terms))
    unit = torch.finfo(terms[0].dtype).eps * \
        torch.exp2(torch.frexp(mag).exponent - 1.0)
    g, w = got.float().cpu(), want.float().cpu()
    limit = tol * (1.0 + w.abs()) + torch.where(mag > 0, unit, 0.0).sum(
        2, keepdim=True)
    excess = float(((g - w).abs() - limit).max())
    assert excess <= 0, excess


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_function_on_card_matches_cpu(cuda, rng, dtype):
    """ops.ssd_chunked_kernel under grad: the scan and backward kernels on
    the card against the plain versions on the CPU, model layout, b/c an
    expanded view of one group (zero stride) whose gradient sums over the
    heads; one forward and one backward launch.  Every gradient the
    backward writes (dx, da, each head's db and dc) is held at
    TOL["ssd_bwd"]; the one group's db/dc are autograd's sums of the heads'
    terms, each already rounded to the dtype, so they take that limit plus
    one unit of each term (:func:`_close_sum_of_rounded`): where bf16 terms
    cancel, one unit of a term exceeds the limit of their sum."""
    dt = getattr(torch, dtype)
    b, l, h, n = 2, 150, 4, 64
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((b, l, h, 64), (b, l, h), (b, l, 1, n), (b, l, 1, n),
             (b, l, h, 64))]
    arrs[1] = -0.1 * np.abs(arrs[1])
    out = {}
    for dev in ("cpu", cuda):
        x, a, bm, cm = (torch.from_numpy(v).to(dev, dt if i != 1 else
                                               torch.float32)
                        .requires_grad_() for i, v in enumerate(arrs[:4]))
        dy = torch.from_numpy(arrs[4]).to(dev, dt)
        ops.reset_launch_counts()
        bh, ch = bm.expand(b, l, h, n), cm.expand(b, l, h, n)
        y, _ = ops.ssd_chunked_kernel(x, a, bh, ch)
        grads = torch.autograd.grad(y, (x, a, bm, cm, bh, ch), dy)
        out[str(dev)] = [y.detach()] + list(grads)
        if dev == cuda:
            counts = ops.launch_counts()
            assert (counts["ssd_scan"], counts["ssd_scan_backward"]) == (1, 1)
    got, want = out["cuda"], out["cpu"]
    _close(got[0], want[0], TOL["ssd"][dtype])
    tol = TOL["ssd_bwd"][dtype]
    for i in (1, 2, 5, 6):                       # dx, da, db and dc by head
        _close(got[i], want[i], tol)
    for i in (3, 4):                             # the group's db, dc
        _close_sum_of_rounded(got[i], want[i], (got[i + 2], want[i + 2]),
                              tol)


@pytest.mark.cuda
def test_hybrid_train_steps_on_card_match_cpu(cuda, rng):
    """A small hybrid with the kernels' Mamba2 widths (2 groups of 2 and a
    trailing layer) in fp32: two AdamW steps (remat "minimal") through the
    SSD scan, its backward and the RMSNorm kernels on the card against the
    plain versions on the CPU, same params and batches: loss, grad norm
    and param norm at 1e-4 relative; launches as counted."""
    cfg = _small_hybrid("float32", 5, 2)
    tcfg = TrainConfig(optimizer="adamw", warmup_steps=0, learning_rate=1e-3,
                       remat_policy="minimal")
    toks = rng.integers(0, cfg.vocab_size, (2, 2, 97))
    out = {}
    for dev in ("cpu", cuda):
        p = init_model_params(cfg, seed=0, device="cpu")
        p = unflatten({k: v.to(dev) for k, v in flatten(p).items()})
        step_fn, opt = make_train_step(cfg, tcfg)
        state = opt.init(p)
        ops.reset_launch_counts()
        out[str(dev)] = []
        for i in range(2):
            t = torch.from_numpy(toks[i]).to(dev)
            p, state, m = step_fn(p, state, {"tokens": t[:, :-1],
                                             "labels": t[:, 1:]}, i)
            out[str(dev)].append([float(m[k]) for k in
                                  ("loss", "grad_norm", "param_norm")])
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-4)
    layers, groups = 5, 2
    norms = 2 * layers + 2 * groups + 1
    assert ops.launch_counts() == {
        "flash_attention": 0, "rmsnorm": 2 * (norms + 2 * layers),
        "rmsnorm_backward": 2 * norms, "ssd_scan": 2 * 2 * layers,
        "ssd_scan_backward": 2 * layers, **NO_SPLIT}


# -- RWKV6 and the encoder-decoder ---------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_at_the_encdec_prefill_shape(cuda, rng, dtype):
    """seamless-m4t-large-v2's decoder prefill, (8, 16 / 16, 910, 64),
    through the model-layout adapter, against the plain version."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal((8, 910, 16, 64)).astype(
        np.float32)).to(cuda, dt) for _ in range(3))
    before = fa.launches
    got = ops.flash_attention_bshd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=True).transpose(1, 2)
    _close(got, want, TOL["attn"][dtype])


def _new_family(name, dtype):
    """The smoke config of ``name``; the encoder-decoder at head dim 64 (a
    flash instance; the smoke head dim, 16, has none), 2 + 2 layers."""
    cfg = dataclasses.replace(get_config(name, smoke=True), dtype=dtype)
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, d_model=256, num_heads=4,
                                  num_kv_heads=4, head_dim=64)
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rwkv6-1.6b", "seamless-m4t-large-v2"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_new_families_on_card_match_cpu(cuda, rng, name, dtype, tol):
    """Prefill of 45 tokens (RWKV6's chunk gcd(45, 32) = 1; the
    encoder-decoder with its source frames) and 3 decode steps on the card
    (flash for the decoder's prefill self-attention, the RMSNorm kernel for
    RWKV6's final norm) against the same on the CPU, same weights; logits
    relative to the largest; launches as counted."""
    cfg = _new_family(name, dtype)
    p_cpu = init_model_params(cfg, seed=0, device="cpu")
    p_gpu = unflatten({k: v.to(cuda) for k, v in flatten(p_cpu).items()})
    toks = rng.integers(0, cfg.vocab_size, (2, 45))
    frames = rng.standard_normal((2, cfg.encdec_source_len,
                                  cfg.d_model)).astype(np.float32)
    ops.reset_launch_counts()
    outs = []
    with torch.inference_mode():
        for dev, p in (("cpu", p_cpu), (cuda, p_gpu)):
            extras = {"src_frames": torch.from_numpy(frames).to(dev)} \
                if cfg.family == "encdec" else None
            cache = init_cache(cfg, 2, 64, device=dev)
            logits, cache = forward(p, cfg, tokens=torch.from_numpy(
                toks).to(dev), mode="prefill", cache=cache, extras=extras)
            seq = [logits[:, -1]]
            nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
            for step in range(3):
                logits, cache = forward(p, cfg, tokens=nxt, mode="decode",
                                        cache=cache, pos=45 + step)
                seq.append(logits[:, -1])
                nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
            outs.append(seq)
    for a, b in zip(*outs):
        err = float((b.float().cpu() - a.float()).abs().max())
        assert err <= tol * float(a.float().abs().max()), err
    want = {"flash_attention": 2, "rmsnorm": 0} if cfg.family == "encdec" \
        else {"flash_attention": 0, "rmsnorm": 4}
    assert ops.launch_counts() == {**want, "rmsnorm_backward": 0,
                                   "ssd_scan": 0, "ssd_scan_backward": 0,
                                   **NO_SPLIT}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rwkv6-1.6b", "seamless-m4t-large-v2"])
def test_new_families_train_steps_on_card_match_cpu(cuda, rng, name):
    """Two AdamW steps in fp32 (remat "minimal", the loop's stub source
    frames for the encoder-decoder) on the card against the CPU: loss,
    grad norm and param norm at 1e-4 relative, but the RWKV6 model's grad
    norm after the first update at 1e-3: a 1e-7 relative perturbation of
    its parameters (fp32 rounding) moves that norm by 2.8e-4 on the CPU
    alone (AdamW's first step moves each parameter by about the learning
    rate, whatever its gradient's size)."""
    cfg = _new_family(name, "float32")
    tcfg = TrainConfig(optimizer="adamw", warmup_steps=0, learning_rate=1e-3,
                       remat_policy="minimal")
    toks = rng.integers(0, cfg.vocab_size, (2, 2, 65))
    frames = rng.standard_normal((2, 2, cfg.encdec_source_len,
                                  cfg.d_model)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        p = init_model_params(cfg, seed=0, device="cpu")
        p = unflatten({k: v.to(dev) for k, v in flatten(p).items()})
        step_fn, opt = make_train_step(cfg, tcfg)
        state = opt.init(p)
        out[str(dev)] = []
        for i in range(2):
            t = torch.from_numpy(toks[i]).to(dev)
            batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
            if cfg.family == "encdec":
                batch["src_frames"] = torch.from_numpy(frames[i]).to(dev)
            p, state, m = step_fn(p, state, batch, i)
            out[str(dev)].append([float(m[k]) for k in
                                  ("loss", "grad_norm", "param_norm")])
    got, want = np.array(out["cuda"]), np.array(out["cpu"])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got[1, [0, 2]], want[1, [0, 2]], rtol=1e-4)
    np.testing.assert_allclose(got[1, 1], want[1, 1],
                               rtol=1e-3 if cfg.family == "ssm" else 1e-4)


# -- the data-parallel path at world size 1 (NCCL) ----------------------------


@pytest.fixture
def nccl(cuda, tmp_path):
    """A one-rank NCCL process group through a file store in the test's
    directory."""
    import torch.distributed as dist
    store = dist.FileStore(str(tmp_path / "store"), 1)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield cuda
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_dist_step_on_one_card_is_the_one_device_step(nccl, rng, optimizer):
    """``make_train_step(mesh=make_mesh_for(1))`` on the card: its pieces
    are the leaves themselves (no copy) and three steps (2 microbatches)
    give the one-device step's numbers, the same bits."""
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.parallel.sharding import shard_tree
    from repro_torch.train.step import shardings
    cfg = _two_layer_lms_demo("float32")
    tcfg = TrainConfig(optimizer=optimizer, warmup_steps=0,
                       learning_rate=1e-3, num_microbatches=2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 4, 65)))
    mesh = make_mesh_for(1)
    out = {}
    for name in ("one", "mesh"):
        p = init_model_params(cfg, seed=0, device=nccl)
        step_fn, opt = make_train_step(
            cfg, tcfg, mesh=mesh if name == "mesh" else None)
        psh = None
        if name == "mesh":
            psh = shardings(cfg, tcfg, mesh)[0]
            pieces = shard_tree(p, psh, mesh)
            assert all(a is b for a, b in zip(flatten(pieces).values(),
                                              flatten(p).values()))
        state = opt.init(p, psh)
        out[name] = []
        for i in range(3):
            t = toks[i].to(nccl)
            p, state, m = step_fn(p, state, {"tokens": t[:, :-1],
                                             "labels": t[:, 1:]}, i)
            out[name].append([float(m[k]) for k in
                              ("loss", "grad_norm", "param_norm")])
    assert out["mesh"] == out["one"]


@pytest.mark.cuda
def test_a2a_dispatch_on_one_card_matches_grouped(nccl, rng):
    """The mixtral smoke MoE layer in fp32 through ``impl="a2a"`` on the
    (1, 1) mesh (NCCL's all-to-all of one rank) against the grouped
    dispatch: output and gradients within 1e-5 of the largest; the
    dispatch counter says which ran."""
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import (
        PartitionConstraints, TRAIN_RULES)
    cfg = dataclasses.replace(get_config("mixtral-8x7b", smoke=True),
                              dtype="float32")
    cfg.moe = dataclasses.replace(cfg.moe, impl="a2a")
    p = init_params(moe.moe_specs(cfg), seed=0, device=nccl)
    x = torch.from_numpy(rng.standard_normal((2, 40, cfg.d_model)).astype(
        np.float32)).to(nccl)
    pc = PartitionConstraints(TRAIN_RULES, make_mesh_for(1))
    out = {}
    for name, kw in (("grouped", {}), ("a2a", {"pc": pc})):
        leaves = {k: v.clone().requires_grad_()
                  for k, v in flatten(p).items()}
        moe.reset_dispatch_counts()
        y, _ = moe.apply_moe(unflatten(leaves), x, cfg, **kw)
        assert moe.dispatch_counts()[name] == 1
        grads = torch.autograd.grad((y ** 2).sum(), list(leaves.values()))
        out[name] = [y.detach()] + [g.detach() for g in grads]
    for got, want in zip(out["a2a"], out["grouped"]):
        scale = max(float(want.abs().max()), 1.0)
        assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_compressed_pmean_and_pipeline_on_one_card(nccl, rng):
    """int8 ``compressed_pmean`` over the one-rank NCCL group is the
    dequantised rows; ``pipeline_apply`` with one stage is the stage on the
    whole batch."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.train.compression import (
        compressed_pmean, dequantize_int8, quantize_int8)
    g = torch.from_numpy(rng.standard_normal((6, 33)).astype(
        np.float32)).to(nccl)
    got = compressed_pmean({"g": g}, dist.new_group([0]), "int8")["g"]
    assert torch.equal(got, dequantize_int8(*quantize_int8(g)))
    ws = torch.from_numpy((rng.standard_normal((1, 16, 16)) * 0.3).astype(
        np.float32)).to(nccl)
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(
        np.float32)).to(nccl)
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pipe",))
    y = pipeline_apply(lambda w, xb: torch.tanh(xb @ w), ws, x, mesh=mesh,
                       num_microbatches=4)
    _close(y, torch.tanh(x @ ws[0]), 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,h,g", [("bfloat16", 112, 1),
                                       ("bfloat16", 21, 3),
                                       ("float32", 112, 1)])
def test_meta_partials_are_the_librarys(cuda, dtype, h, g):
    """The counter's scratch formula (no library on a meta tensor) gives
    the library's count of the backward's partials."""
    dt = getattr(torch, dtype)
    assert ssd.bwd_partials_of(dt, h, g) == ssd.bwd_partials(dt, h, g)


@pytest.mark.cuda
def test_analysis_bounds_and_predicts_a_granite_step(cuda):
    """``launch.cost_analysis`` on one granite-width step (2 layers, 4 x
    1024 tokens, AdamW, remat "minimal"): the bound from its counts (bytes
    over 3.35 TB/s, flops over 989 TFLOP/s) does not exceed the measured
    step, and its predicted peak (arguments, what the step holds at once)
    lies within 10% of ``max_memory_allocated`` over the step, counted from
    what was allocated before the arguments were made."""
    import time
    from repro_torch.launch.cost_analysis import analyze_step
    cfg = dataclasses.replace(get_config("granite-3-8b"), num_layers=2)
    tcfg = TrainConfig(remat_policy="minimal", warmup_steps=1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = init_model_params(cfg, seed=0, device=cuda)
    step_fn, opt = make_train_step(cfg, tcfg)
    state = opt.init(params)
    g = torch.Generator(device=cuda).manual_seed(0)
    toks = torch.randint(1, cfg.vocab_size, (4, 1025), generator=g,
                         device=cuda)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    a = analyze_step(step_fn, (params, state, batch, 0))
    params, state, m = step_fn(params, state, batch, 0)
    float(m["loss"])
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    params, state, m = step_fn(params, state, batch, 1)
    float(m["loss"])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    per = a["per_device"]
    bound = max(per["flops"] / 989e12, per["bytes"] / 3.35e12)
    assert 0 < bound <= step_s, (bound, step_s)
    predicted = a["memory"]["peak_bytes"]
    assert abs(predicted - measured) <= 0.10 * measured, (predicted,
                                                          measured)
