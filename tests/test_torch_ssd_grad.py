"""The SSD scan's gradient in the port vs autograd and the JAX package, on
the CPU.

``kernels.ref.ssd_bwd_ref`` (the plain version of the SSD backward kernel:
autograd through the port's chunked plain form) is held to autograd
through the sequential ``ref.ssd_ref`` and to ``jax.vjp`` of the
reference's ``models.ssm.ssd_chunked``, on the same numpy inputs: one and
two groups (b/c shared by the heads of a group, their gradients summed over
those heads), ragged L over three and more chunks of 64, with and without
an initial state (and then the final state's gradient too).  Tolerances
(elementwise, relative and absolute): fp32 1e-4 (sums in another order, and
da sums products of two (P, N) matrices); bf16 2e-2, the inputs rounded to
bf16 on both sides, the port's arithmetic in fp32 from them, JAX's in fp32
on the same rounded values, and dx, db, dc rounded to bf16.  The CUDA
kernel itself is held to ``ssd_bwd_ref`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Also: the autograd adapter ``ops.ssd_chunked_kernel`` under grad (model
layout, zero-stride broadcast groups), the wrapper's argument checks and
its meta path, and the backward cost model.
"""

from contextlib import nullcontext

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _inputs(rng, b, h, g, l, p, n, *, init, decay=0.1):
    """Kernel-layout inputs: x (B,H,L,P), a (B,H,L) <= 0, b/c (B,G,L,N),
    dy (B,H,L,P), and with ``init`` an initial state and a final-state
    gradient (B,H,P,N)."""
    out = {"x": rng.standard_normal((b, h, l, p)),
           "a": -decay * np.abs(rng.standard_normal((b, h, l))),
           "b": rng.standard_normal((b, g, l, n)),
           "c": rng.standard_normal((b, g, l, n)),
           "dy": rng.standard_normal((b, h, l, p))}
    if init:
        out["init"] = rng.standard_normal((b, h, p, n))
        out["dstate"] = rng.standard_normal((b, h, p, n))
    return {k: v.astype(np.float32) for k, v in out.items()}


def _torch(arrs, dtype):
    """x, b, c, dy in ``dtype``; a and the states fp32."""
    return {k: torch.from_numpy(v).to(dtype if k in ("x", "b", "c", "dy")
                                      else torch.float32)
            for k, v in arrs.items()}


def _rounded(arrs, dtype):
    """The numpy inputs as the port sees them in ``dtype``, back in fp32."""
    return {k: _np(v) for k, v in _torch(arrs, dtype).items()}


def _jax_grads(arrs):
    """jax.vjp of the reference's ssd_chunked (model layout, groups
    broadcast to heads inside, chunk 64) at the kernel-layout inputs."""
    h, g = arrs["x"].shape[1], arrs["b"].shape[1]
    init = "init" in arrs

    def f(x, a, b, c, *s0):
        def heads(m):                         # (B,G,L,N) -> (B,L,H,N)
            return jnp.repeat(jnp.moveaxis(m, 1, 2), h // g, axis=2)
        y, state = jssm.ssd_chunked(
            jnp.moveaxis(x, 1, 2), jnp.moveaxis(a, 1, 2), heads(b), heads(c),
            chunk=64, init_state=s0[0] if init else None)
        return jnp.moveaxis(y, 1, 2), state

    args = [jnp.asarray(arrs[k]) for k in ("x", "a", "b", "c")]
    if init:
        args.append(jnp.asarray(arrs["init"]))
    (y, state), vjp = jax.vjp(f, *args)
    dstate = jnp.asarray(arrs["dstate"]) if init else jnp.zeros_like(state)
    return [np.asarray(t) for t in vjp((jnp.asarray(arrs["dy"]), dstate))]


def _torch_seq_grads(arrs):
    """Autograd through the sequential ``ref.ssd_ref`` in fp32."""
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in arrs.items()
         if k not in ("dy", "dstate")}
    leaves = [t[k] for k in ("x", "a", "b", "c")] + \
        ([t["init"]] if "init" in t else [])
    y, state = ref.ssd_ref(*leaves)
    outs, grads = [y], [torch.from_numpy(arrs["dy"])]
    if "dstate" in arrs:
        outs.append(state)
        grads.append(torch.from_numpy(arrs["dstate"]))
    return torch.autograd.grad(outs, leaves, grads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("g,l", [(1, 150), (2, 200)])
def test_ssd_bwd_ref_matches_autograd_and_jax(rng, dtype, init, g, l):
    arrs = _inputs(rng, 2, 4, g, l, 16, 8, init=init)
    t = _torch(arrs, getattr(torch, dtype))
    got = ref.ssd_bwd_ref(t["x"], t["a"], t["b"], t["c"], t["dy"],
                          t.get("init"), t.get("dstate"))
    assert got[0].dtype == t["x"].dtype and got[2].dtype == t["b"].dtype
    assert got[1].dtype == torch.float32
    assert tuple(got[2].shape) == (2, g, l, 8)
    assert (got[4] is None) == (not init)
    want_seq = _torch_seq_grads(_rounded(arrs, getattr(torch, dtype)))
    want_jax = _jax_grads(_rounded(arrs, getattr(torch, dtype)))
    for gt, ws, wj in zip(got, want_seq, want_jax):
        _close(gt, ws, TOL[dtype])
        _close(gt, wj, TOL[dtype])


def test_ssd_chunked_ref_matches_the_recurrence_and_ssd_chunked(rng):
    """The plain chunked form (zero-padded ragged tail) is the recurrence:
    y and the final state at 2e-4, ssd_chunked's tolerance in
    tests/test_torch_ssm.py."""
    arrs = _inputs(rng, 2, 4, 2, 150, 16, 8, init=True)
    t = _torch(arrs, torch.float32)
    args = (t["x"], t["a"], t["b"], t["c"], t["init"])
    y, state = ref.ssd_chunked_ref(*args)
    want_y, want_state = ref.ssd_ref(*args)
    _close(y, want_y, 2e-4)
    _close(state, want_state, 2e-4)
    y16, _ = ref.ssd_chunked_ref(*args, chunk=16)
    _close(y16, want_y, 2e-4)


@pytest.mark.parametrize("broadcast", [False, True])
def test_ssd_function_grads_in_model_layout(rng, broadcast):
    """ops.ssd_chunked_kernel under grad: model layout (B, L, H, P), b/c
    strided slices of one activation or (``broadcast``) a zero-stride
    expand of one group to two, its gradient summed over each group's
    heads; against autograd through ref.ssd_ref."""
    bsz, l, h, p, n = 2, 130, 4, 16, 8
    x = torch.from_numpy(rng.standard_normal((bsz, l, h, p)).astype(
        np.float32)).requires_grad_()
    a = torch.from_numpy((-0.1 * np.abs(rng.standard_normal((bsz, l, h))))
                         .astype(np.float32)).requires_grad_()
    bc = torch.from_numpy(rng.standard_normal((bsz, l, 2 * 2 * n)).astype(
        np.float32)).requires_grad_()
    if broadcast:
        bm = bc[..., :n].reshape(bsz, l, 1, n).expand(bsz, l, 2, n)
        cm = bc[..., n:2 * n].reshape(bsz, l, 1, n).expand(bsz, l, 2, n)
    else:
        bm = bc[..., :2 * n].reshape(bsz, l, 2, n)
        cm = bc[..., 2 * n:].reshape(bsz, l, 2, n)
    s0 = torch.from_numpy(rng.standard_normal((bsz, h, p, n)).astype(
        np.float32)).requires_grad_()
    dy = torch.from_numpy(rng.standard_normal((bsz, l, h, p)).astype(
        np.float32))
    leaves = (x, a, bc, s0)
    ops.reset_launch_counts()
    y, state = ops.ssd_chunked_kernel(x, a, bm, cm, s0)
    assert y.grad_fn is not None and "SSDFunction" in type(y.grad_fn).__name__
    got = torch.autograd.grad((y * dy).sum() + state.sum(), leaves)
    want_y, want_state = ref.ssd_ref(x.transpose(1, 2), a.transpose(1, 2),
                                     bm.transpose(1, 2), cm.transpose(1, 2),
                                     s0)
    want = torch.autograd.grad((want_y.transpose(1, 2) * dy).sum()
                               + want_state.sum(), leaves)
    for gt, w in zip(got, want):
        _close(gt, w, TOL["float32"])
    assert ops.launch_counts()["ssd_scan_backward"] == 0    # the CPU


def test_ssd_function_only_under_grad():
    x = torch.zeros(1, 70, 2, 8)
    a = torch.zeros(1, 70, 2)
    bm = torch.zeros(1, 70, 1, 4)
    with torch.no_grad():
        y, _ = ops.ssd_chunked_kernel(x.requires_grad_(), a, bm, bm)
    assert y.grad_fn is None
    y, _ = ops.ssd_chunked_kernel(x.detach(), a, bm, bm)
    assert y.grad_fn is None


def test_ssd_backward_marker_region_carries_its_costs(rng):
    arrs = _inputs(rng, 1, 2, 1, 70, 8, 4, init=False)
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    x = t["x"].transpose(1, 2).requires_grad_()
    regions = []

    class Session:
        def region(self, name, counters=None):
            regions.append((name, dict(counters or {})))
            return nullcontext()
    prev = ops.set_kernel_markers(Session())
    try:
        y, _ = ops.ssd_chunked_kernel(x, t["a"].transpose(1, 2),
                                      t["b"].transpose(1, 2),
                                      t["c"].transpose(1, 2))
        y.sum().backward()
    finally:
        ops.set_kernel_markers(prev)
    assert [r[0] for r in regions] == ["kernel:ssd_scan",
                                       "kernel:ssd_scan_backward"]
    assert regions[1][1] == ssd.bwd_cost_estimate((1, 2, 70, 8), 1, 4, 4)


def test_ssd_bwd_wrapper_checks_and_meta_path():
    x = torch.zeros(1, 4, 8, 16)
    a = torch.zeros(1, 4, 8)
    b = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError, match="dy"):
        ssd.ssd_scan_bwd(x, a, b, b, torch.zeros(1, 4, 9, 16))
    with pytest.raises(ValueError, match="dy"):
        ssd.ssd_scan_bwd(x, a, b, b, x.bfloat16())
    with pytest.raises(ValueError, match="dstate"):
        ssd.ssd_scan_bwd(x, a, b, b, x, None, torch.zeros(1, 4, 8, 16))
    with pytest.raises(ValueError, match="multiple of groups"):
        ssd.ssd_scan_bwd(x, a, torch.zeros(1, 3, 8, 8),
                         torch.zeros(1, 3, 8, 8), x)
    meta = {k: v.to("meta") for k, v in
            {"x": x, "a": a, "b": b, "s": torch.zeros(1, 4, 16, 8)}.items()}
    launched = (ssd.launches, ssd.bwd_launches)
    with FlopCounterMode(display=False) as counter:
        dx, da, db, dc, d_init = ssd.ssd_scan_bwd(
            meta["x"], meta["a"], meta["b"], meta["b"], meta["x"],
            meta["s"])
    assert [t.shape for t in (dx, da, db, dc, d_init)] == [
        x.shape, a.shape, b.shape, b.shape, (1, 4, 16, 8)]
    assert all(t.device.type == "meta" for t in (dx, da, db, dc, d_init))
    assert counter.get_total_flops() == ssd.bwd_cost_estimate(
        x.shape, 2, 8, 4, init_state=True)["flops"]
    assert ssd.ssd_scan_bwd(meta["x"], meta["a"], meta["b"], meta["b"],
                            meta["x"])[4] is None
    with FlopCounterMode(display=False) as counter:
        y, state = ssd.ssd_scan(meta["x"], meta["a"], meta["b"], meta["b"])
    assert y.shape == x.shape and state.shape == (1, 4, 16, 8)
    assert counter.get_total_flops() == ssd.cost_estimate(
        x.shape, 2, 8, 4)["flops"]
    assert (ssd.launches, ssd.bwd_launches) == launched
    with pytest.raises(ValueError, match="unsupported device"):
        ssd._check_kernel_args(x, b)


def test_ssd_bwd_cost_estimate():
    """zamba2's training shape (B=8, L=2048, H=112, P=N=64, one group) in
    bf16: the five causal within-chunk products over 65 x 64 / 2 pairs a
    chunk and the state products, 61,760 operations a step and head,
    1.13e11 in all (0.115 ms at bf16's 989 TFLOP/s, 1.69 ms at fp32's 67);
    ~0.73 GB moved (0.217 ms at 3.35 TB/s), so bound by bytes in bf16."""
    c = ssd.bwd_cost_estimate((8, 112, 2048, 64), 1, 64, 2)
    steps = 8 * 112 * 2048
    assert c["flops"] == 8 * 112 * (2.0 * (3 * 64 + 2 * 64) * 32 * 64 * 65
                                    // 2) + steps * 10.0 * 64 * 64 \
        == steps * 61760.0
    assert c["bytes"] == (steps * 3 * 64 * 2 + 8 * 2048 * 4 * 64 * 2
                          + steps * 4 * 2)
    assert abs(c["flops"] / 67e12 * 1e3 - 1.6915) < 1e-3
    assert c["bytes"] / 3.35e12 * 1e3 > c["flops"] / 989e12 * 1e3
    with_init = ssd.bwd_cost_estimate((8, 112, 2048, 64), 1, 64, 2,
                                      init_state=True)
    assert with_init["bytes"] - c["bytes"] == 2 * 8 * 112 * 64 * 64 * 4
    assert ssd.bwd_cost_estimate((1, 2, 10, 8), 2, 4, 4)["flops"] == \
        1 * 2 * (2.0 * (3 * 4 + 2 * 8) * 55 + 10.0 * 8 * 4 * 10)


@pytest.mark.parametrize("parts,total", [
    (56, 1879048192),     # bf16: two heads a block, 56 partials a row
    (112, 2818572288)])   # fp32: one partial a head
def test_ssd_bwd_scratch(parts, total):
    """The backward kernels' scratch at zamba2's training shape (B=8,
    L=2048, H=112, one group): 32 chunk-start states of 16 KB a head
    (0.47 GB) and the fp32 db/dc partials a (batch, step), each written
    and read once; a ragged L rounds the states up to whole chunks.  (The
    partial counts are the library's, ``ssd.bwd_partials``, checked on the
    card.)"""
    s = ssd.bwd_scratch((8, 112, 2048, 64), parts)
    assert s["states"] == 8 * 112 * 32 * 64 * 64 * 4
    assert s["bytes"] == total == 2 * (s["states"]
                                       + 2 * 8 * parts * 2048 * 64 * 4)
    odd = ssd.bwd_scratch((2, 21, 1000, 64), 12)
    assert odd["states"] == 2 * 21 * 16 * 16384
    assert odd["bytes"] == 2 * (odd["states"] + 2 * 2 * 12 * 1000 * 64 * 4)
