"""The arithmetic of the bf16 SSD backward tensor-core kernels, emulated on
the CPU.

``csrc/ssd_bwd.cu`` runs the bf16 gradient of the chunked SSD scan (chunks
of 64 steps) on the tensor cores in two passes.  ``ssd_bwd_states_kernel``
walks the chunks forward and keeps each chunk's start state S as a hi/lo
bf16 pair (hi = bf16(v), lo = bf16(v - hi)).  ``ssd_bwd_wgmma_kernel``
walks them in reverse, carrying the gradient G of each chunk's end state in
fp32.  Per chunk and head it runs three exact bf16 products (B C^T, X dY^T
and dY X^T) and six products with an fp32 operand (the decayed, masked
Gh^T, D^T and D; G twice; S; dY o exp(acs)), each as two products of that
operand's hi and lo parts, all summed in fp32.  The heads of a block (two)
add their db/dc in head order before one partial a block is stored; a
second pass adds the partials of a group in order.  A CUDA kernel cannot run
here, so :func:`emulate_wgmma_bwd` repeats that algorithm in plain PyTorch
(bf16 operands, fp32 products and sums, dx/db/dc rounded to bf16) and holds
it to ``ref.ssd_bwd_ref`` and to ``jax.vjp`` of the JAX
``models.ssm.ssd_chunked`` in fp32, under ``chip_smoke.compare``'s rule
|err| <= tol * (1 + |want|) at the bf16 tolerance 2e-2, the check the kernel
meets on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = 2e-2                       # bf16 (chip_smoke.TOL["ssd_scan_backward"])
CHUNK = 64
F = torch.nn.functional


def _split(t):
    """fp32 -> (hi, lo) bf16 with hi + lo ~ t to ~16 mantissa bits."""
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.float()).to(torch.bfloat16)


def _hi_only(t):
    """One rounding to bf16: the control the kernel's split improves on."""
    return t.to(torch.bfloat16), torch.zeros_like(t, dtype=torch.bfloat16)


def _mm(u, v):
    """bf16 operands, exact products, fp32 sums (as ``wgmma`` .f32)."""
    return u.float() @ v.float()


def _mm2(parts, v, *, left=True):
    """The two products of an operand's hi and lo parts, summed in fp32."""
    hi, lo = parts
    return _mm(hi, v) + _mm(lo, v) if left else _mm(v, hi) + _mm(v, lo)


def _t(m):
    return m.transpose(-1, -2)


def chunk_start_states(x, a, b, init, split):
    """``ssd_bwd_states_kernel``: the state at each chunk's start, kept as
    its hi/lo bf16 parts.  b is per head (B, H, L, N)."""
    bsz, h, l, p = x.shape
    s = torch.zeros((bsz, h, p, b.shape[-1])) if init is None else \
        init.float().clone()
    starts = []
    for l0 in range(0, l, CHUNK):
        nv = min(CHUNK, l - l0)
        starts.append(split(s))
        xc = F.pad(x[:, :, l0:l0 + nv], (0, 0, 0, CHUNK - nv))
        bc = F.pad(b[:, :, l0:l0 + nv], (0, 0, 0, CHUNK - nv))
        acs = torch.cumsum(F.pad(a[:, :, l0:l0 + nv], (0, CHUNK - nv)), -1)
        atot = acs[..., -1:]
        w = torch.exp((atot - acs).clamp(max=0.0))
        # S <- exp(A) S + (x o w)^T B
        s = s * torch.exp(atot.clamp(max=0.0))[..., None] + \
            _mm2(tuple(_t(t) for t in split(xc.float() * w[..., None])), bc)
    return starts


def emulate_wgmma_bwd(x, a, b, c, dy, init=None, dstate=None, split=_split,
                      heads_per_block=2):
    """The kernels' algorithm.  x/dy (B,H,L,P) bf16, a (B,H,L) fp32, b/c
    (B,G,L,N) bf16, init/dstate (B,H,P,N) fp32 or None -> (dx, da, db, dc,
    d_init) as ``ssd.ssd_scan_bwd`` returns them.  ``split`` turns an fp32
    operand into its two bf16 parts."""
    bsz, h, l, p = x.shape
    g, n = b.shape[1], b.shape[-1]
    hpg = h // g
    bh = b.repeat_interleave(hpg, dim=1)
    chh = c.repeat_interleave(hpg, dim=1)
    starts = chunk_start_states(x, a, bh, init, split)
    gr = torch.zeros((bsz, h, p, n)) if dstate is None else \
        dstate.float().clone()
    i_ge_j = torch.ones(CHUNK, CHUNK).tril().bool()      # [i][j], j <= i
    off_diag = torch.ones(CHUNK, CHUNK).tril(-1).bool()
    dx = torch.zeros((bsz, h, l, p))
    da = torch.zeros((bsz, h, l))
    db_h = torch.zeros((bsz, h, l, n))
    dc_h = torch.zeros((bsz, h, l, n))
    for k in reversed(range(len(starts))):
        l0 = k * CHUNK
        nv = min(CHUNK, l - l0)
        pad = (0, 0, 0, CHUNK - nv)                # rows past L read as 0
        xc = F.pad(x[:, :, l0:l0 + nv], pad)
        yc = F.pad(dy[:, :, l0:l0 + nv], pad)
        bc = F.pad(bh[:, :, l0:l0 + nv], pad)
        cc = F.pad(chh[:, :, l0:l0 + nv], pad)
        acs = torch.cumsum(F.pad(a[:, :, l0:l0 + nv], (0, CHUNK - nv)), -1)
        atot = acs[..., -1:]
        ein = torch.exp(acs.clamp(max=0.0))
        w = torch.exp((atot - acs).clamp(max=0.0))
        dec = torch.exp(atot.clamp(max=0.0))[..., None]
        seg = acs[..., :, None] - acs[..., None, :]        # [i][j]
        e = torch.where(i_ge_j, torch.exp(seg.clamp(max=0.0)), 0.0)
        # the within-chunk products: Gh^T and D^T (rows j) from B C^T and
        # X dY^T, D (rows i) from dY X^T; T = Gh o (dY X^T) for da
        ght = _mm(bc, _t(cc)) * _t(e)
        xdy = _mm(xc, _t(yc))
        dtr = xdy * _t(e)
        # every off-diagonal term counts, a rounded-up exponent's too
        tt = torch.where(_t(off_diag), ght * xdy, 0.0)
        row_t, col_t = tt.sum(-2), tt.sum(-1)      # by i, by j
        d = _mm(yc, _t(xc)) * e
        # dx = Gh^T dY + diag(w) B G^T
        g_parts = split(gr)
        dx_out = _mm2(tuple(_t(t) for t in g_parts), bc, left=False) * \
            w[..., None]
        udx = (xc.float() * dx_out).sum(-1)
        dxc = dx_out + _mm2(split(ght), yc)
        # db = D^T C + diag(w) X G
        db_out = _mm2(g_parts, xc, left=False) * w[..., None]
        dbc = db_out + _mm2(split(dtr), cc)
        # dc = D B + diag(exp(acs)) dY S
        s_hi, s_lo = starts[k]
        dc_out = _mm2((s_hi, s_lo), yc, left=False) * ein[..., None]
        cdc = (cc.float() * dc_out).sum(-1)
        dcc = dc_out + _mm2(split(d), bc)
        gs = (gr * (s_hi.float() + s_lo.float())).sum((-1, -2))
        # G <- exp(A) G + (dY o exp(acs))^T C
        gr = gr * dec + _mm2(tuple(_t(t) for t in split(
            yc.float() * ein[..., None])), cc)
        dacs = row_t - col_t + cdc - udx
        last = dec[..., 0, 0] * gs + udx.sum(-1)
        dacs[..., -1] += last
        dac = torch.flip(torch.cumsum(torch.flip(dacs, [-1]), -1), [-1])
        dx[:, :, l0:l0 + nv] = dxc[:, :, :nv]
        da[:, :, l0:l0 + nv] = dac[:, :, :nv]
        db_h[:, :, l0:l0 + nv] = dbc[:, :, :nv]
        dc_h[:, :, l0:l0 + nv] = dcc[:, :, :nv]

    def group_sums(t):
        """A block's heads in head order, then the blocks of a group in
        order (both fp32)."""
        out = torch.zeros((bsz, g, l, n))
        for gi in range(g):
            for h0 in range(gi * hpg, (gi + 1) * hpg, heads_per_block):
                part = t[:, h0]
                for hh in range(h0 + 1, min(h0 + heads_per_block,
                                            (gi + 1) * hpg)):
                    part = part + t[:, hh]
                out[:, gi] += part
        return out.to(torch.bfloat16)
    return (dx.to(torch.bfloat16), da, group_sums(db_h), group_sums(dc_h),
            gr if init is not None else None)


def _check(got, want, tol=TOL):
    """``chip_smoke.compare``'s rule: |got - want| <= tol * (1 + |want|)."""
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    margin = float(((g - w).abs() - tol * (1.0 + w.abs())).max())
    assert margin <= 0, margin


def _inputs(rng, b, l, h, g, init, decay):
    """``chip_smoke.ssd_bwd_inputs``' distributions, bf16 where it feeds
    bf16."""
    p = n = 64

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = arr(b, h, l, p).bfloat16()
    a = -decay * arr(b, h, l).abs()
    bm, cm = arr(b, g, l, n).bfloat16(), arr(b, g, l, n).bfloat16()
    dy = arr(b, h, l, p).bfloat16()
    s0 = arr(b, h, p, n) if init else None
    ds = arr(b, h, p, n) if init else None
    return x, a, bm, cm, dy, s0, ds


def _jax_grads(x, a, bm, cm, dy, s0, ds):
    """jax.vjp of the reference's ssd_chunked in fp32 (model layout, groups
    broadcast to heads, chunk 64) on the same bf16-valued inputs, back in
    the kernel's layout, db/dc summed over each group's heads."""
    h, g = x.shape[1], bm.shape[1]

    def f(xx, aa, bb, cc, *init):
        def heads(m):                         # (B,G,L,N) -> (B,L,H,N)
            return jnp.repeat(jnp.moveaxis(m, 1, 2), h // g, axis=2)
        y, state = jssm.ssd_chunked(
            jnp.moveaxis(xx, 1, 2), jnp.moveaxis(aa, 1, 2), heads(bb),
            heads(cc), chunk=CHUNK, init_state=init[0] if init else None)
        return jnp.moveaxis(y, 1, 2), state

    args = [jnp.asarray(t.float().numpy()) for t in (x, a, bm, cm)]
    if s0 is not None:
        args.append(jnp.asarray(s0.numpy()))
    (_, state), vjp = jax.vjp(f, *args)
    dstate = jnp.zeros_like(state) if ds is None else jnp.asarray(ds.numpy())
    got = vjp((jnp.asarray(dy.float().numpy()), dstate))
    return [torch.from_numpy(np.array(t)) for t in got] + \
        ([] if s0 is not None else [None])


CASES = [(2, 201, 6, 2, True, 0.1),      # ragged, 4 chunks, 2 groups of 3
         (1, 300, 8, 1, False, 0.1),     # 5 chunks, one group of 8 heads
         (2, 150, 4, 4, True, 0.1),      # one head a group (nothing summed)
         (1, 130, 7, 1, True, 20.0)]     # strong decay, 7 heads (a lone one)


@pytest.mark.parametrize("b,l,h,g,init,decay", CASES)
def test_split_bf16_backward_matches_ssd_bwd_ref_and_jax_vjp(rng, b, l, h, g,
                                                             init, decay):
    args = _inputs(rng, b, l, h, g, init, decay)
    got = emulate_wgmma_bwd(*args)
    want = ref.ssd_bwd_ref(*args)
    jgot = _jax_grads(*args)
    for name, gt, w, j in zip(("dx", "da", "db", "dc", "d_init"), got, want,
                              jgot):
        assert (gt is None) == (w is None) == (j is None), name
        if w is None:
            continue
        assert gt.shape == w.shape and gt.dtype == w.dtype, name
        _check(gt, w)
        _check(gt, j)


def test_one_bf16_rounding_of_the_fp32_operands_is_not_enough(rng):
    """Why the kernel splits: rounding the fp32 operands (the chunk-start
    states, G, the decayed Gh^T, D^T, D and dY o exp(acs)) once to bf16
    fails the same check over zamba2's 32 chunks."""
    args = _inputs(rng, 1, 2048, 2, 1, False, 0.1)
    got = emulate_wgmma_bwd(*args, split=_hi_only)
    want = ref.ssd_bwd_ref(*args)
    with pytest.raises(AssertionError):
        for gt, w in zip(got, want):
            if w is not None:
                _check(gt, w)


def _check_sum_of_rounded(got, want, terms, tol=TOL):
    """``tests/test_torch_cuda.py``'s rule for a sum over dim 1 of terms
    each rounded to bf16 first: :func:`_check`'s limit plus one bf16 unit
    of each term (the larger of the two sides' magnitudes)."""
    mag = torch.maximum(*(t.float().abs() for t in terms))
    unit = torch.finfo(torch.bfloat16).eps * \
        torch.exp2(torch.frexp(mag).exponent - 1.0)
    g, w = got.float(), want.float()
    limit = tol * (1.0 + w.abs()) + torch.where(mag > 0, unit, 0.0).sum(1)
    assert float(((g - w).abs() - limit).max()) <= 0


def test_bf16_sums_of_per_group_gradients_hold_to_a_unit_of_each_term(rng):
    """What ``tests/test_torch_cuda.py::test_ssd_function_on_card_matches_cpu``
    checks in bf16: b/c are one group expanded over 4 groups of one head, so
    autograd adds the 4 per-group db (dc) after each was rounded to bf16.
    On that test's inputs (drawn alike) every per-group gradient of the
    algorithm is within the limit of the plain version's, and the bf16 sums
    within that limit plus one bf16 unit of each term: where the terms
    cancel, a term rounded the other way is a unit of the term, more than
    2e-2 (1 + |sum|)."""
    b, l, h, n = 2, 150, 4, 64
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((b, l, h, 64), (b, l, h), (b, l, 1, n), (b, l, 1, n),
             (b, l, h, 64))]
    arrs[1] = -0.1 * np.abs(arrs[1])
    x, dy = (torch.from_numpy(arrs[i]).bfloat16().transpose(1, 2)
             for i in (0, 4))
    a = torch.from_numpy(arrs[1]).transpose(1, 2)
    bm, cm = (torch.from_numpy(arrs[i]).bfloat16().expand(b, l, h, n)
              .transpose(1, 2) for i in (2, 3))
    got = emulate_wgmma_bwd(x, a, bm, cm, dy)
    want = ref.ssd_bwd_ref(x, a, bm, cm, dy)
    for k in (2, 3):
        _check(got[k], want[k])                     # each group's gradient
        gs, ws = (t.float().sum(1).bfloat16() for t in
                  (got[k], want[k]))                # autograd's bf16 sum
        _check_sum_of_rounded(gs, ws, (got[k], want[k]))
