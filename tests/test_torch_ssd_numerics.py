"""The arithmetic of the bf16 SSD tensor-core kernel, emulated on the CPU.

``csrc/ssd.cu``'s ``ssd_wgmma_kernel`` runs the chunked SSD scan (chunks
of 64 steps) on the bf16 tensor cores.  Three of its four products have an
fp32 operand: the masked, decayed C B^T; the carried state S; and
x o exp(a_total - acs).  The kernel splits each into a high and a low bf16
part (hi = bf16(v), lo = bf16(v - hi)) and runs two products, accumulated
in fp32; C B^T itself comes from the bf16 inputs in one product.  A CUDA
kernel cannot run here, so :func:`emulate_wgmma_scan` repeats that
algorithm in plain PyTorch (bf16 operands, fp32 products and sums, y
rounded to bf16) and holds it to the sequential recurrence
(``ref.ssd_ref``) and to the JAX ``models.ssm.ssd_chunked`` in fp32, under
``chip_smoke.compare``'s rule |err| <= tol * (1 + |want|) at the bf16
tolerance 2e-2, the same check the kernel meets on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ref, ssd  # noqa: E402

TOL = 2e-2                       # bf16 (chip_smoke.TOL["ssd_scan"])
CHUNK = 64


def _split(t):
    """fp32 -> (hi, lo) bf16 with hi + lo ~ t to ~16 mantissa bits."""
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.float()).to(torch.bfloat16)


def _mm(u, v):
    """bf16 operands, exact products, fp32 sums (as ``wgmma`` .f32)."""
    return u.float() @ v.float()


def emulate_wgmma_scan(x, a, b, c, init=None, split=_split):
    """The kernel's algorithm.  x (B,H,L,P) bf16, a (B,H,L) fp32, b/c
    (B,G,L,N) bf16, init (B,H,P,N) fp32 or None -> (y bf16, state fp32).
    ``split`` turns an fp32 operand into its two bf16 parts."""
    bsz, h, l, p = x.shape
    n = b.shape[-1]
    bh = b.repeat_interleave(h // b.shape[1], dim=1)
    ch = c.repeat_interleave(h // c.shape[1], dim=1)
    s = torch.zeros((bsz, h, p, n)) if init is None else init.float().clone()
    tril = torch.ones(CHUNK, CHUNK).tril().bool()
    ys = []
    for l0 in range(0, l, CHUNK):
        nv = min(CHUNK, l - l0)
        pad = (0, 0, 0, CHUNK - nv)            # rows past L read as zeros
        xc = torch.nn.functional.pad(x[:, :, l0:l0 + nv], pad)
        bc = torch.nn.functional.pad(bh[:, :, l0:l0 + nv], pad)
        cc = torch.nn.functional.pad(ch[:, :, l0:l0 + nv], pad)
        ac = torch.nn.functional.pad(a[:, :, l0:l0 + nv], (0, CHUNK - nv))
        acs = torch.cumsum(ac, dim=-1)
        atot = acs[..., -1:]
        # every exponent clamped at 0, as the kernel does after its scan
        seg = (acs[..., :, None] - acs[..., None, :]).clamp(max=0.0)
        g = _mm(cc, bc.transpose(-1, -2))
        gh = torch.where(tril, g * torch.exp(seg), torch.zeros(()))
        s_hi, s_lo = split(s)
        y = _mm(cc, s_hi.transpose(-1, -2)) + _mm(cc, s_lo.transpose(-1, -2))
        y = y * torch.exp(acs.clamp(max=0.0))[..., None]
        g_hi, g_lo = split(gh)
        y = y + _mm(g_hi, xc) + _mm(g_lo, xc)
        w = torch.exp((atot - acs).clamp(max=0.0))
        xw_hi, xw_lo = split(xc.float() * w[..., None])
        s = s * torch.exp(atot.clamp(max=0.0))[..., None] + \
            _mm(xw_hi.transpose(-1, -2), bc) + _mm(xw_lo.transpose(-1, -2), bc)
        ys.append(y[:, :, :nv])
    return torch.cat(ys, dim=2).to(torch.bfloat16), s


def _check(got, want, tol=TOL):
    """``chip_smoke.compare``'s rule: |got - want| <= tol * (1 + |want|)."""
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    margin = float(((g - w).abs() - tol * (1.0 + w.abs())).max())
    assert margin <= 0, margin


def _inputs(rng, b, l, h, g, init, decay):
    """``chip_smoke.check_ssd``'s distributions, bf16 where it feeds bf16."""
    p = n = 64
    x = torch.from_numpy(rng.standard_normal((b, h, l, p)).astype(
        np.float32)).bfloat16()
    a = torch.from_numpy(
        (-decay * np.abs(rng.standard_normal((b, h, l)))).astype(np.float32))
    bm, cm = (torch.from_numpy(rng.standard_normal((b, g, l, n)).astype(
        np.float32)).bfloat16() for _ in range(2))
    s0 = torch.from_numpy(rng.standard_normal((b, h, p, n)).astype(
        np.float32)) if init else None
    return x, a, bm, cm, s0


@pytest.mark.parametrize("b,l,h,g,init,decay", [
    (2, 910, 8, 1, True, 0.1),      # the served length, one group, a state
    (2, 201, 6, 2, False, 0.1),     # ragged L, 2 groups of 3, no state
    (1, 130, 4, 1, True, 20.0)])    # strong decay
def test_split_bf16_scan_matches_recurrence_and_ssd_chunked(rng, b, l, h, g,
                                                            init, decay):
    x, a, bm, cm, s0 = _inputs(rng, b, l, h, g, init, decay)
    y, state = emulate_wgmma_scan(x, a, bm, cm, s0)
    want_y, want_state = ref.ssd_ref(x, a, bm, cm, s0)
    _check(y, want_y)
    _check(state, want_state)
    # the JAX chunked scan in fp32 on the same (bf16-valued) inputs
    rep = h // g
    jy, jstate = jssm.ssd_chunked(
        jnp.asarray(x.float().numpy().transpose(0, 2, 1, 3)),
        jnp.asarray(a.numpy().transpose(0, 2, 1)),
        *(jnp.asarray(np.repeat(m.float().numpy(), rep, axis=1)
                      .transpose(0, 2, 1, 3)) for m in (bm, cm)),
        chunk=CHUNK,
        init_state=None if s0 is None else jnp.asarray(s0.numpy()))
    _check(y, torch.from_numpy(np.array(jy)).transpose(1, 2))
    _check(state, torch.from_numpy(np.array(jstate)))


def test_one_bf16_rounding_of_the_fp32_operands_is_not_enough(rng):
    """Why the kernel splits: rounding the three fp32 operands once to bf16
    fails the same check at the served length."""
    x, a, bm, cm, s0 = _inputs(rng, 2, 910, 8, 1, True, 0.1)

    def hi_only(t):
        return t.to(torch.bfloat16), torch.zeros_like(t, dtype=torch.bfloat16)
    y, _ = emulate_wgmma_scan(x, a, bm, cm, s0, split=hi_only)
    want_y, _ = ref.ssd_ref(x, a, bm, cm, s0)
    with pytest.raises(AssertionError):
        _check(y, want_y)


@pytest.mark.parametrize("expand", [True, False])
def test_canonical_groups_collapses_a_zero_group_stride(rng, expand):
    """b/c broadcast over heads as an expanded view (group stride 0) become
    one group, which the kernel's tensor maps can address; a real grouped
    layout is passed through as it is."""
    b, h, l, n = 2, 4, 70, 64
    one = torch.from_numpy(rng.standard_normal((b, 1, l, n)).astype(
        np.float32))
    bm = one.expand(b, h, l, n) if expand else one.repeat(1, h, 1, 1)
    cm = (2 * one).expand(b, h, l, n) if expand else \
        (2 * one).repeat(1, h, 1, 1)
    bc, cc = ssd.canonical_groups(bm, cm)
    if expand:
        assert bc.shape == cc.shape == (b, 1, l, n)
        torch.testing.assert_close(bc, one)
        torch.testing.assert_close(cc, 2 * one)
    else:
        assert bc is bm and cc is cm
    # the plain version gives the same answer either way
    x = torch.from_numpy(rng.standard_normal((b, h, l, 64)).astype(
        np.float32))
    a = -0.1 * torch.rand((b, h, l))
    y1, s1 = ref.ssd_ref(x, a, bm, cm)
    y2, s2 = ref.ssd_ref(x, a, bc, cc)
    torch.testing.assert_close(y1, y2)
    torch.testing.assert_close(s1, s2)


def test_canonical_groups_copies_a_lone_zero_group_stride(rng):
    """Only one of b/c broadcast: that one is made dense, so both keep the
    same G groups."""
    one = torch.from_numpy(rng.standard_normal((1, 1, 9, 64)).astype(
        np.float32))
    dense = torch.from_numpy(rng.standard_normal((1, 3, 9, 64)).astype(
        np.float32))
    bc, cc = ssd.canonical_groups(one.expand(1, 3, 9, 64), dense)
    assert bc.shape == cc.shape == (1, 3, 9, 64) and bc.stride(1) != 0
    assert cc is dense
    torch.testing.assert_close(bc, one.expand(1, 3, 9, 64))


def test_kernel_strides_fill_in_size_one_dims():
    """A size-one dim's stride is free in PyTorch (0 here, as a slice of an
    expanded view leaves it); the kernel is given the span of the other
    dims there, and every other stride as it is."""
    b = torch.zeros(2, 1, 70, 128)[..., 64:].expand(2, 1, 70, 64)
    b = b.as_strided(b.shape, (b.stride(0), 0, b.stride(2), 1))
    assert ssd.kernel_strides(b) == [70 * 128, 70 * 128 * 2, 128]
    x = torch.zeros(3, 70, 4, 64).transpose(1, 2)
    assert ssd.kernel_strides(x) == list(x.stride()[:3])
