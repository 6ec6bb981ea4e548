"""PyTorch port kernels vs the JAX package: the plain versions, on the CPU.

The same numpy inputs go through the JAX function (the Pallas kernel in
interpret mode, or its jnp oracle) and the port's counterpart.  On a CPU
tensor the port's wrappers compute their plain version; the kernels
themselves are held against that plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.  Tolerances are the
reference's own (tests/test_kernels.py): fp32 attention 2e-5, fp32 rmsnorm
1e-5, bf16 2e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jrmsnorm  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.layers import apply_norm as japply_norm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

TOL = {"attn": {"float32": 2e-5, "bfloat16": 2e-2},
       "rms": {"float32": 1e-5, "bfloat16": 2e-2}}


def _pair(arr, dtype):
    """The same numpy array as a JAX array and a CPU torch tensor."""
    return (jnp.asarray(arr, getattr(jnp, dtype)),
            torch.from_numpy(np.array(arr)).to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# -- flash attention: plain version vs the Pallas kernel and its oracle -------

FLASH_SWEEP = [
    # b, h, kv, s, d, causal, window, dtype   (GQA group = h // kv)
    (1, 4, 4, 64, 16, True, 0, "float32"),       # group 1
    (2, 4, 2, 64, 16, True, 0, "float32"),       # group 2
    (1, 8, 2, 64, 64, True, 0, "float32"),       # group 4
    (1, 4, 2, 64, 16, False, 0, "float32"),      # non-causal
    (1, 4, 2, 64, 16, True, 24, "float32"),      # sliding window
    (1, 4, 4, 64, 64, True, 0, "bfloat16"),
    (1, 8, 2, 64, 16, True, 16, "bfloat16"),
    (1, 8, 1, 64, 192, True, 0, "float32"),      # nemotron's head dim
    (1, 8, 1, 64, 192, True, 24, "bfloat16"),
]


@pytest.mark.parametrize("b,h,kv,s,d,causal,window,dtype", FLASH_SWEEP)
def test_flash_plain_matches_pallas_and_oracle(rng, b, h, kv, s, d, causal,
                                               window, dtype):
    qn = rng.standard_normal((b, h, s, d)).astype(np.float32)
    kn = rng.standard_normal((b, kv, s, d)).astype(np.float32)
    vn = rng.standard_normal((b, kv, s, d)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (qn, kn, vn))
    got = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jops._fa.flash_attention(jq, jk, jv, causal=causal,
                                      window=window, bq=32, bk=32,
                                      interpret=True)
    oracle = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    tol = TOL["attn"][dtype]
    _close(got, pallas, tol)
    _close(got, oracle, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 16])
def test_flash_bshd_adapter_matches_jax(rng, window, dtype):
    qn = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    kn = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    vn = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (qn, kn, vn))
    got = ops.flash_attention_bshd(tq, tk, tv, causal=True, window=window)
    want = jops.flash_attention_bshd(jq, jk, jv, causal=True, window=window,
                                     bq=32, bk=32, interpret=True)
    _close(got, want, TOL["attn"][dtype])


@pytest.mark.parametrize("s,dtype", [(37, "float32"), (50, "float32"),
                                     (37, "bfloat16"), (48, "bfloat16")])
def test_flash_ragged_seq_matches_chunked_attention(rng, s, dtype):
    """Any S works (the serving engine pads prompts to arbitrary lengths);
    held against the JAX prefill path, whose gcd fallback takes any S.  In
    bf16 that path rounds the probabilities before the PV product and the
    port keeps them in fp32, a difference inside the bf16 tolerance."""
    qn = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    kn = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    vn = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (qn, kn, vn))
    want = jattn.chunked_attention(jq, jk, jv, causal=True, chunk_k=16)
    _close(ops.flash_attention_bshd(tq, tk, tv, causal=True), want,
           TOL["attn"][dtype])


def test_full_attention_decode_masking_matches_jax(rng):
    """One query over every cache slot, kv_valid = pos + 1 (decode)."""
    qn = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kn = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    vn = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "float32") for a in (qn, kn, vn))
    for pos in (0, 9, 23):
        want = jattn.full_attention(jq, jk, jv, causal=False,
                                    kv_valid=pos + 1, q_offset=pos)
        got = tattn.full_attention(tq, tk, tv, causal=False,
                                   kv_valid=pos + 1, q_offset=pos)
        _close(got, want, 2e-5)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="softcap"):
        fa.flash_attention(q, k, k, softcap=30.0)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, torch.zeros(1, 3, 8, 16),
                           torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention(q, torch.zeros(1, 2, 9, 16),
                           torch.zeros(1, 2, 9, 16))
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, k.bfloat16(), k.bfloat16())


@pytest.mark.parametrize("d", [64, 112, 128, 192])
def test_flash_kernel_instances_take_the_served_head_dims(d):
    """The library has an instance for every served head dim (192 is
    nemotron's); 96 and 16 (the smoke configs) have none."""
    for dtype in (torch.float32, torch.bfloat16):
        fa._check_instance(torch.zeros(1, 1, 1, d, dtype=dtype))
    for bad in (96, 16):
        with pytest.raises(ValueError, match="head dim"):
            fa._check_instance(torch.zeros(1, 1, 1, bad))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa._check_instance(torch.zeros(1, 1, 1, d, dtype=torch.float16))


@pytest.mark.parametrize("s,causal,window", [
    (1, True, 0), (37, True, 0), (64, False, 0), (50, True, 7),
    (50, False, 7), (8, True, 100)])
def test_flash_cost_counts_attended_pairs(s, causal, window):
    qp = np.arange(s)[:, None]
    kp = np.arange(s)[None, :]
    ok = np.ones((s, s), bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    pairs = int(ok.sum())
    assert fa.attended_pairs(s, causal=causal, window=window) == pairs
    c = fa.cost_estimate((2, 4, s, 16), 2, 2, causal=causal, window=window)
    assert c["flops"] == 4.0 * 2 * 4 * 16 * pairs
    assert c["bytes"] == 2 * s * 16 * (2 * 4 + 2 * 2) * 2


# -- rmsnorm: plain version vs the Pallas kernel and apply_norm --------------


@pytest.mark.parametrize("shape,dtype", [
    ((2, 8, 64), "float32"), ((5, 32), "float32"), ((3, 7, 128), "float32"),
    ((2, 8, 64), "bfloat16"), ((5, 32), "bfloat16")])
def test_rmsnorm_plain_matches_pallas_and_apply_norm(rng, shape, dtype):
    from repro.configs import get_config
    xn = rng.standard_normal(shape).astype(np.float32)
    sn = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    jx, tx = _pair(xn, dtype)
    js, ts = _pair(sn, "float32")
    got = rms.rmsnorm(tx, ts, eps=1e-5)
    assert got.dtype == tx.dtype
    tol = TOL["rms"][dtype]
    _close(got, jrmsnorm(jx, js, eps=1e-5, interpret=True), tol)
    _close(got, jref.rmsnorm_ref(jx, js, eps=1e-5), tol)
    cfg = get_config("lms-demo", smoke=True)
    _close(got, japply_norm({"scale": js}, jx, cfg), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_on_strided_rows_matches_pallas_and_apply_norm(rng,
                                                                     dtype):
    """MLA's latent, the first columns of wider rows, read as rows of their
    stride: on a CPU tensor the wrapper computes the plain version on the
    view as it is (no copy), and agrees with the Pallas kernel and
    apply_norm on the same values."""
    from repro.configs import get_config
    wide = rng.standard_normal((2, 5, 40)).astype(np.float32)
    sn = (1.0 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    jx, tx = _pair(wide[..., :32], dtype)
    tx = _pair(wide, dtype)[1][..., :32]
    assert not tx.is_contiguous() and rms.rows(tx) == (10, 40)
    js, ts = _pair(sn, "float32")
    got = rms.rmsnorm(tx, ts, eps=1e-6)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = TOL["rms"][dtype]
    _close(got, jrmsnorm(jx, js, eps=1e-6, interpret=True), tol)
    cfg = get_config("lms-demo", smoke=True)
    _close(got, japply_norm({"scale": js}, jx, cfg, eps=1e-6), tol)


def test_rmsnorm_rows_takes_one_row_stride_and_refuses_the_rest():
    """``rms.rows``: (rows, row stride) where the kernels can read x, None
    (the wrappers' ValueError on the card) where they cannot."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert rms.rows(torch.zeros(2, 3, 16)) == (6, 16)
    assert rms.rows(torch.zeros(0, 16)) == (0, 16)
    assert rms.rows(torch.zeros(2, 5, 576, dtype=bf16)[..., :512]) == \
        (10, 576)
    # size-1 dims take any stride; a slice of rows keeps one stride
    assert rms.rows(torch.zeros(1, 7, 24)[:, :, :16]) == (7, 24)
    assert rms.rows(torch.zeros(3, 1, 24)[..., :8]) == (3, 24)
    assert rms.rows(torch.zeros(6, 4, 24)[::2, :, :8]) is None
    assert rms.rows(torch.zeros(10, 24)[::2, :8]) == (5, 48)
    # a stride that is not a multiple of 16 bytes
    assert rms.rows(torch.zeros(4, 18)[:, :16]) is None
    assert rms.rows(torch.zeros(4, 20, dtype=bf16)[:, :16]) is None
    # d not a multiple of a vector; rows off a 16-byte boundary
    assert rms.rows(torch.zeros(4, 6)) is None
    assert rms.rows(torch.zeros(65)[1:].view(4, 16)) is None
    # a last dim that is not contiguous; leading dims that do not flatten;
    # a stride under d (expanded rows)
    assert rms.rows(torch.zeros(16, 4).t()) is None
    assert rms.rows(torch.zeros(4, 3, 16).transpose(0, 1)) is None
    assert rms.rows(torch.zeros(1, 16).expand(4, 16)) is None
    assert rms.rows(torch.zeros(4, 16, dtype=f32)) == (4, 16)


@pytest.mark.parametrize("n,d,itemsize,backward", [
    (8, 4096, 2, False), (1, 512, 2, False), (64, 3584, 2, False),
    (7280, 512, 2, False), (2048, 1024, 4, False), (7280, 7168, 2, False),
    (7280, 3584, 2, False), (7280, 1032, 2, False), (16384, 4096, 2, True),
    (4096, 512, 2, True), (4097, 1032, 2, True), (300, 16384, 4, True),
    (7, 24, 4, True), (65, 2056, 2, False)])
def test_rmsnorm_plan_covers_the_row(n, d, itemsize, backward):
    """Every plan is one the kernels take: a slot of whole warps, at most
    MAX_THREADS a block, VPT one of the instances, its vectors covering the
    row with less than a VPT's worth of threads idle at the tail."""
    vpt, tpr, slots = rms.plan(n, d, itemsize, backward=backward)
    nv = d * itemsize // 16
    assert vpt in rms.VPTS and tpr % 32 == 0
    assert tpr * slots <= rms.MAX_THREADS and slots >= 1
    assert tpr * vpt >= nv > (tpr - 32) * vpt
    if not backward and n <= rms.DECODE_ROWS:
        assert vpt <= 2 or tpr == rms.MAX_THREADS and slots == 1
    elif nv <= rms.NARROW_VECTORS:
        assert tpr == 32 and 32 * vpt < 2 * nv + 32


def test_rmsnorm_plan_shapes_and_limits():
    # decode: one or two loads a thread; a narrow row: a warp, 8 a block;
    # wide rows two vectors a thread (the forward where that leaves the
    # least idle tail), in blocks of about 512 (forward) or 256 (backward)
    # threads
    assert rms.plan(8, 4096, 2) == (2, 256, 1)
    assert rms.plan(4, 512, 2) == (2, 32, 1)
    assert rms.plan(7280, 512, 2) == (2, 32, 8)
    assert rms.plan(4096, 512, 2, backward=True) == (2, 32, 8)
    assert rms.plan(7280, 4096, 2) == (2, 256, 2)
    assert rms.plan(7280, 7168, 2) == (2, 448, 1)
    assert rms.plan(7280, 3584, 2) == (2, 224, 2)
    assert rms.plan(16384, 4096, 2, backward=True) == (2, 256, 1)
    assert rms.plan(300, 16384, 4, backward=True) == (8, 512, 1)
    assert rms.plan(4097, 1032, 2, backward=True) == (2, 96, 2)
    assert rms.plan(4097, 1032, 2) == (1, 160, 3)
    with pytest.raises(ValueError, match="wider than the kernels take"):
        rms.plan(8, 65536, 2)
    # the backward always walks (a scratch row a block); the forward walks
    # rows of up to 4 KB in bf16, and gives wider ones a slot each
    assert rms.walks(4096, 2, backward=True)
    assert rms.walks(2048, 2) and rms.walks(512, 2) and rms.walks(1024, 4)
    assert not rms.walks(3584, 2) and not rms.walks(2048, 4)
    # the grid: a block for each slots' worth of rows, at most the card's
    assert rms.grid_blocks(7280, 8, 132 * 8) == 910
    assert rms.grid_blocks(16384, 4, 132) == 132
    assert rms.grid_blocks(1, 16, 264) == 1


def test_rmsnorm_wrapper_checks_scale():
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError, match="float32"):
        rms.rmsnorm(x, torch.ones(16, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="does not match"):
        rms.rmsnorm(x, torch.ones(8))


def test_rmsnorm_cost_estimate():
    c = rms.cost_estimate((8, 1024, 4096), 2)
    numel = 8 * 1024 * 4096
    assert c == {"flops": 4.0 * numel, "bytes": float(2 * numel * 2 + 4 * 4096)}


# -- launch counters and markers ----------------------------------------------


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


def test_cpu_calls_launch_nothing_and_markers_carry_costs():
    ops.reset_launch_counts()
    session = _Session()
    prev = ops.set_kernel_markers(session)
    try:
        q = torch.randn(1, 16, 4, 16)
        k = torch.randn(1, 16, 2, 16)
        ops.flash_attention_bshd(q, k, k)
        ops.fused_rmsnorm(torch.randn(3, 16), torch.ones(16))
    finally:
        assert ops.set_kernel_markers(prev) is session
    assert ops.launch_counts() == {"flash_attention": 0, "rmsnorm": 0,
                                   "rmsnorm_backward": 0,
                                   "rmsnorm_split": 0,
                                   "rmsnorm_split_backward": 0,
                                   "ssd_scan": 0, "ssd_scan_backward": 0}
    names = [n for n, _ in session.regions]
    assert names == ["kernel:flash_attention", "kernel:rmsnorm"]
    assert session.regions[0][1] == fa.cost_estimate(
        (1, 4, 16, 16), 2, 4, causal=True)
    assert session.regions[1][1] == rms.cost_estimate((3, 16), 4)


# -- chip_smoke.py's ptxas report ------------------------------------------------

_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_c45a2b1818flash_wgmma_kernelILi{d}EEEv14CUtensorMap_stS1_S1_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_c45a2b1818flash_wgmma_kernelILi{d}EEEv14CUtensorMap_stS1_S1_NS_6ParamsE
    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""
_PTXAS_OTHERS = """\
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__74c2a8ec_10_rmsnorm_cu_a1f8713914rmsnorm_kernelIfEEvPKT_PKfPS1_xif' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__74c2a8ec_10_rmsnorm_cu_a1f8713914rmsnorm_kernelIfEEvPKT_PKfPS1_xif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 27 registers, used 1 barriers, 128 bytes smem
ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__025e8cd1_6_ssd_cu_f5ebf9df14ssd_f32_kernelENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN38_GLOBAL__N__025e8cd1_6_ssd_cu_f5ebf9df14ssd_f32_kernelENS_6ParamsE
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 121 registers, used 1 barriers
"""
_PTXAS_SSD = """\
ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__025e8cd1_6_ssd_cu_f5ebf9df16ssd_wgmma_kernelE14CUtensorMap_stS0_S0_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN38_GLOBAL__N__025e8cd1_6_ssd_cu_f5ebf9df16ssd_wgmma_kernelE14CUtensorMap_stS0_S0_NS_6ParamsE
    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads
ptxas info    : Used 128 registers, used 16 barriers
"""
_PTXAS_SSD_BWD = """\
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__8e1e1fc1_10_ssd_bwd_cu_67a758f221ssd_bwd_states_kernelE14CUtensorMap_stS0_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__8e1e1fc1_10_ssd_bwd_cu_67a758f221ssd_bwd_states_kernelE14CUtensorMap_stS0_NS_6ParamsE
    0 bytes stack frame, {states} bytes spill stores, {states} bytes spill loads
ptxas info    : Used 116 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__8e1e1fc1_10_ssd_bwd_cu_67a758f220ssd_bwd_wgmma_kernelE14CUtensorMap_stS0_S0_S0_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__8e1e1fc1_10_ssd_bwd_cu_67a758f220ssd_bwd_wgmma_kernelE14CUtensorMap_stS0_S0_S0_NS_6ParamsE
    16 bytes stack frame, {reverse} bytes spill stores, {reverse} bytes spill loads
ptxas info    : Used 255 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__8e1e1fc1_10_ssd_bwd_cu_67a758f214ssd_bwd_kernelENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__8e1e1fc1_10_ssd_bwd_cu_67a758f214ssd_bwd_kernelENS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 149 registers, used 1 barriers
"""


def _chip_smoke(monkeypatch, tmp_path, text):
    """``chip_smoke`` with its build directory pointed at a report."""
    import importlib.util
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs.kbuild, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(cs.kbuild, "source_hash", lambda: "h")
    (tmp_path / "h").mkdir()
    (tmp_path / "h" / cs.kbuild.PTXAS_LOG).write_text(text)
    return cs


def test_ptxas_report_names_every_instance(monkeypatch, tmp_path):
    text = "".join(_PTXAS.format(d=d, spill=0) for d in (128, 112, 64, 192))
    cs = _chip_smoke(monkeypatch, tmp_path,
                     text + _PTXAS_OTHERS + _PTXAS_SSD.format(spill=0) +
                     _PTXAS_SSD_BWD.format(states=0, reverse=0))
    rows = cs.ptxas_report()
    assert [r["kernel"] for r in rows] == [
        "flash_wgmma_kernel<128>", "flash_wgmma_kernel<112>",
        "flash_wgmma_kernel<64>", "flash_wgmma_kernel<192>",
        "rmsnorm_kernel<f32>", "ssd_f32_kernel", "ssd_wgmma_kernel",
        "ssd_bwd_states_kernel", "ssd_bwd_wgmma_kernel", "ssd_bwd_kernel"]
    assert rows[0] == {"kernel": "flash_wgmma_kernel<128>", "registers": 168,
                       "spill_stores": 0, "spill_loads": 0}
    # a CUDA-core instance that spills is reported, not failed
    assert rows[5]["spill_stores"] == 4 and rows[5]["registers"] == 121
    assert rows[6] == {"kernel": "ssd_wgmma_kernel", "registers": 128,
                       "spill_stores": 0, "spill_loads": 0}
    assert rows[8] == {"kernel": "ssd_bwd_wgmma_kernel", "registers": 255,
                       "spill_stores": 0, "spill_loads": 0}


_PTXAS_RMSNORM = """\
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__74c2a8ec_10_rmsnorm_cu_a1f8713914rmsnorm_kernelI13__nv_bfloat16Li2ELb1EEEvPKT_xPKfPS2_xif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 16 barriers, 2048 bytes smem
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__74c2a8ec_10_rmsnorm_cu_a1f8713918rmsnorm_bwd_kernelIfLi8EEEvPKT_xPKfS3_xPS1_Pfxif' for 'sm_90a'
    40 bytes stack frame, 36 bytes spill stores, 72 bytes spill loads
ptxas info    : Used 128 registers, used 16 barriers, 4096 bytes smem
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__74c2a8ec_10_rmsnorm_cu_a1f8713921rmsnorm_dscale_kernelEPKfPfii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 31 registers, used 1 barriers, 2048 bytes smem
"""


def test_ptxas_report_names_the_rmsnorm_plan_instances(monkeypatch,
                                                        tmp_path):
    """The RMSNorm instances carry a dtype, their vectors a thread and (the
    forward) whether slots walk rows; a CUDA-core instance that spills is
    reported, not failed."""
    text = "".join(_PTXAS.format(d=d, spill=0) for d in (128, 112, 64, 192))
    cs = _chip_smoke(monkeypatch, tmp_path,
                     text + _PTXAS_RMSNORM + _PTXAS_SSD.format(spill=0) +
                     _PTXAS_SSD_BWD.format(states=0, reverse=0))
    rows = {r["kernel"]: r for r in cs.ptxas_report()}
    assert rows["rmsnorm_kernel<bf16, 2, true>"]["registers"] == 40
    assert rows["rmsnorm_bwd_kernel<f32, 8>"] == {
        "kernel": "rmsnorm_bwd_kernel<f32, 8>", "registers": 128,
        "spill_stores": 36, "spill_loads": 72}
    assert rows["rmsnorm_dscale_kernel"]["registers"] == 31


@pytest.mark.parametrize("name,fault", [
    ("ssd_bwd_states_kernel", "spills"), ("ssd_bwd_states_kernel", "missing"),
    ("ssd_bwd_wgmma_kernel", "spills"), ("ssd_bwd_wgmma_kernel", "missing")])
def test_ptxas_report_fails_a_spilling_or_missing_ssd_backward_instance(
        monkeypatch, tmp_path, name, fault):
    """Both bf16 SSD backward kernels issue wgmma: each is required in the
    report and may not spill."""
    text = "".join(_PTXAS.format(d=d, spill=0) for d in (128, 112, 64, 192))
    bwd = _PTXAS_SSD_BWD.format(
        states=16 if (name, fault) == ("ssd_bwd_states_kernel", "spills")
        else 0,
        reverse=16 if (name, fault) == ("ssd_bwd_wgmma_kernel", "spills")
        else 0)
    if fault == "missing":
        entries = bwd.split("ptxas info    : Compiling")
        bwd = "ptxas info    : Compiling".join(
            e for e in entries if name not in e.split("\n")[0])
    cs = _chip_smoke(monkeypatch, tmp_path,
                     text + _PTXAS_SSD.format(spill=0) + bwd)
    with pytest.raises(AssertionError, match=name):
        cs.ptxas_report()


@pytest.mark.parametrize("ssd", ["spills", "missing"])
def test_ptxas_report_fails_a_spilling_or_missing_ssd_wgmma_instance(
        monkeypatch, tmp_path, ssd):
    text = "".join(_PTXAS.format(d=d, spill=0) for d in (128, 112, 64, 192))
    if ssd == "spills":
        text += _PTXAS_SSD.format(spill=4)
    cs = _chip_smoke(monkeypatch, tmp_path, text + _PTXAS_OTHERS)
    with pytest.raises(AssertionError, match="ssd_wgmma_kernel"):
        cs.ptxas_report()


@pytest.mark.parametrize("dims,spill", [((128, 112, 64, 192), 16),
                                        ((128, 64, 192), 0)])
def test_ptxas_report_fails_a_spilling_or_missing_flash_instance(
        monkeypatch, tmp_path, dims, spill):
    text = "".join(_PTXAS.format(d=d, spill=spill if d == 112 else 0)
                   for d in dims)
    cs = _chip_smoke(monkeypatch, tmp_path, text)
    with pytest.raises(AssertionError, match="flash_wgmma_kernel<112>"):
        cs.ptxas_report()


def test_ptxas_report_fails_without_the_head_dim_192_instance(
        monkeypatch, tmp_path):
    text = "".join(_PTXAS.format(d=d, spill=0) for d in (128, 112, 64))
    cs = _chip_smoke(monkeypatch, tmp_path,
                     text + _PTXAS_SSD.format(spill=0))
    with pytest.raises(AssertionError, match="flash_wgmma_kernel<192>"):
        cs.ptxas_report()
