"""PyTorch port model stack vs the JAX package, on the CPU.

JAX parameters are made once in-process and carried across with the bridge
(JAX's init seeds leaves with Python's per-process string hash, so two
independent inits never match).  The same numpy tokens go through both.
Tolerances: layers in fp32 1e-5; model logits in fp32 1e-4 and in bf16
5e-2 (the reference's model-level tolerance, tests/test_kernels.py).
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.bridge import (  # noqa: E402
    load_npz_checkpoint, params_from_numpy)
from repro_torch.configs import MoEConfig  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _t(arr, dtype=torch.float32):
    return torch.from_numpy(np.array(arr)).to(dtype)


def _cfgs(name, dtype, smoke=True):
    jc = dataclasses.replace(jget_config(name, smoke=smoke), dtype=dtype)
    tc = dataclasses.replace(get_config(name, smoke=smoke), dtype=dtype)
    return jc, tc


def _carry(jparams, tcfg, compute_dtype=None):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                             device="cpu", compute_dtype=compute_dtype)


# -- layers ------------------------------------------------------------------


def test_rope_matches_jax(rng):
    pos = np.arange(40)[None, :]
    jcos, jsin = jlayers.rope_table(jnp.asarray(pos), 16, 10_000.0)
    tcos, tsin = tlayers.rope_table(torch.from_numpy(pos), 16, 10_000.0)
    _close(tcos, jcos, 1e-5)
    _close(tsin, jsin, 1e-5)
    x = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    _close(tlayers.apply_rope(_t(x), tcos, tsin),
           jlayers.apply_rope(jnp.asarray(x), jcos, jsin), 1e-5)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu", "relu2"])
def test_apply_mlp_matches_jax(rng, mlp_type):
    jc, tc = _cfgs("lms-demo", "float32")
    jc = dataclasses.replace(jc, mlp_type=mlp_type)
    tc = dataclasses.replace(tc, mlp_type=mlp_type)
    shapes = {k: s.shape for k, s in tlayers.mlp_specs(tc).items()}
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in shapes.items()}
    x = rng.standard_normal((2, 8, tc.d_model)).astype(np.float32)
    want = jlayers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), jc)
    got = tlayers.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), tc)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("tie", [True, False])
def test_embed_and_logits_match_jax(rng, tie):
    jc, tc = _cfgs("lms-demo", "float32")
    jc = dataclasses.replace(jc, tie_embeddings=tie)
    tc = dataclasses.replace(tc, tie_embeddings=tie)
    v, d = tc.vocab_padded, tc.d_model
    p = {"embedding": (0.02 * rng.standard_normal((v, d))).astype(np.float32)}
    if not tie:
        p["lm_head"] = rng.standard_normal((d, v)).astype(np.float32) / 8
    toks = rng.integers(0, tc.vocab_size, (2, 9))
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    tp = {k: _t(a) for k, a in p.items()}
    jx = jlayers.embed_tokens(jp, jnp.asarray(toks), jc)
    tx = tlayers.embed_tokens(tp, torch.from_numpy(toks), tc)
    _close(tx, jx, 1e-5)
    h = rng.standard_normal((2, 9, d)).astype(np.float32)
    _close(tlayers.lm_logits(tp, _t(h), tc),
           jlayers.lm_logits(jp, jnp.asarray(h), jc), 1e-5)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_jax(rng, norm_type):
    jc, tc = _cfgs("lms-demo", "float32")
    jc = dataclasses.replace(jc, norm_type=norm_type)
    tc = dataclasses.replace(tc, norm_type=norm_type)
    d = tc.d_model
    p = {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    _close(tlayers.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), tc),
           jlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), jc), 1e-5)


# -- parameter specs and init --------------------------------------------------


@pytest.mark.parametrize("name,smoke", [("lms-demo", True), ("lms-demo", False),
                                        ("granite-3-8b", True),
                                        ("granite-3-8b", False),
                                        ("zamba2-7b", True),
                                        ("zamba2-7b", False),
                                        ("phi3-medium-14b", True),
                                        ("phi3-medium-14b", False),
                                        ("yi-34b", True), ("yi-34b", False),
                                        ("nemotron-4-340b", True),
                                        ("nemotron-4-340b", False),
                                        ("mixtral-8x7b", True),
                                        ("mixtral-8x7b", False),
                                        ("deepseek-v2-236b", True),
                                        ("deepseek-v2-236b", False),
                                        ("qwen2-vl-7b", True),
                                        ("qwen2-vl-7b", False),
                                        ("rwkv6-1.6b", True),
                                        ("rwkv6-1.6b", False),
                                        ("seamless-m4t-large-v2", True),
                                        ("seamless-m4t-large-v2", False)])
def test_model_specs_match_jax_layouts(name, smoke):
    """Parameter and decode-cache spec trees: same paths, same shapes."""
    from repro.models.params import ParamSpec

    def shapes(tree):
        flat = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, ParamSpec))[0]
        return {"/".join(str(p.key) for p in path): s.shape
                for path, s in flat}
    jcfg, tcfg = jget_config(name, smoke=smoke), get_config(name, smoke=smoke)
    got = {k: s.shape for k, s in flatten(ttf.model_specs(tcfg)).items()}
    assert got == shapes(jtf.model_specs(jcfg))
    got = {k: s.shape for k, s in
           flatten(ttf.cache_specs(tcfg, 8, 2048)).items()}
    assert got == shapes(jtf.cache_specs(jcfg, 8, 2048))


@pytest.mark.parametrize("name", ["granite-3-8b", "zamba2-7b", "lms-demo",
                                  "phi3-medium-14b", "yi-34b",
                                  "nemotron-4-340b", "mixtral-8x7b",
                                  "deepseek-v2-236b", "qwen2-vl-7b",
                                  "rwkv6-1.6b", "seamless-m4t-large-v2"])
def test_param_counts_match_jax(name):
    jcfg, tcfg = jget_config(name), get_config(name)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()


def test_stacked_leaves_are_drawn_slice_by_slice(monkeypatch):
    """A stacked leaf is drawn one layer at a time (never whole in fp32),
    seeded by (seed, path), with std 1/sqrt(L*d) as JAX's fan-in; in bf16
    it holds the fp32 draw's values rounded."""
    specs = {"layers": tparams.stack_specs(
        {"w": tparams.spec((64, 96), ("embed", "mlp"))}, 4),
        "flat": tparams.spec((32, 8), ("embed", "mlp"))}
    shapes = []
    randn = torch.randn

    def spy(*args, **kw):
        shapes.append(tuple(args[0]))
        return randn(*args, **kw)
    monkeypatch.setattr(torch, "randn", spy)
    a = flatten(tparams.init_params(specs, seed=5, device="cpu"))
    assert shapes == [(64, 96)] * 4 + [(32, 8)]
    b = flatten(tparams.init_params(specs, seed=5, device="cpu"))
    c = flatten(tparams.init_params(specs, seed=6, device="cpu"))
    half = flatten(tparams.init_params(specs, seed=5, device="cpu",
                                       compute_dtype=torch.bfloat16))
    w = a["layers/w"]
    assert torch.equal(w, b["layers/w"])
    assert not torch.equal(w, c["layers/w"])
    assert not torch.equal(w[0], w[1])          # each slice its own draw
    assert abs(float(w.std()) * np.sqrt(4 * 64) - 1.0) < 0.05
    assert half["layers/w"].dtype == torch.bfloat16
    assert torch.equal(half["layers/w"], w.to(torch.bfloat16))


def test_init_is_seeded_and_scaled():
    cfg = get_config("lms-demo", smoke=True)
    a = ttf.init_model_params(cfg, seed=3, device="cpu")
    b = ttf.init_model_params(cfg, seed=3, device="cpu")
    c = ttf.init_model_params(cfg, seed=4, device="cpu")
    fa_, fb, fc = flatten(a), flatten(b), flatten(c)
    assert all(torch.equal(fa_[k], fb[k]) for k in fa_)
    assert not torch.equal(fa_["dense_layers/attn/wq"],
                           fc["dense_layers/attn/wq"])
    wg = fa_["dense_layers/mlp/w_gate"]      # (L, d, ff): fan-in L*d, as JAX
    assert abs(float(wg.std()) * np.sqrt(cfg.num_layers * cfg.d_model)
               - 1.0) < 0.05
    assert torch.equal(fa_["final_norm/scale"], torch.ones(cfg.d_model))
    half = flatten(ttf.init_model_params(cfg, seed=3, device="cpu",
                                         compute_dtype=torch.bfloat16))
    assert half["dense_layers/attn/wq"].dtype == torch.bfloat16
    assert half["embed/embedding"].dtype == torch.bfloat16
    assert half["dense_layers/ln1/scale"].dtype == torch.float32


# -- the model: prefill + decode against the JAX forward -----------------------


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_prefill_and_decode_match_jax(rng, dtype, tol):
    """Prefill then 4 decode steps of lms-demo; the KV caches have the
    compute dtype on both sides, so that fp32 holds them to 1e-4 as well
    (a bf16 cache in an fp32 run puts a value on a rounding boundary a bf16
    unit away in some processes: JAX's init folds the string hash into its
    keys)."""
    jc, tc = _cfgs("lms-demo", dtype)
    jp = jtf.init_model_params(jc, seed=0)
    tp = _carry(jp, tc)
    toks = rng.integers(0, tc.vocab_size, (2, 12))
    jcache = jtf.init_cache(jc, 2, 24, dtype=getattr(jnp, dtype))
    jl, jcache, _ = jtf.forward(jp, jc, tokens=jnp.asarray(toks, jnp.int32),
                                mode="prefill", cache=jcache)
    tcache = ttf.init_cache(tc, 2, 24, dtype=getattr(torch, dtype),
                            device="cpu")
    with torch.inference_mode():
        tl, tcache = ttf.forward(tp, tc, tokens=torch.from_numpy(toks),
                                 mode="prefill", cache=tcache)
    _close(tl, jl, tol)
    _close(tcache["dense"]["k"], jcache["dense"]["k"], tol)
    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    for step in range(4):
        pos = 12 + step
        jl, jcache, _ = jtf.forward(
            jp, jc, tokens=jnp.asarray(nxt[:, None], jnp.int32),
            mode="decode", cache=jcache, pos=jnp.int32(pos))
        with torch.inference_mode():
            tl, tcache = ttf.forward(tp, tc,
                                     tokens=torch.from_numpy(nxt[:, None].copy()),
                                     mode="decode", cache=tcache, pos=pos)
        _close(tl, jl, tol)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    assert tcache["dense"]["k"].dtype == getattr(torch, dtype)


@pytest.mark.parametrize("name", ["phi3-medium-14b", "yi-34b",
                                  "nemotron-4-340b"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_dense_family_prefill_and_decode_match_jax(rng, name, dtype, tol):
    """The rest of the dense family at smoke width: phi3 (GQA 4/1), yi
    (rope theta 5e6) and nemotron (LayerNorm, squared-ReLU, vocab 512 in
    256000's place); prefill then 4 decode steps, caches in the compute
    dtype so that fp32 holds them to 1e-4 as well."""
    jc, tc = _cfgs(name, dtype)
    jp = jtf.init_model_params(jc, seed=0)
    tp = _carry(jp, tc)
    toks = rng.integers(0, tc.vocab_size, (2, 12))
    jcache = jtf.init_cache(jc, 2, 24, dtype=getattr(jnp, dtype))
    jl, jcache, _ = jtf.forward(jp, jc, tokens=jnp.asarray(toks, jnp.int32),
                                mode="prefill", cache=jcache)
    tcache = ttf.init_cache(tc, 2, 24, dtype=getattr(torch, dtype),
                            device="cpu")
    with torch.inference_mode():
        tl, tcache = ttf.forward(tp, tc, tokens=torch.from_numpy(toks),
                                 mode="prefill", cache=tcache)
    _close(tl, jl, tol)
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
        _close(tl, jl, tol)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    _close(tcache["dense"]["v"], jcache["dense"]["v"], tol)


@pytest.mark.parametrize("s,cache_len", [(20, 16), (10, 16), (6, 12)])
def test_sliding_window_cache_matches_jax(rng, s, cache_len):
    """GQA attention under mixtral's smoke window (16) in fp32, against the
    JAX ``gqa_attention`` at 2e-5: a prefill longer than the window (the
    ring keeps the prompt's tail in slots p mod 16), one inside it, and a
    cache shorter than the window (the full cache with the window mask);
    then decode steps, past the ring's wrap where there is a ring.  Outputs
    and cache contents at every step."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    jc, tc = _cfgs("mixtral-8x7b", "float32")
    assert tc.sliding_window == 16
    p = {k: (rng.standard_normal(sp.shape) / np.sqrt(sp.shape[0])
             ).astype(np.float32) for k, sp in tattn.attn_specs(tc).items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    b, hd = 2, tc.head_dim
    shape = (b, cache_len, tc.num_kv_heads, hd)
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tcache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}

    def step(pos, n, mode):
        x = rng.standard_normal((b, n, tc.d_model)).astype(np.float32)
        posn = np.arange(pos, pos + n)[None, :]
        jr = jlayers.rope_table(jnp.asarray(posn), hd, tc.rope_theta)
        tr = tlayers.rope_table(torch.from_numpy(posn), hd, tc.rope_theta)
        kw = {} if mode == "prefill" else {"pos": pos}
        jy, jc_ = jattn.gqa_attention(
            jp, jnp.asarray(x), jc, rope=jr, mode=mode, cache=jcache,
            **{k: jnp.int32(v) for k, v in kw.items()})
        ty, tc_ = tattn.gqa_attention(tp, _t(x), tc, rope=tr, mode=mode,
                                      cache=tcache, **kw)
        _close(ty, jy, 2e-5)
        for k in ("k", "v"):
            _close(tc_[k], jc_[k], 2e-5)
        return jc_

    jcache = step(0, s, "prefill")
    steps = 20 if cache_len == tc.sliding_window else cache_len - s
    for i in range(steps):
        jcache = step(s + i, 1, "decode")


def test_full_width_lms_demo_prefill_matches_jax(rng):
    """Full lms-demo (8 layers, d=512, head_dim 64), B=2, S=32, bf16; the
    port's params carried in bf16 by the bridge's one-time cast."""
    jc, tc = _cfgs("lms-demo", "bfloat16", smoke=False)
    jp = jtf.init_model_params(jc, seed=0)
    tp = _carry(jp, tc, compute_dtype=torch.bfloat16)
    toks = rng.integers(0, tc.vocab_size, (2, 32))
    jl, _, _ = jtf.forward(jp, jc, tokens=jnp.asarray(toks, jnp.int32),
                           mode="prefill", cache=jtf.init_cache(jc, 2, 32))
    with torch.inference_mode():
        tl, _ = ttf.forward(tp, tc, tokens=torch.from_numpy(toks),
                            mode="prefill",
                            cache=ttf.init_cache(tc, 2, 32, device="cpu"))
    assert tl.shape == (2, 32, tc.vocab_padded)
    _close(tl, jl, 5e-2)


# -- bridge and checkpoints -----------------------------------------------------


def test_checkpoint_from_jax_serves_in_the_port(tmp_path, rng):
    from repro.ckpt.checkpoint import save_checkpoint
    jc, tc = _cfgs("lms-demo", "float32")
    jp = jtf.init_model_params(jc, seed=0)
    save_checkpoint(str(tmp_path), 7, {"params": jp})
    flat = load_npz_checkpoint(str(tmp_path))
    assert "dense_layers/attn/wq" in flat
    tp = params_from_numpy(flat, tc, device="cpu")
    toks = rng.integers(0, tc.vocab_size, (1, 10))
    jl, _, _ = jtf.forward(jp, jc, tokens=jnp.asarray(toks, jnp.int32),
                           mode="prefill", cache=jtf.init_cache(jc, 1, 10))
    with torch.inference_mode():
        tl, _ = ttf.forward(tp, tc, tokens=torch.from_numpy(toks),
                            mode="prefill")
        tl2, _ = ttf.forward(_carry(jp, tc), tc,
                             tokens=torch.from_numpy(toks), mode="prefill")
    _close(tl, jl, 1e-4)
    assert torch.equal(tl, tl2)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        load_npz_checkpoint(str(tmp_path / "empty"))


def test_bridge_checks_keys_shapes_and_keeps_norms_fp32():
    jc, tc = _cfgs("lms-demo", "bfloat16")
    flat = {k: np.asarray(v) for k, v in
            flatten(jax.tree.map(np.asarray,
                                 jtf.init_model_params(jc, 0))).items()}
    tp = flatten(params_from_numpy(flat, tc, device="cpu",
                                   compute_dtype=torch.bfloat16))
    assert tp["dense_layers/mlp/w_down"].dtype == torch.bfloat16
    assert tp["final_norm/scale"].dtype == torch.float32
    assert tp["dense_layers/ln2/scale"].dtype == torch.float32
    missing = dict(flat)
    del missing["dense_layers/attn/wo"]
    with pytest.raises(KeyError, match="wo"):
        params_from_numpy(missing, tc, device="cpu")
    bad = dict(flat)
    bad["final_norm/scale"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(bad, tc, device="cpu")


# -- what the port does not take, and where it runs ---------------------------


@pytest.mark.parametrize("change", [{"attention_type": "none"},
                                    {"rope_type": "alibi"}])
def test_unported_attention_options_raise(rng, change):
    cfg = dataclasses.replace(get_config("lms-demo", smoke=True), **change)
    with pytest.raises(NotImplementedError):
        p = ttf.init_model_params(cfg, device="cpu")
        ttf.forward(p, cfg, tokens=torch.zeros(1, 4, dtype=torch.long))


def test_unported_family_raises():
    cfg = dataclasses.replace(get_config("lms-demo", smoke=True),
                              family="ssm")
    with pytest.raises(NotImplementedError):
        ttf.model_specs(cfg)
    hybrid_without_ssm = dataclasses.replace(
        get_config("zamba2-7b", smoke=True), ssm=None)
    with pytest.raises(NotImplementedError):
        ttf.model_specs(hybrid_without_ssm)


def test_entry_points_need_cuda_by_default(monkeypatch):
    from repro_torch.serve.engine import ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("lms-demo", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttf.init_model_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttf.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, {})


# -- import hygiene --------------------------------------------------------------


def _port_files():
    root = os.path.join(REPO, "src", "repro_torch")
    files = [os.path.join(REPO, n) for n in
             ("chip_smoke.py", "profile_serve.py", "profile_ssd.py",
              "profile_train.py", "profile_moe_counts.py", "train_faults.py",
              "tp_bf16_witness.py", "rwkv6_witness.py", "world_count.py",
              "overlap_memory.py",
              "examples/train_monitored_torch.py",
              "examples/serve_requests_torch.py",
              "tests/torch_dist_ranks.py")]
    for d, _, names in os.walk(root):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    scanned = {os.path.relpath(p, os.path.join(REPO, "src", "repro_torch"))
               for p in files}
    assert {"train/optim.py", "train/step.py", "train/loop.py",
            "ckpt/checkpoint.py", "data/pipeline.py", "compat.py",
            "launch/__init__.py", "launch/common.py", "launch/train.py",
            "launch/serve.py", "launch/mesh.py", "parallel/__init__.py",
            "parallel/sharding.py", "parallel/comm.py",
            "parallel/pipeline.py", "train/compression.py",
            "launch/steps.py", "launch/cost_analysis.py",
            "launch/dryrun.py", "core/analysis.py"} <= scanned
    assert {f"core/{n}.py" for n in (
        "__init__", "line_protocol", "perf_groups", "usermetric", "marker",
        "host_agent", "httpd")} <= scanned
    assert {"models/moe.py", "configs/phi3_medium_14b.py",
            "configs/yi_34b.py", "configs/nemotron_4_340b.py",
            "configs/mixtral_8x7b.py", "configs/deepseek_v2_236b.py",
            "configs/qwen2_vl_7b.py", "configs/rwkv6_1p6b.py",
            "configs/seamless_m4t_large_v2.py"} <= scanned
    assert {os.path.join("..", "..", "examples", n) for n in (
        "train_monitored_torch.py", "serve_requests_torch.py")} <= scanned
    # the serving layer on a mesh, and the rank programs of the gloo tests
    assert {"serve/engine.py", "models/attention.py",
            os.path.join("..", "..", "tests", "torch_dist_ranks.py")} <= \
        scanned
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{os.path.relpath(path, REPO)}: {n}")
    assert bad == []


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.serve.engine, repro_torch.models.bridge\n"
            "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
            "import repro_torch.train.loop, repro_torch.ckpt\n"
            "import repro_torch.data, repro_torch.compat\n"
            "import repro_torch.core, repro_torch.core.httpd\n"
            "import repro_torch.launch.train, repro_torch.launch.serve\n"
            "import repro_torch.launch.mesh, repro_torch.parallel.pipeline\n"
            "import repro_torch.train.compression\n"
            "import repro_torch.launch.steps, repro_torch.launch.dryrun\n"
            "import repro_torch.launch.cost_analysis\n"
            "import repro_torch.core.analysis\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# -- fp32 leaves of the one-time compute cast -------------------------------------

_OLD_FP32_LEAVES = ("scale", "bias", "norm_scale", "A_log", "dt_bias")


@pytest.mark.parametrize("name", ["granite-3-8b", "zamba2-7b", "lms-demo"])
def test_compute_cast_keeps_the_fp32_leaves_of_the_shipped_models(name):
    """The widened rule keeps exactly the leaves these models kept."""
    cfg = get_config(name)
    paths = list(flatten(ttf.model_specs(cfg)))
    keep = tparams.fp32_leaves(cfg)
    kept = {p for p in paths if tparams.compute_dtype_for(
        p, torch.float32, torch.bfloat16, keep) == torch.float32}
    assert kept and kept == {p for p in paths
                             if p.rsplit("/", 1)[-1] in _OLD_FP32_LEAVES}


@pytest.mark.parametrize("router_dtype", ["float32", "bfloat16"])
def test_compute_cast_keeps_what_the_reference_reads_in_fp32(router_dtype):
    """RWKV6's decay, bonus and LayerNorm leaves, MLA's latent norms and the
    MoE router (when it routes in fp32) stay fp32; matrices are cast."""
    fp32 = ["w0", "decay_w2", "bonus_u", "ln_tm_scale", "ln_tm_bias",
            "ln_cm_scale", "ln_cm_bias", "ln_x_scale", "ln_x_bias",
            "q_norm", "kv_norm", "scale", "A_log"]
    cast = ["decay_w1", "wr", "wq_a", "wkv_a", "w_gate", "embed"]
    specs = {"layers": {n: tparams.spec((2, 8), (None, None))
                        for n in fp32 + cast},
             "moe": {"router": tparams.spec((8, 4), ("embed", "experts"))}}
    cfg = dataclasses.replace(
        get_config("lms-demo"),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=16,
                      router_dtype=router_dtype))
    out = tparams.init_params(specs, device="cpu",
                              compute_dtype=torch.bfloat16,
                              keep=tparams.fp32_leaves(cfg))
    for n in fp32:
        assert out["layers"][n].dtype == torch.float32, n
    for n in cast:
        assert out["layers"][n].dtype == torch.bfloat16, n
    assert out["moe"]["router"].dtype == (
        torch.float32 if router_dtype == "float32" else torch.bfloat16)
    # without a config the router is a matrix like any other
    assert tparams.compute_dtype_for("moe/router", torch.float32,
                                     torch.bfloat16) == torch.bfloat16
