"""Serving under a mesh (``make_serve_fns(cfg, pc=)``) vs the JAX package,
over gloo ranks on the CPU.

Each run serves one batch on its mesh: this rank's pieces of the params
under ``SERVE_RULES`` (or the run's overrides), its rows of the prompts
and its piece of the cache, one prefill and ``n`` decode steps fed the
reference's own greedy tokens (teacher-forced, so a near tie cannot make
the runs part).  Every step's last logits, gathered over "model", are held
to the reference's single-device ``make_serve_fns`` on the same params and
to the port's one-device serve fns (``TOL``: the largest gap relative to
the largest logit, fp32); each rank's cache piece equals the one-device
cache's slice under the binding (``CACHE_TOL``).  The runs:

* the dense smoke model (lms-demo: 4 heads, 2 KV heads) on (1, 2): the KV
  heads take "model" (layout ``"heads"``, the reference's ``"dus"``); on
  (1, 4): they do not divide, so the cache's slots do (``"seq"``, the
  reference's ``"onehot"``): the prompt fills ranks 0-1, decode writes on
  rank 2 and rank 3 holds no written slot, and the queries and partials
  are gathered and merged; on (2, 2): rows and heads split; batch 1 on
  (2, 1): the rows replicated over "data", the params gathered over it;
* mixtral's smoke model (window 16, one KV head, 4 experts) on (1, 2)
  with a prompt of 20 tokens: the ring cache split by slot (ranks hold
  slots 0-7 and 8-15; the ring wraps across them in prefill and decode),
  the experts split, and, under ``SERVE_RULES.with_overrides(experts=None)``,
  every expert's hidden columns split;
* qwen2-vl's smoke model with patches over tokens 1-8 and grid M-RoPE
  positions, continued in decode;
* deepseek-v2 (MLA, 4 heads, 2 a rank, its experts split) on (1, 2): its
  latent cache (``ckv``, ``krope``; no head dimension) split by slot, 12 a
  rank: the prompt of 11 fills rank 0's slots, decode writes position 11
  there and 12-16 on rank 1; on (1, 4): 6 slots a rank, the prompt on
  ranks 0-1, decode crossing from rank 1 to rank 2;
* seamless (the enc-dec, 32 source frames) on (1, 2): its self and cross
  caches split over its 4 KV heads (layout ``"heads"``); and with
  ``kv_heads`` unbound (``SERVE_RULES.with_overrides(kv_heads=None)``):
  both caches split by slot, the cross K/V by source frame (decode merges
  each rank's partials over its frames);
* zamba2 (Mamba2 hybrid) on (1, 2): its Mamba2 layers on each rank's heads
  (the conv cache as its parts' chunks, the SSM state by heads), its
  shared attention blocks' cache split over their 4 KV heads (layout
  ``"heads"``).

Besides: the (1, 4) dense run against the reference's own decode bundle
(``repro.launch.steps.build_decode_bundle``, its ``"onehot"`` write),
compiled on a (1, 4) mesh of 4 forced host devices in a process of its
own; the mutation of merging no partials (each rank attends to its own
slots only) misses; a piece of the wrong shape raises; the cache layouts
of every arch on the production meshes follow the reference's decode
``cache_update`` policy; ``chip_smoke.py``'s phase 6 (f) runs its worlds
on the CPU at smoke size.
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_ranks  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.transformer import init_cache as jinit_cache  # noqa: E402
from repro.models.transformer import model_specs as jmodel_specs  # noqa: E402
from repro.serve.engine import make_serve_fns as jmake_serve_fns  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_config  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.models.transformer import init_cache  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.serve.engine import make_serve_fns  # noqa: E402
from test_torch_dist_step import _flat_np  # noqa: E402
from test_torch_moe import _numpy_params  # noqa: E402
from test_torch_vlm import grid_positions  # noqa: E402

TOL = 1e-4                    # logits: largest gap / largest |logit|
CACHE_TOL = 1e-5
FP32 = {"dtype": "float32"}
M12 = (("data", "model"), (1, 2))
M14 = (("data", "model"), (1, 4))
M22 = (("data", "model"), (2, 2))
M21 = (("data", "model"), (2, 1))
# the served batches: (model, cfg overrides, rows, prompt length, max_len,
# decode steps, VLM extras); an encoder-decoder's get source frames
REFS = {
    "dense": ("lms-demo", FP32, 4, 12, 24, 6, False),
    "dense1": ("lms-demo", FP32, 1, 12, 24, 6, False),
    "mix": ("mixtral-8x7b", FP32, 4, 20, 32, 6, False),
    "vlm": ("qwen2-vl-7b", FP32, 4, 16, 24, 5, True),
    "mla": ("deepseek-v2-236b", FP32, 4, 11, 24, 6, False),
    "encdec": ("seamless-m4t-large-v2", FP32, 4, 12, 24, 5, False),
    "hybrid": ("zamba2-7b", FP32, 4, 12, 24, 5, False),
}
# name: (batch, mesh, rule overrides, layout, mutation)
RUNS = {
    "dense-m12": ("dense", M12, {}, "heads", None),
    "dense-m14": ("dense", M14, {}, "seq", None),
    "dense-m22": ("dense", M22, {}, "heads", None),
    "dense1-m21": ("dense1", M21, {}, "whole", None),
    "mix-m12": ("mix", M12, {}, "seq", None),
    "mix-hidden-m12": ("mix", M12, {"experts": None}, "seq", None),
    "vlm-m12": ("vlm", M12, {}, "seq", None),
    "mla-m12": ("mla", M12, {}, "seq", None),
    "mla-m14": ("mla", M14, {}, "seq", None),
    "encdec-m12": ("encdec", M12, {}, "heads", None),
    "encdec-kv-m12": ("encdec", M12, {"kv_heads": None}, "seq", None),
    "hybrid-m12": ("hybrid", M12, {}, "heads", None),
    "dense-m14-no-merge": ("dense", M14, {}, "seq", "no_merge"),
}
HELD = [n for n, r in RUNS.items() if r[4] is None]


def _cfgs(ref):
    model, cfg = REFS[ref][:2]
    return (dataclasses.replace(jget_config(model, smoke=True), **cfg),
            dataclasses.replace(get_config(model, smoke=True), **cfg))


def _inputs(tc, ref, seed) -> dict:
    """The prompts (and a VLM's patches and positions) of a batch."""
    _, _, b, s, _, n, vlm = REFS[ref]
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(1, tc.vocab_size, (b, s)).astype(np.int32)}
    if tc.family == "encdec":
        out["src_frames"] = rng.standard_normal(
            (b, tc.encdec_source_len, tc.d_model)).astype(np.float32)
    if vlm:
        text = s - 1 - tc.vlm_num_patches
        out["patches"] = (0.5 * rng.standard_normal(
            (b, tc.vlm_num_patches, tc.d_model))).astype(np.float32)
        out["mrope_pos"] = grid_positions(b, 2, 4, text)
        nxt = int(out["mrope_pos"].max()) + 1
        out["dec_mrope"] = np.broadcast_to(
            (nxt + np.arange(n, dtype=np.int32))[None, :, None],
            (b, n, 3)).copy()
    return out


def _dec_extras(inputs, i, asarray):
    if "dec_mrope" not in inputs:
        return {}
    return {"mrope_pos": asarray(inputs["dec_mrope"][:, i:i + 1])}


def _greedy_reference(jc, pn, inputs, max_len, steps):
    """The reference's single-device serve fns, greedy: each step's last
    logits (steps + 1, B, V), the greedy tokens fed back (B, steps) and
    the final cache (flat)."""
    prefill, decode = (jax.jit(f) for f in jmake_serve_fns(jc))
    b, s = inputs["tokens"].shape
    extras = {k: jnp.asarray(inputs[k])
              for k in ("patches", "mrope_pos", "src_frames") if k in inputs}
    params = jax.tree.map(jnp.asarray, pn)
    cache = jinit_cache(jc, b, max_len, dtype=jnp.float32)
    last, cache = prefill(params, jnp.asarray(inputs["tokens"]), cache,
                          extras)
    logits, fed = [np.asarray(last)], []
    for i in range(steps):
        nxt = np.asarray(jnp.argmax(last, axis=-1)).astype(np.int32)
        fed.append(nxt)
        last, cache = decode(params, cache, jnp.asarray(nxt[:, None]),
                             jnp.int32(s + i),
                             _dec_extras(inputs, i, jnp.asarray))
        logits.append(np.asarray(last))
    return np.stack(logits), np.stack(fed, axis=1), _flat_np(cache)


def _one_device(tc, pn, inputs, max_len, fed):
    """The port's one-device serve fns on the same params and tokens."""
    params = params_from_numpy(_flat_np(pn), tc, device="cpu")
    prefill, decode = make_serve_fns(tc)
    toks = torch.from_numpy(inputs["tokens"]).long()
    b, s = toks.shape
    extras = {k: torch.from_numpy(inputs[k])
              for k in ("patches", "src_frames") if k in inputs}
    if "mrope_pos" in inputs:
        extras["mrope_pos"] = torch.from_numpy(inputs["mrope_pos"]).long()
    cache = init_cache(tc, b, max_len, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        last, cache = prefill(params, toks, cache, extras)
        logits = [last.numpy().copy()]
        for i in range(fed.shape[1]):
            ex = _dec_extras(inputs, i, lambda a: torch.from_numpy(a).long())
            last, cache = decode(params, cache,
                                 torch.from_numpy(fed[:, i:i + 1]).long(),
                                 s + i, ex or None)
            logits.append(last.numpy().copy())
    return np.stack(logits), {k: v.float().numpy().copy()
                              for k, v in flatten(cache).items()}


# the reference's decode bundle on a (1, 4) mesh of forced host devices:
# JAX fixes its device count when it starts, so it runs in a process of its
# own; prefill by its single-device serve fns, then its decode bundle
# (cache_update "onehot": 2 KV heads do not divide 4) fed the same tokens
_BUNDLE_REFERENCE = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import base, get_config
from repro.launch.steps import build_decode_bundle
from repro.models.transformer import init_cache
from repro.serve.engine import make_serve_fns

d, max_len = sys.argv[1], int(sys.argv[2])
cfg = dataclasses.replace(get_config("lms-demo", smoke=True),
                          dtype="float32")
params = {}
for k, v in np.load(f"{d}/dense_params.npz").items():
    node = params
    for part in k.split("/")[:-1]:
        node = node.setdefault(part, {})
    node[k.split("/")[-1]] = jnp.asarray(v)
inp = np.load(f"{d}/dense_inputs.npz")
toks, fed = inp["tokens"], inp["steps"]
b, s = toks.shape
prefill, _ = make_serve_fns(cfg)
last, cache = jax.jit(prefill)(params, jnp.asarray(toks),
                               init_cache(cfg, b, max_len, jnp.float32), {})
mesh = Mesh(np.array(jax.devices()).reshape(1, 4), ("data", "model"))
bundle = build_decode_bundle(
    cfg, base.ShapeConfig("t", max_len, b, "decode"), mesh)
fn = jax.jit(bundle.fn, in_shardings=bundle.in_shardings)
out = [np.asarray(last)]
with mesh:
    for i in range(fed.shape[1]):
        last, cache = fn(params, cache, jnp.asarray(fed[:, i:i + 1]),
                         jnp.int32(s + i), {})
        out.append(np.asarray(last))
np.savez(f"{d}/bundle_reference.npz", logits=np.stack(out))
"""


def _start_bundle_reference(d, max_len):
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
                   [torch_dist_ranks.SRC, os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_BUNDLE_REFERENCE), str(d),
         str(max_len)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_mesh")
    want, one = {}, {}
    for i, ref in enumerate(REFS):
        jc, tc = _cfgs(ref)
        pn = _numpy_params(jmodel_specs(jc), seed=i)
        inputs = _inputs(tc, ref, 40 + i)
        logits, fed, cache = _greedy_reference(jc, pn, inputs, REFS[ref][4],
                                               REFS[ref][5])
        inputs["steps"] = fed
        np.savez(d / f"{ref}_params.npz", **_flat_np(pn))
        np.savez(d / f"{ref}_inputs.npz", **inputs)
        want[ref] = (logits, cache)
        one[ref] = _one_device(tc, pn, inputs, REFS[ref][4], fed)
    bundle = _start_bundle_reference(d, REFS["dense"][4])
    runs = {2: [], 4: []}
    for name, (ref, (names, shape), rules, _, mutate) in RUNS.items():
        model, cfg = REFS[ref][:2]
        runs[int(np.prod(shape))].append({
            "name": name, "model": model, "cfg": cfg, "names": names,
            "shape": shape, "rules": rules, "max_len": REFS[ref][4],
            "params": f"{ref}_params.npz", "inputs": f"{ref}_inputs.npz",
            "mutate": mutate})
    out = {n: torch_dist_ranks.launch("serve", n, str(d), {"runs": r})
           for n, r in runs.items()}
    log, _ = bundle.communicate(timeout=600)
    assert bundle.returncode == 0, log[-4000:]
    return {"out": out, "want": want, "one": one,
            "bundle": dict(np.load(d / "bundle_reference.npz"))}


def _gap(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ranks(world, name):
    return world["out"][int(np.prod(RUNS[name][1][1]))]


def _pc(name, ref):
    (names, shape), rules = RUNS[name][1], RUNS[name][2]
    return tsh.PartitionConstraints(
        tsh.SERVE_RULES.with_overrides(**rules), dict(zip(names, shape)),
        batch=REFS[ref][2], max_len=REFS[ref][4])


@pytest.mark.parametrize("name", HELD)
def test_mesh_serving_matches_the_reference(world, name):
    ref = RUNS[name][0]
    want, _ = world["want"][ref]
    one, _ = world["one"][ref]
    assert _gap(one, want) <= TOL
    for out in _ranks(world, name):
        rows = out[f"{name}/rows"]
        got = out[f"{name}/logits"]
        assert got.shape == (REFS[ref][5] + 1, len(rows), want.shape[-1])
        assert _gap(got, want[:, rows]) <= TOL, _gap(got, want[:, rows])
        assert _gap(got, one[:, rows]) <= TOL


@pytest.mark.parametrize("name", HELD)
def test_cache_pieces_are_the_one_device_slices(world, name):
    """Each rank allocated exactly its piece, and after the last decode
    step it holds the one-device cache's slice under the binding; the
    layout is the one the run names."""
    ref, (names, shape), _, layout, _ = RUNS[name]
    _, tc = _cfgs(ref)
    pc = _pc(name, ref)
    assert tsh.kv_cache_layout(tc, pc.rules, pc.mesh, pc.max_len) == layout
    _, cache = world["one"][ref]
    shards = flatten(tsh.cache_shardings(tc, pc.rules, pc.mesh, pc.batch,
                                         pc.max_len))
    for out in _ranks(world, name):
        coord = dict(zip(names, out[f"{name}/coord"].tolist()))
        for k, sh in shards.items():
            got = out[f"{name}/c/{k}"]
            assert got.shape == sh.local_shape(), k
            piece = sh.cut(cache[k], coord)
            assert np.allclose(got, piece, rtol=CACHE_TOL,
                               atol=CACHE_TOL), k
    n = shape[names.index("model")]
    if layout == "seq":
        k = next(k for k in shards if k.endswith(("/k", "/ckv")))
        # (layers, B, slots, ...): the slots split over "model"
        assert shards[k].dim_axes(2) == ("model",)
        assert shards[k].local_shape()[2] * n == shards[k].shape[2]
    if tc.family == "encdec":
        # the cross K/V (layers, B, frames, KV, D) lie as the self cache
        cross = shards["cross/k"]
        dim = 3 if layout == "heads" else 2
        assert cross.dim_axes(dim) == ("model",)
        assert cross.local_shape()[dim] * n == cross.shape[dim]


def test_dense_rows_and_ranks_cover_the_batch(world):
    """(2, 2) splits the 4 rows 2 a "data" rank; (2, 1) with batch 1
    gives both ranks the one row."""
    for name, want in (("dense-m22", [[0, 1], [0, 1], [2, 3], [2, 3]]),
                       ("dense1-m21", [[0], [0]])):
        assert [o[f"{name}/rows"].tolist() for o in _ranks(world, name)] \
            == want


def test_reference_decode_bundle_on_four_devices(world):
    """The reference's decode bundle on (1, 4) (the one-hot write into a
    cache whose slots take "model") and the port's (1, 4) ranks give the
    same logits at every step."""
    ref = world["bundle"]["logits"]
    want, _ = world["want"]["dense"]
    assert _gap(ref, want) <= TOL
    for out in _ranks(world, "dense-m14"):
        assert _gap(out["dense-m14/logits"], ref) <= TOL


def test_merging_no_partials_misses(world):
    """Each rank attending to its own slots only: the decode logits miss
    (rank 3 holds no written slot), the prefill's do not (prefill reads no
    cache)."""
    want, _ = world["want"]["dense"]
    for out in _ranks(world, "dense-m14-no-merge"):
        got = out["dense-m14-no-merge/logits"]
        assert _gap(got[:1], want[:1]) <= TOL
        assert _gap(got[1:], want[1:]) > 100 * TOL


def test_pieces_of_the_wrong_shape_raise():
    """A cache or params piece whose shape is not its binding's raises;
    so do rows that are not this rank's share."""
    from repro_torch.serve.engine import serve_shardings
    cfg = dataclasses.replace(get_config("lms-demo", smoke=True), **FP32)

    class _Mesh:                 # a (1, 2) mesh's shape and rank 0
        mesh_dim_names, shape = ("data", "model"), (1, 2)

        @staticmethod
        def get_coordinate():
            return [0, 0]
    pc = tsh.PartitionConstraints(tsh.SERVE_RULES, _Mesh(), batch=2,
                                  max_len=8)
    psh, csh = serve_shardings(cfg, pc)
    params = {k: torch.zeros(s.local_shape()) for k, s in
              flatten(psh).items()}
    cache = {k: torch.zeros(s.local_shape()) for k, s in
             flatten(csh).items()}
    from repro_torch.models.params import unflatten
    prefill, decode = make_serve_fns(cfg, pc=pc)
    toks = torch.zeros((2, 4), dtype=torch.long)
    whole = {k: torch.zeros(s.shape) for k, s in flatten(csh).items()}
    with pytest.raises(ValueError, match="cache piece"):
        prefill(unflatten(params), toks, unflatten(whole))
    bad = dict(params)
    bad["dense_layers/attn/wq"] = torch.zeros(
        flatten(psh)["dense_layers/attn/wq"].shape)
    with pytest.raises(ValueError, match="params piece"):
        decode(unflatten(bad), unflatten(cache), toks[:, :1], 4)
    with pytest.raises(ValueError, match="rows"):
        prefill(unflatten(params), toks[:1], unflatten(cache))
    with pytest.raises(ValueError, match="max_len"):
        make_serve_fns(cfg, pc=tsh.PartitionConstraints(
            tsh.SERVE_RULES, _Mesh(), batch=2))


def _reference_update(cfg, mesh) -> str:
    """The reference's decode ``cache_update`` rule
    (``repro.launch.steps.build_decode_bundle``)."""
    tp = mesh.get("model", 1)
    kv_sharded = (cfg.attention_type != "mla"
                  and cfg.num_kv_heads % tp == 0 and cfg.num_kv_heads >= tp)
    return "dus" if kv_sharded or tp == 1 else "onehot"


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_cache_layouts_follow_the_reference_policy(arch):
    """On both production meshes: where the reference writes in place
    ("dus") the cache splits its KV heads (zamba2's shared attention
    blocks' 32 included); where it writes one-hot ("onehot") the cache's
    slots take "model" (deepseek's latent, which has no head dimension,
    included; seamless's 16 KV heads split); RWKV6, with no attention
    cache, has layout "whole": its WKV state splits by heads, its token
    shifts stay whole; the rows of decode_32k (128) split 8 a rank,
    long_500k's one row is replicated."""
    cfg = get_config(arch)
    for mesh in ({"data": 16, "model": 16},
                 {"pod": 2, "data": 16, "model": 16}):
        layout = tsh.kv_cache_layout(cfg, tsh.SERVE_RULES, mesh, 32768)
        if arch == "deepseek-v2-236b":
            assert layout == "seq"
        if arch in ("seamless-m4t-large-v2", "zamba2-7b"):
            assert layout == "heads"
        if cfg.family == "ssm":
            assert layout == "whole"
            shards = flatten(tsh.cache_shardings(
                cfg, tsh.SERVE_RULES, mesh, 128, 32768))
            assert {k for k, s in shards.items() if "model" in s.axes} == \
                {"wkv"}
        else:
            assert layout == {"dus": "heads", "onehot": "seq"}[
                _reference_update(cfg, mesh)]
        dp = 16 * mesh.get("pod", 1)
        pc = tsh.PartitionConstraints(tsh.SERVE_RULES, mesh, batch=128,
                                      max_len=32768)
        assert pc.rows_split and pc.local_rows == 128 // dp
        one = tsh.PartitionConstraints(tsh.SERVE_RULES, mesh, batch=1,
                                       max_len=524288)
        assert not one.rows_split and one.local_rows == 1
        assert one.dp_axes == ()


def test_chip_smoke_serving_worlds_run_on_the_cpu(monkeypatch):
    """``chip_smoke.py`` phase 6 (f) rehearsed on the CPU at smoke size:
    each world's ranks (processes of the script over gloo) hold every
    position's logits within MODEL_TOL of the one-device run (launches and
    peaks are the card's, not held here)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    repo = os.path.dirname(torch_dist_ranks.HERE)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    out = cs.dist_serve("cpu", smoke=True)
    assert set(out) == {f"dist:serve-{n}" for n in cs.SERVE_WORLDS}
