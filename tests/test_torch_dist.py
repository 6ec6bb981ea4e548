"""The port's distribution layer vs the JAX package, on the CPU.

* The sharding binding (``repro_torch.parallel.sharding``) equals the
  reference's ``logical_to_pspec`` entry by entry, for every leaf of
  ``model_specs`` of all 11 full configs, under ``TRAIN_RULES`` and
  ``SERVE_RULES``, on meshes (2, 2), (4, 2), (16, 16) and (2, 16, 16) (the
  reference's on a mesh of repeated devices, as its own tests build it),
  and in the reference's cache-priority and fallback cases; each leaf's
  piece has the shape ``NamedSharding.shard_shape`` gives, and the pieces
  of every coordinate tile the leaf.
* ``opt_state_specs`` gives the reference's tree, shapes, axes and dtypes
  for AdamW and Adafactor (with and without momentum); a moment binds as
  its param's slice.
* ``quantize_int8`` and ``quantization_error``: bit-equal to the
  reference's.
* Over 4 gloo ranks (``torch_dist_ranks``): ``compressed_pmean`` equals the
  numpy mean of the reference's dequantised rows (fp32 sums in another
  order: 1e-6 relative), within scale/2 of the exact mean; the plain and
  bf16 methods; ``pipeline_apply`` on 4 stages equals the reference's stage
  function applied in sequence (1e-5, the reference test's tolerance).
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402

import torch_dist_ranks  # noqa: E402
from repro.configs import available_archs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.transformer import model_specs as jmodel_specs  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.models.params import spec as tspec  # noqa: E402
from repro_torch.models.transformer import model_specs  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.train import compression as tcomp  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402

MESHES = {"2x2": (("data", "model"), (2, 2)),
          "4x2": (("data", "model"), (4, 2)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _jmesh(names, shape):
    dev = np.array(jax.devices() * math.prod(shape)).reshape(shape)
    return Mesh(dev, names)


def _jflat(tree) -> dict:
    out = {}

    def walk(t, pre):
        for k, v in t.items():
            key = f"{pre}/{k}" if pre else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                out[key] = v
    walk(tree, "")
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", ["train", "serve"])
def test_binding_matches_the_reference_for_every_shipped_leaf(mesh, kind):
    names, shape = MESHES[mesh]
    jm, sizes = _jmesh(names, shape), dict(zip(names, shape))
    n = 0
    for arch in available_archs():
        jspecs = _jflat(jmodel_specs(jget_config(arch)))
        tspecs = flatten(model_specs(get_config(arch)))
        assert set(jspecs) == set(tspecs), arch
        for key, js in jspecs.items():
            want = jsh.logical_to_pspec(js.axes, js.shape,
                                        jsh.rules_for(kind), jm)
            ts = tspecs[key]
            got = tsh.logical_to_pspec(ts.axes, ts.shape, tsh.rules_for(kind),
                                       sizes)
            assert got == tuple(want), (arch, key, got, want)
            sharding = tsh.sharding_for(ts, tsh.rules_for(kind), sizes)
            assert sharding.local_shape() == tuple(
                NamedSharding(jm, want).shard_shape(js.shape)), (arch, key)
            n += 1
    assert n > 200


@pytest.mark.parametrize("axes,shape,rules,want", [
    (("embed", "mlp"), (8, 16), "train", ("data", "model")),
    (("embed", "kv_heads"), (8, 7), "train", ("data",)),
    (("embed", "heads"), (7, 8), "train", (None, "model")),
    (("heads", "mlp"), (8, 8), "train", ("model",)),
    (("batch", "cache_seq", "kv_heads", None), (8, 64, 4, 16), "serve",
     ("data", None, "model")),
    (("batch", "cache_seq", "kv_heads", None), (8, 64, 3, 16), "serve",
     ("data", "model")),
    (("norm",), (16,), "train", ())])
def test_binding_cases_match_the_reference(axes, shape, rules, want):
    jm = _jmesh(("data", "model"), (2, 2))
    ref = jsh.logical_to_pspec(axes, shape, jsh.rules_for(rules), jm)
    got = tsh.logical_to_pspec(axes, shape, tsh.rules_for(rules),
                               {"data": 2, "model": 2})
    assert got == tuple(ref) == want


def test_multi_axis_batch_and_its_slices():
    sizes = {"pod": 2, "data": 2, "model": 2}
    ref = jsh.logical_to_pspec(("batch", "seq"), (8, 32), jsh.TRAIN_RULES,
                               _jmesh(tuple(sizes), (2, 2, 2)))
    sh = tsh.sharding_for(tspec((8, 32), ("batch", "seq")),
                          tsh.TRAIN_RULES, sizes)
    assert sh.spec == tuple(ref) == (("pod", "data"),)
    # pod major: (pod, data) = (1, 0) holds rows 4-5
    assert sh.slices({"pod": 1, "data": 0, "model": 1}) == (
        slice(4, 6), slice(0, 32))
    assert sh.replicated_axes == ("model",)


@pytest.mark.parametrize("mesh", ["2x2", "2x16x16"])
def test_pieces_tile_every_leaf(mesh):
    names, shape = MESHES[mesh]
    sizes = dict(zip(names, shape))
    for arch in ("mixtral-8x7b", "deepseek-v2-236b", "zamba2-7b"):
        for key, s in flatten(model_specs(get_config(arch))).items():
            sh = tsh.sharding_for(s, tsh.TRAIN_RULES, sizes)
            # a segmented last dimension (Mamba2's in_proj and conv) is no
            # slice: its pieces' columns (Sharding.columns) tile it instead
            plain = dataclasses.replace(sh, segments=())
            cover, cols = {}, {}
            for coord in np.ndindex(*shape):
                at = dict(zip(names, coord))
                sl = plain.slices(at)
                cover[tuple((x.start, x.stop) for x in sl)] = 1
                if sh.segments:
                    cols[tuple(sh.columns(at))] = 1
            assert len(cover) == math.prod(
                sizes[a] for a in sh.axes), (arch, key)
            for i, d in enumerate(s.shape):
                if sh.segments and i == len(s.shape) - 1:
                    held = [c for cs in cols for c in cs]
                    assert sorted(held) == list(range(d)), (arch, key)
                    continue
                ends = sorted({c[i] for c in cover})
                assert ends[0][0] == 0 and ends[-1][1] == d
                assert all(a[1] == b[0] for a, b in zip(ends, ends[1:]))


def test_constraints_are_the_identity_and_sequence_parallelism_raises():
    """Without sequence parallelism the activation constraints are the
    identity; with it a pass runs sequence-parallel only where the
    sequence divides by the "model" size (the reference's ``tokens``
    fallback; an encoder-decoder's only where its source frames divide
    too), for every family (the recurrent ones included, each of their
    mixers split by ``recurrent_splits``)."""
    pc = tsh.PartitionConstraints(tsh.TRAIN_RULES, {"data": 2, "model": 2})
    x = torch.zeros(2, 4, 8)
    assert pc.tokens(x) is x and pc.act(x, "batch", None, None) is x
    with pytest.raises(ValueError):
        pc.act(x, "batch")
    assert not pc.sp_for(4)
    sp = tsh.PartitionConstraints(tsh.TRAIN_RULES, {"data": 2, "model": 2},
                                  seq_parallel=True)
    assert sp.sp_for(4) and not sp.sp_for(3)
    odd = torch.zeros(2, 3, 8)
    assert sp.tokens(odd) is odd
    # one "model" rank: nothing to split, whatever the flag
    one = tsh.PartitionConstraints(tsh.TRAIN_RULES, {"data": 2, "model": 1},
                                   seq_parallel=True)
    assert not one.sp_for(4) and one.tokens(x) is x
    assert one.tensor_parallel(get_config("granite-3-8b"), 4) is None
    # every family computes tensor-parallel: the recurrent ones take
    # sequence parallelism too (their sequence-parallel passes run in
    # tests/test_torch_tp_recurrent.py)
    for arch in ("zamba2-7b", "rwkv6-1.6b", "qwen2-vl-7b",
                 "deepseek-v2-236b", "seamless-m4t-large-v2"):
        assert sp.sp_pass(get_config(arch), 4)
        assert tsh.recurrent_splits(get_config(arch), lambda s: True) == (
            {"mamba2": True} if arch == "zamba2-7b" else
            {"time_mix": True, "channel_mix": True} if arch == "rwkv6-1.6b"
            else {})
    enc = get_config("seamless-m4t-large-v2")
    assert sp.sp_pass(enc, 4, 8) and not sp.sp_pass(enc, 4, 3)
    assert sp.sp_pass(get_config("deepseek-v2-236b"), 4, 3)
    assert tsh.NullConstraints().mesh is None


def test_production_mesh_needs_its_world():
    with pytest.raises(ValueError, match="repro_torch.launch.dryrun"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="512"):
        tmesh.make_production_mesh(multi_pod=True)


@pytest.mark.parametrize("n,model,want", [(1, 0, 1), (2, 0, 1), (4, 0, 2),
                                          (8, 0, 2), (8, 2, 2), (16, 0, 4),
                                          (6, 4, 2), (256, 0, 16)])
def test_tp_size_is_the_reference_choice(n, model, want):
    assert tmesh.tp_size_for(n, model) == want


@pytest.mark.parametrize("optimizer,beta1", [("adamw", 0.9),
                                             ("adafactor", 0.9),
                                             ("adafactor", 0.0)])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-236b",
                                  "zamba2-7b"])
def test_opt_state_specs_match_the_reference(arch, optimizer, beta1):
    cfg = tbase.TrainConfig(optimizer=optimizer, beta1=beta1)
    want = _jflat(joptim.opt_state_specs(
        jmodel_specs(jget_config(arch)),
        jbase.TrainConfig(**dataclasses.asdict(cfg))))
    got = flatten(toptim.opt_state_specs(model_specs(get_config(arch)), cfg))
    assert set(got) == set(want)
    sizes = {"data": 16, "model": 16}
    params = flatten(model_specs(get_config(arch)))
    for k, w in want.items():
        g = got[k]
        assert (g.shape, g.axes, g.init) == (w.shape, w.axes, w.init), k
        assert str(g.dtype).split(".")[-1] == jnp.dtype(w.dtype).name, k
        # a state leaf binds as the slice of its param's binding
        path = k.split("/", 2)[-1] if k.startswith("s/") else \
            k.split("/", 1)[-1]
        path = path.rsplit("/", 1)[0] if k.startswith("s/") else path
        if path not in params or not g.shape:
            continue
        leaf = tsh.sharding_for(params[path], tsh.TRAIN_RULES, sizes)
        mine = tsh.sharding_for(g, tsh.TRAIN_RULES, sizes)
        full = leaf.spec + (None,) * (len(leaf.shape) - len(leaf.spec))
        part = {"vr": full[:-1], "vc": full[:-2] + full[-1:]}.get(
            k.rsplit("/", 1)[-1], full)
        part = list(part)
        while part and part[-1] is None:
            part.pop()
        assert mine.spec == tuple(part), (k, mine.spec, part)


def test_quantize_int8_is_bit_equal_to_the_reference(rng):
    x = rng.standard_normal((6, 33)).astype(np.float32) * \
        np.logspace(-8, 3, 6, dtype=np.float32)[:, None]
    x[2] = 0.0                                       # the 1e-12 floor
    x[3, 5] = -x[3].max() * 3                        # a row's |max| negative
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    assert tcomp.dequantize_int8(tq, ts).numpy().tobytes() == \
        np.asarray(jcomp.dequantize_int8(jq, js)).tobytes()
    for shape in ((7,), (3, 4, 33), ()):
        y = rng.standard_normal(shape).astype(np.float32)
        got = tcomp.quantization_error(torch.from_numpy(y)).numpy()
        want = np.asarray(jcomp.quantization_error(jnp.asarray(y)))
        assert got.shape == y.shape
        assert got.tobytes() == want.tobytes()


def test_cross_pod_sync_is_the_identity_without_pods():
    g = {"w": torch.ones(3, 4)}
    assert tcomp.cross_pod_sync(g, {"data": 2, "model": 2}) is g
    assert tcomp.cross_pod_sync(g, {"pod": 1, "data": 2}) is g
    assert tcomp.cross_pod_sync(g, {"pod": 2}, method="none") is g


# -- 4 gloo ranks ----------------------------------------------------------------


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    rng = np.random.default_rng(0)
    grads = rng.standard_normal((4, 5, 16)).astype(np.float32)
    ws = (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    np.savez(d / "collectives.npz", grads=grads, ws=ws, x=x)
    out = torch_dist_ranks.launch("collectives", 4, str(d), {})
    return {"grads": grads, "ws": ws, "x": x, "out": out}


def test_compressed_pmean_over_4_ranks_matches_the_reference_rows(
        collectives):
    g = collectives["grads"]
    deq = []
    for r in range(4):
        q, s = jcomp.quantize_int8(jnp.asarray(g[r]))
        deq.append(np.asarray(jcomp.dequantize_int8(q, s)))
    want = np.mean(np.stack(deq), axis=0)
    scale = np.abs(g).max() / 127
    for out in collectives["out"]:
        np.testing.assert_allclose(out["pmean"], want, rtol=1e-6, atol=1e-7)
        assert np.abs(out["pmean"] - g.mean(0)).max() <= scale / 2
        np.testing.assert_allclose(out["mean"], g.mean(0), rtol=1e-6,
                                   atol=1e-7)
        bf = np.asarray(jnp.asarray(g).astype(jnp.bfloat16).astype(
            jnp.float32))
        np.testing.assert_allclose(out["bf16"], bf.mean(0), rtol=1e-2,
                                   atol=1e-2)
        # a 0-d leaf is one row of one element
        np.testing.assert_allclose(out["pmean_vec"], g[:, 0, 0].mean(),
                                   rtol=1e-6)


def test_pipeline_over_4_stages_matches_the_sequential_stages(collectives):
    ws, x = collectives["ws"], collectives["x"]
    want = jnp.asarray(x)
    for s in range(4):
        want = jnp.tanh(want @ jnp.asarray(ws[s]))
    for out in collectives["out"]:
        np.testing.assert_allclose(out["pipe"], np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(out["pipe2"], np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        assert abs(float(out["bubble"]) - 3 / 7) < 1e-12


def test_error_feedback_folds_the_residual_as_the_reference(rng):
    g = {"a": rng.standard_normal((3, 4)).astype(np.float32),
         "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    r = {"a": rng.standard_normal((3, 4)).astype(np.float32),
         "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    want = jcomp.apply_error_feedback(jax.tree.map(jnp.asarray, g),
                                      jax.tree.map(jnp.asarray, r))
    got = tcomp.apply_error_feedback(
        jax.tree.map(torch.from_numpy, g), jax.tree.map(torch.from_numpy, r))
    for k, v in flatten(got).items():
        assert v.numpy().tobytes() == np.asarray(
            flatten(jax.tree.map(np.asarray, want))[k]).tobytes()
