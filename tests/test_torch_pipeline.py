"""The port's ``pipeline_apply`` backward vs ``jax.grad`` through the
reference's ``repro.parallel.pipeline.pipeline_apply``, on the CPU.

The port runs over gloo (``torch_dist_ranks``, worlds of 4 and 2 ranks, a
("pipe",) mesh of the world); the reference runs in a subprocess on a host
mesh of as many forced CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``), its gradient
taken (jitted) inside ``with jax.set_mesh(mesh):``.  Both take the same numpy
inputs, made from a seed here.

* ``tanh(x @ w)`` stages at S = 4 and 2 stages, 4 and 2 microbatches, the
  loss sum(y ** 2), fp32: the output, every stage's slice of ``dws``
  (gathered over the ranks; each rank's other slices zero) and ``dx`` on
  every rank within 1e-5 of the reference's (the reference test's
  tolerance), and within 1e-5 of autograd through the stages in sequence.
* The slice as a whole: granite-3-8b smoke's dense layers (4 layers, 2 a
  stage, fp32, remat "minimal" and "none"), the reference's stage a loop
  of ``transformer._attn_block(mode="train")``, the port's
  ``_train_layers`` on the stage's slice, the loss sum(y * r): every layer
  leaf's gradient and ``dx`` within 1e-5 relative to the largest element
  of the reference's (each leaf on its own).
* Planted faults (``torch_dist_ranks._pipe_fault``) each fail the tanh
  check at S = 4: the output's gradient summed over the stages, ``dx``
  left on stage 0, a hand-off gradient sent to the wrong stage.
* Under ``torch.no_grad`` the forward keeps no graph: its output does not
  require grad, and equals the output with grad.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_ranks  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.models.transformer import model_specs  # noqa: E402

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TOL = 1e-5
B, D = 8, 16
LAYERS = {"model": "granite-3-8b",
          "cfg": {"num_layers": 4, "dtype": "float32"}}
SEQ, ROWS = 16, 4

TANH = [{"name": f"tanh-s{s}-m{m}", "kind": "tanh", "stages": s,
         "microbatches": m} for s in (4, 2) for m in (4, 2)]
TRANSFORMER = [{"name": f"granite-s2-m2-{remat}", "kind": "layers",
                "stages": 2, "microbatches": 2, "remat": remat, **LAYERS}
               for remat in ("minimal", "none")]
FAULTS = ["pipe_sum", "pipe_dx_rank0", "pipe_wrong_stage"]
MUTANTS = [{"name": f"fault-{k}", "kind": "tanh", "stages": 4,
            "microbatches": 4, "mutant": k, "seed_of": "tanh-s4-m4"}
           for k in FAULTS]
RUNS = TANH + TRANSFORMER + MUTANTS

_REFERENCE = """
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import layers as jlayers
    from repro.models import transformer as jtf
    from repro.parallel.pipeline import pipeline_apply

    work = sys.argv[1]
    runs = json.load(open(work + "/runs.json"))
    data = dict(np.load(work + "/pipeline.npz"))
    out = {}
    for run in runs:
        name, S = run["name"], run["stages"]
        mesh = jax.make_mesh((S,), ("pipe",))
        x = jnp.asarray(data[name + "/x"])
        if run["kind"] == "tanh":
            params = {"ws": jnp.asarray(data[name + "/ws"])}

            def stage(p, xb):
                return jnp.tanh(xb @ p["ws"])

            def loss_of(y):
                return jnp.sum(y ** 2)
        else:
            import dataclasses
            cfg = dataclasses.replace(get_config(run["model"], smoke=True),
                                      **run["cfg"])
            per = cfg.num_layers // S
            key = name + "/params/dense_layers/"
            params = {k[len(key):]: jnp.asarray(v).reshape(
                (S, per) + v.shape[1:]) for k, v in data.items()
                if k.startswith(key)}
            rope = jlayers.rope_table(jnp.arange(x.shape[1])[None, :],
                                      cfg.head_dim, cfg.rope_theta)
            r = jnp.asarray(data[name + "/r"])

            def unflat(flat):
                tree = {}
                for k, v in flat.items():
                    node = tree
                    *parents, last = k.split("/")
                    for q in parents:
                        node = node.setdefault(q, {})
                    node[last] = v
                return tree

            def stage(p, xb, cfg=cfg, rope=rope, per=per):
                for i in range(per):
                    lp = unflat({k: v[i] for k, v in p.items()})
                    xb = jtf._attn_block(lp, xb, cfg, rope=rope,
                                         mode="train", cache=None,
                                         pos=None, pc=None,
                                         attn_impl="masked")[0]
                return xb

            def loss_of(y, r=r):
                return jnp.sum(y * r)

        def loss(params, x, stage=stage, loss_of=loss_of, mesh=mesh,
                 m=run["microbatches"]):
            y = pipeline_apply(stage, params, x, mesh=mesh,
                               num_microbatches=m)
            return loss_of(y), y

        with jax.set_mesh(mesh):
            (_, y), (dp, dx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(params, x)
        out[name + "/y"] = np.asarray(y)
        out[name + "/dx"] = np.asarray(dx)
        out.update({name + "/grad/" + k: np.asarray(v)
                    for k, v in dp.items()})
    np.savez(work + "/reference.npz", **out)
    print("REFERENCE OK")
"""


def _numpy_layers(cfg, rng) -> dict:
    """Every leaf of ``cfg``'s spec tree from a numpy seed, at the init's
    scales (the JAX init's bits differ from process to process)."""
    out = {}
    for k, s in flatten(model_specs(cfg)).items():
        if s.init == "normal":
            fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 \
                else (s.shape[0] if s.shape else 1)
            std = s.scale if s.scale is not None else 1.0 / np.sqrt(fan_in)
            out[k] = (rng.standard_normal(s.shape) * std).astype(np.float32)
        elif s.init == "constant":
            out[k] = np.full(s.shape, s.value, np.float32)
        else:
            # norm scales: ones with noise, so their gradients are tested
            # away from the init's symmetry
            out[k] = (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32) if s.init == "ones" else np.zeros(s.shape,
                                                              np.float32)
    return out


def _inputs() -> dict:
    """The numpy inputs of every run, by ``<run>/<name>``."""
    data = {}
    for run in RUNS:
        name = run["name"]
        rng = np.random.default_rng(RUNS.index(run) if "seed_of" not in run
                                    else [r["name"] for r in RUNS].index(
                                        run["seed_of"]))
        if run["kind"] == "tanh":
            s = run["stages"]
            data[f"{name}/ws"] = (rng.standard_normal((s, D, D)) * 0.3
                                  ).astype(np.float32)
            data[f"{name}/x"] = rng.standard_normal((B, D)).astype(
                np.float32)
            continue
        cfg = torch_dist_ranks._config(run)
        for k, v in _numpy_layers(cfg, rng).items():
            data[f"{name}/params/{k}"] = v
        data[f"{name}/x"] = rng.standard_normal(
            (ROWS, SEQ, cfg.d_model)).astype(np.float32)
        data[f"{name}/r"] = rng.standard_normal(
            (ROWS, SEQ, cfg.d_model)).astype(np.float32)
    return data


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(inputs, the reference's outputs, {stages: each rank's outputs})."""
    work = str(tmp_path_factory.mktemp("pipeline"))
    data = _inputs()
    np.savez(os.path.join(work, "pipeline.npz"), **data)
    clean = [r for r in RUNS if "mutant" not in r]
    with open(os.path.join(work, "runs.json"), "w") as f:
        json.dump(clean, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([_SRC,
                                           os.environ.get("PYTHONPATH", "")]))
    # the reference runs in its own process while the worlds run
    log = open(os.path.join(work, "reference.log"), "w+")
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                            work], env=env, stdout=log,
                           stderr=subprocess.STDOUT)
    ranks = {}
    try:
        for s in (4, 2):
            ranks[s] = torch_dist_ranks.launch(
                "pipeline", s, os.path.join(work, f"world{s}"),
                {"inputs": os.path.join(work, "pipeline.npz"),
                 "runs": [r for r in RUNS if r["stages"] == s]})
    finally:
        try:
            ref.wait(timeout=300)
        except subprocess.TimeoutExpired:
            ref.kill()
            ref.wait()
        log.seek(0)
        text = log.read()
        log.close()
    assert ref.returncode == 0 and "REFERENCE OK" in text, text[-4000:]
    with np.load(os.path.join(work, "reference.npz")) as z:
        want = {k: z[k] for k in z.files}
    return data, want, ranks


def _gaps(run: dict, want: dict, ranks: list) -> dict:
    """{what: the largest |port - reference| over the ranks, relative to
    max(1, the reference's largest magnitude)}: the output and ``dx`` on
    every rank, each stacked leaf's gradient put together from the ranks'
    slices, and each rank's gradient outside its slice (which must be
    zero)."""
    name, ref = run["name"], run.get("seed_of", run["name"])

    def gap(got, w):
        return float(np.abs(got - w).max() / max(1.0, np.abs(w).max()))
    out = {"y": max(gap(o[f"{name}/y"], want[f"{ref}/y"]) for o in ranks),
           "dx": max(gap(o[f"{name}/dx"], want[f"{ref}/dx"])
                     for o in ranks)}
    for key in [k for k in ranks[0] if k.startswith(f"{name}/grad/")]:
        leaf = key[len(name) + 6:]
        mine = np.stack([o[key][s] for s, o in enumerate(ranks)])
        out[f"grad/{leaf}"] = gap(mine, want[f"{ref}/grad/{leaf}"])
        out[f"outside/{leaf}"] = max(
            float(np.abs(np.delete(o[key], s, axis=0)).max(initial=0.0))
            for s, o in enumerate(ranks))
    return out


def _run(name: str) -> dict:
    return next(r for r in RUNS if r["name"] == name)


@pytest.mark.parametrize("name", [r["name"] for r in TANH])
def test_tanh_stages_match_jax_grad_of_the_reference(results, name):
    _, want, ranks = results
    run = _run(name)
    gaps = _gaps(run, want, ranks[run["stages"]])
    assert all(v <= TOL for v in gaps.values()), gaps


@pytest.mark.parametrize("name", [r["name"] for r in TANH])
def test_tanh_stages_match_autograd_in_sequence(results, name):
    """The reference's gradient is the sequential stages' gradient: the
    port holds both (autograd here, through the stages one after the
    other)."""
    data, _, ranks = results
    run = _run(name)
    ws = torch.from_numpy(data[f"{name}/ws"]).requires_grad_()
    x = torch.from_numpy(data[f"{name}/x"]).requires_grad_()
    h = x
    for s in range(run["stages"]):
        h = torch.tanh(h @ ws[s])
    (h ** 2).sum().backward()
    want = {f"{name}/y": h.detach().numpy(), f"{name}/dx": x.grad.numpy(),
            f"{name}/grad/ws": ws.grad.numpy()}
    gaps = _gaps(run, want, ranks[run["stages"]])
    assert all(v <= TOL for v in gaps.values()), gaps


@pytest.mark.parametrize("name", [r["name"] for r in TRANSFORMER])
def test_transformer_stages_match_jax_grad_of_the_reference(results, name):
    _, want, ranks = results
    run = _run(name)
    gaps = _gaps(run, want, ranks[run["stages"]])
    cfg = torch_dist_ranks._config(run)
    leaves = {k for k in flatten(model_specs(cfg))
              if k.startswith("dense_layers/")}
    assert {f"grad/{k[len('dense_layers/'):]}" for k in leaves} == {
        k for k in gaps if k.startswith("grad/")}
    assert all(v <= TOL for v in gaps.values()), gaps


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_tanh_check(results, fault):
    _, want, ranks = results
    gaps = _gaps(_run(f"fault-{fault}"), want, ranks[4])
    assert gaps["y"] <= TOL, gaps          # the forward is untouched
    assert max(gaps.values()) > 100 * TOL, gaps


@pytest.mark.parametrize("name", [r["name"] for r in TANH + TRANSFORMER])
def test_forward_under_no_grad_keeps_no_graph(results, name):
    _, _, ranks = results
    for o in ranks[_run(name)["stages"]]:
        assert not bool(o[f"{name}/nograd_requires_grad"])
        np.testing.assert_array_equal(o[f"{name}/nograd_y"], o[f"{name}/y"])
