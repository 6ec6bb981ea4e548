"""The all-to-all MoE dispatch over 8 gloo ranks vs the reference's
grouped dispatch, on the CPU (the reference's ``tests/test_moe_a2a.py``
case: the mixtral smoke model with 8 experts, capacity factor 8 so neither
path drops, x of (4, 16, d) in fp32, a (2, 4) data x model mesh).

Each rank holds its "data" coordinate's rows.  ``apply_moe_a2a`` and
``apply_moe`` with ``impl="a2a"`` and the mesh in ``pc`` give the
reference's ``apply_moe`` output on those rows (2e-4, the reference test's
tolerance); the gradients of sum(y^2) over the global batch (each rank's
term, summed over "data") match ``jax.grad`` of the reference's (5e-3
relative, 5e-4 absolute, its tolerance), the router's included; the aux
statistics are the reference a2a path's (e * sum of the squared mean
probabilities, and their largest times e), 1e-5.  On a (2, 2, 2) mesh with
a "pod" axis ``impl="a2a"`` runs the grouped dispatch over the pod x data
ranks' rows, the reference's fallback: same output (2e-4) and max load
(1e-6).  The dispatch counter records which ran.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_ranks  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from test_torch_moe import _numpy_params  # noqa: E402

MOE = {"num_experts": 8, "capacity_factor": 8.0}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe")
    jc = jget_config("mixtral-8x7b", smoke=True)
    jc.moe = dataclasses.replace(jc.moe, **MOE)
    pn = _numpy_params(jmoe.moe_specs(jc))
    x = (0.1 * np.random.default_rng(1).standard_normal(
        (4, 16, jc.d_model))).astype(np.float32)
    np.savez(d / "moe.npz", x=x,
             **{f"p/{k}": v for k, v in flatten(pn).items()})
    out = torch_dist_ranks.launch("moe", 8, str(d),
                                  {"model": "mixtral-8x7b", "moe": MOE})
    jp = jax.tree.map(jnp.asarray, pn)
    y, aux = jmoe.apply_moe(jp, jnp.asarray(x), jc)
    grads = jax.grad(lambda p: jnp.sum(jnp.square(
        jmoe.apply_moe(p, jnp.asarray(x), jc)[0])))(jp)
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    mean = np.asarray(probs.reshape(-1, MOE["num_experts"]).mean(0))
    return {"out": out, "y": np.asarray(y), "aux": aux,
            "grads": {k: np.asarray(v) for k, v in flatten(grads).items()},
            "a2a_aux": MOE["num_experts"] * float((mean * mean).sum()),
            "a2a_max_load": MOE["num_experts"] * float(mean.max())}


def _rows(y, index, ranks):
    k = y.shape[0] // ranks
    return y[index * k:(index + 1) * k]


def test_a2a_dispatch_on_a_2x4_mesh_matches_the_reference(world):
    for rank, out in enumerate(world["out"]):
        want = _rows(world["y"], rank // 4, 2)       # data = rank // 4
        np.testing.assert_allclose(out["y"], want, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(out["y_apply"], want, rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(float(out["aux_loss"]), world["a2a_aux"],
                                   rtol=1e-5)
        np.testing.assert_allclose(float(out["max_load"]),
                                   world["a2a_max_load"], rtol=1e-5)
        # the direct call and apply_moe(impl="a2a", pc), then the pod mesh
        assert out["dispatches"].tolist() == [1, 2]


def test_a2a_dispatch_gradients_match_the_reference(world):
    for out in world["out"]:
        for k, want in world["grads"].items():
            np.testing.assert_allclose(out[f"grad/{k}"], want, rtol=5e-3,
                                       atol=5e-4, err_msg=k)


def test_a2a_on_a_pod_mesh_runs_the_grouped_dispatch(world):
    for out in world["out"]:
        pod, data, _ = out["pods_coord"].tolist()
        want = _rows(world["y"], pod * 2 + data, 4)
        np.testing.assert_allclose(out["y_pods"], want, rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(float(out["pods_max_load"]),
                                   float(world["aux"]["moe_max_load"]),
                                   rtol=1e-6)
