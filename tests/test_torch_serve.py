"""PyTorch port serving engine vs the JAX package's, on the CPU.

Same weights (JAX params carried across with the bridge), same prompts:
the port's engine must give the JAX engine's greedy tokens in float32, and
report the same metrics and marker regions to the monitoring stack.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import MonitoringStack  # noqa: E402
from repro.core.marker import MARKER_MEASUREMENT  # noqa: E402
from repro.models.transformer import init_model_params  # noqa: E402
from repro.serve.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import forward, init_cache  # noqa: E402
from repro_torch.serve.engine import ServingEngine, make_serve_fns  # noqa: E402


def _smoke(dtype="float32", name="lms-demo"):
    jc = dataclasses.replace(jget_config(name, smoke=True), dtype=dtype)
    tc = dataclasses.replace(get_config(name, smoke=True), dtype=dtype)
    jp = init_model_params(jc, seed=0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


def _prompts(rng, lens):
    return [rng.integers(1, 500, size=n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("lens,max_batch,name", [
    pytest.param((5, 9, 3, 12, 7), 4, "lms-demo", id="lens0-4"),
    pytest.param((16,), 1, "lms-demo", id="lens1-1"),
    # MoE with a window of 16: prompts past the window fill the ring from
    # their tail, and decode wraps it
    pytest.param((20, 9, 33), 2, "mixtral-8x7b", id="mixtral-ring")])
def test_greedy_tokens_match_jax_engine(rng, lens, max_batch, name):
    jc, tc, jp, tp = _smoke("float32", name)
    prompts = _prompts(rng, lens)
    jeng = JaxEngine(jc, jp, max_batch=max_batch, max_len=48, jit=False)
    teng = ServingEngine(tc, tp, max_batch=max_batch, max_len=48,
                         device="cpu")
    for p in prompts:
        jeng.submit(p, max_new_tokens=6)
        teng.submit(p, max_new_tokens=6)
    want = [r.output for r in jeng.run_until_empty()]
    got = [r.output for r in teng.run_until_empty()]
    assert got == want
    assert all(len(o) == 6 for o in got)


def test_engine_reports_to_the_monitoring_stack(tmp_path, rng):
    _, tc, _, tp = _smoke("float32")
    st = MonitoringStack.inprocess(out_dir=str(tmp_path))
    try:
        with st.job("tsv1", user="u", hosts=["h0"]):
            um = st.usermetric(host="h0")
            eng = ServingEngine(tc, tp, max_batch=4, max_len=64,
                                usermetric=um, device="cpu")
            for p in _prompts(rng, (4, 5, 6)):
                eng.submit(p, max_new_tokens=4)
            done = eng.run_until_empty()
            um.flush()
        assert len(done) == 3 and all(len(r.output) == 4 for r in done)
        assert all(r.first_token_at is not None for r in done)
        db = st.backend.db("global")
        assert {"serve_prefill", "serve_decode", "serve_request"} <= set(
            db.measurements())
        assert db.select("serve_request")[0].tags["jobid"] == "tsv1"
        snap = eng.markers.snapshot()
        assert snap["serve:prefill"]["calls"] == 1.0
        assert snap["serve:decode"]["calls"] == 1.0
        assert snap["serve:request"]["calls"] == 3.0
        assert snap["serve:request"]["tokens"] == sum(
            len(r.output) for r in done)
        assert snap["serve:decode"]["tokens"] > 0
        regions = set(db.tag_values(MARKER_MEASUREMENT, "region"))
        assert {"serve:prefill", "serve:decode", "serve:request"} <= regions
    finally:
        st.close()


def test_kernel_markers_land_in_the_monitoring_stack(tmp_path, rng):
    """set_kernel_markers takes repro.core's MarkerSession (duck-typed)."""
    _, tc, _, tp = _smoke("float32")
    st = MonitoringStack.inprocess(out_dir=str(tmp_path))
    try:
        with st.job("tsv2", user="u", hosts=["h0"]):
            um = st.usermetric(host="h0")
            prev = ops.set_kernel_markers(um.markers)
            try:
                eng = ServingEngine(tc, tp, max_batch=2, max_len=32,
                                    device="cpu")
                eng.submit(_prompts(rng, (6,))[0], max_new_tokens=3)
                eng.run_until_empty()
            finally:
                ops.set_kernel_markers(prev)
            snap = um.markers.snapshot()
            um.flush()
        n_norms = 2 * tc.num_layers + 1
        assert snap["kernel:flash_attention"]["calls"] == tc.num_layers
        assert snap["kernel:rmsnorm"]["calls"] == 3 * n_norms
        assert snap["kernel:flash_attention"]["flops"] > 0
    finally:
        st.close()


def test_serve_fns_match_forward(rng):
    _, tc, _, tp = _smoke("float32")
    prefill, decode = make_serve_fns(tc)
    toks = torch.from_numpy(rng.integers(1, 500, (2, 7)))
    with torch.inference_mode():
        last, cache = prefill(tp, toks, init_cache(tc, 2, 16, device="cpu"))
        full, _ = forward(tp, tc, tokens=toks, mode="prefill",
                          cache=init_cache(tc, 2, 16, device="cpu"))
        assert torch.equal(last, full[:, -1])
        nxt = torch.argmax(last, dim=-1)[:, None]
        logits, cache = decode(tp, cache, nxt, 7)
    assert logits.shape == (2, tc.vocab_padded)
    assert bool(torch.isfinite(logits).all())


class _Hooks:
    """Duck-typed usermetric/markers hooks (no repro.core)."""

    def __init__(self):
        self.metrics, self.records, self.regions = [], [], []

    def metric(self, name, fields, tags=None):
        self.metrics.append(name)

    def region(self, name, counters=None):
        hooks = self

        class _R:
            def __enter__(self):
                hooks.regions.append(name)
                return self

            def __exit__(self, *exc):
                return False

            def add(self, **c):
                hooks.records.append((name, c))
        return _R()

    def record(self, name, seconds, counters=None):
        self.records.append((name, counters))


def test_engine_takes_duck_typed_hooks(rng):
    _, tc, _, tp = _smoke("float32")
    hooks = _Hooks()
    eng = ServingEngine(tc, tp, max_batch=2, max_len=32, usermetric=hooks,
                        markers=hooks, device="cpu")
    for p in _prompts(rng, (3, 4, 5)):
        eng.submit(p, max_new_tokens=3)
    assert len(eng.run_until_empty()) == 3
    assert hooks.metrics.count("serve_prefill") == 2
    assert hooks.metrics.count("serve_request") == 3
    assert hooks.regions == ["serve:prefill", "serve:decode"] * 2
    assert [n for n, _ in hooks.records].count("serve:request") == 3
