"""The port's monitored loop on a mesh: ``train(..., mesh=)`` on 2 gloo
ranks vs the reference's single-device loop, on the CPU.

Both loops resume from one step-0 checkpoint of the same params (lms-demo
narrowed to 2 layers, d=64, fp32; seq 32 x global batch 4, 5 steps, a
checkpoint every 2), so they train the same model on the same batches:
each rank's loss series equals the reference's (STEP_TOL, 1e-4 as
``test_torch_train``), every rank reports to one stack over HTTP (a
``repro.core`` stack served from this process) as its own host, the job is
opened and closed once, and the checkpoints the ranks write hold whole
leaves that the reference loads.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_ranks  # noqa: E402
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import MonitoringStack  # noqa: E402
from repro.models.transformer import model_specs as jmodel_specs  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from test_torch_moe import _numpy_params  # noqa: E402

STEP_TOL = 1e-4
NARROW = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              head_dim=16, d_ff=128, vocab_size=500, vocab_pad_to=128,
              dtype="float32")
SHAPE = dict(name="tiny", seq_len=32, global_batch=4, kind="train")
PEAKS = {"peak_flops": 2e12, "hbm_bw": 1e11}


def _tcfg(ckpt_dir):
    return dict(total_steps=5, warmup_steps=1, learning_rate=3e-3,
                ckpt_dir=str(ckpt_dir), ckpt_interval=2)


def _step0(jc, tcfg, ckpt_dir):
    jp = jax.tree.map(jnp.asarray, _numpy_params(jmodel_specs(jc)))
    state = joptim.get_optimizer(jbase.TrainConfig(**tcfg)).init(jp)
    jckpt.save_checkpoint(str(ckpt_dir), 0, {"params": jp,
                                             "opt_state": state})


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    d = tmp_path_factory.mktemp("loop")
    jc = dataclasses.replace(jget_config("lms-demo", smoke=True), **NARROW)
    out = {}
    stack = MonitoringStack.inprocess(out_dir=str(d / "stack"),
                                      serve_http=True)
    try:
        tcfg = _tcfg(d / "port")
        _step0(jc, tcfg, d / "port")
        ranks = torch_dist_ranks.launch("loop", 2, str(d), {
            "model": "lms-demo", "cfg": NARROW, "tcfg": tcfg,
            "shape": SHAPE, "url": stack.http.url, "job_id": "dist",
            "peaks": PEAKS})
        db = stack.backend.db("global")
        out["port"] = {
            "ranks": ranks,
            "hpm_hosts": sorted(db.tag_values("hpm", "hostname")),
            "train_hosts": sorted(db.tag_values("train", "hostname")),
            "jobids": sorted(db.tag_values("hpm", "jobid")),
            "signals": [v for p in db.select("job_event", ["event"],
                                             tags={"jobid": "dist"})
                        for v in p.values["event"]]}
    finally:
        stack.close()
    tcfg = _tcfg(d / "jax")
    _step0(jc, tcfg, d / "jax")
    jstack = MonitoringStack.inprocess(out_dir=str(d / "jstack"))
    try:
        r = jloop.train(jc, jbase.TrainConfig(**tcfg),
                        jbase.ShapeConfig(**SHAPE), stack=jstack,
                        job_id="jax")
        out["jax"] = {"result": r, "loss": jstack.backend.db(
            "global").select("train", ["loss"])[0].values["loss"]}
    finally:
        jstack.close()
    out["dir"] = d
    return out


def test_dist_loop_matches_the_reference_loop(loops):
    want = loops["jax"]["loss"]
    assert loops["jax"]["result"].resumed_from == 0
    for out in loops["port"]["ranks"]:
        assert int(out["resumed_from"]) == 0 and int(out["final_step"]) == 5
        assert out["mesh_shape"].tolist() == [2, 1]
        np.testing.assert_allclose(out["losses"], want, rtol=STEP_TOL)


def test_dist_loop_reports_every_rank_and_one_job(loops):
    port = loops["port"]
    assert port["hpm_hosts"] == ["host0", "host1"]
    assert port["train_hosts"] == ["host0", "host1"]
    assert port["jobids"] == ["dist"]
    assert sorted(port["signals"]) == ["end", "start"]


def test_dist_loop_checkpoints_hold_whole_leaves(loops):
    d = loops["dir"]
    assert jckpt.available_steps(str(d / "port")) == [0, 2, 4]
    step, flat = None, None
    from repro_torch.ckpt.checkpoint import read_group
    step, flat = read_group(str(d / "port"), "params")
    _, ref = read_group(str(d / "jax"), "params")
    assert step == 4 and set(flat) == set(ref)
    for k, v in ref.items():
        assert flat[k].shape == v.shape
        np.testing.assert_allclose(flat[k], v, rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=k)
