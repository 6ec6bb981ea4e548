"""The port's CLIs (``repro_torch.launch``), the torch examples and
``repro_torch.compat``, on the CPU, against a ``repro.core`` stack served
over HTTP in this process.

The train CLI is held to ``repro.launch.train`` on the same flags: both
resume from one step-0 checkpoint of the same JAX params (the two
packages draw different random bits), so they train the same model on the
same batches.  Their printed losses are held to 1e-4 relative, the
tolerance ``test_torch_train.py`` holds the loss series of train steps to,
plus the 5e-5 of each printed value's rounding.
"""

import importlib.util
import os
import re

import pytest

torch = pytest.importorskip("torch")

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import MonitoringStack  # noqa: E402
from repro.core.marker import roofline_peaks  # noqa: E402
from repro.launch import train as jtrain_cli  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch import compat  # noqa: E402
from repro_torch.ckpt import checkpoint as tckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.transformer import init_model_params  # noqa: E402
from repro_torch.train.loop import InjectedFailure  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_TOL = 1e-4
PRINT_ROUNDING = 5e-5              # "loss {:.4f}"
PEAKS = (989e12, 3.35e12)
PEAK_ARGS = ["--peak-flops", str(PEAKS[0]), "--hbm-bw", str(PEAKS[1])]
SMALL = ["--smoke", "--seq-len", "32", "--global-batch", "2"]


@pytest.fixture
def stack(tmp_path):
    st = MonitoringStack.inprocess(out_dir=str(tmp_path / "lms"),
                                   serve_http=True)
    try:
        yield st
    finally:
        st.close()


def _port_args(stack, *extra):
    return ["--lms-url", stack.http.url, "--device", "cpu", *PEAK_ARGS,
            *extra]


def _loss_lines(out: str) -> dict:
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"^step\s+(\d+)\s+loss (\S+)\s+grad \S+$", out, re.M)}


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_cli_matches_the_reference_cli(stack, tmp_path, capsys):
    argv = ["--arch", "lms-demo", *SMALL, "--steps", "10",
            "--ckpt-interval", "100"]
    jc = jget_config("lms-demo", smoke=True)
    jp = jtf.init_model_params(jc, seed=0)
    jstate = joptim.get_optimizer(jbase.TrainConfig()).init(jp)
    for name in ("jax", "port"):
        jckpt.save_checkpoint(str(tmp_path / name), 0,
                              {"params": jp, "opt_state": jstate})
    assert jtrain_cli.main(argv + ["--ckpt-dir", str(tmp_path / "jax"),
                                   "--lms-out", str(tmp_path / "jout")]) == 0
    jout = capsys.readouterr().out
    seen = []
    assert train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "port")] +
                          _port_args(stack),
                          step_callback=lambda s, m: seen.append(s)) == 0
    tout = capsys.readouterr().out
    assert seen == list(range(1, 11))

    want, got = _loss_lines(jout), _loss_lines(tout)
    assert sorted(got) == sorted(want) == [1, 10]
    for step, w in want.items():
        assert abs(got[step] - w) <= STEP_TOL * abs(w) + 2 * PRINT_ROUNDING
    done = [ln for ln in tout.splitlines() if ln.startswith("done: ")]
    jdone = [ln for ln in jout.splitlines() if ln.startswith("done: ")]
    assert len(done) == len(jdone) == 1
    assert done[0].split(" final_loss")[0] == \
        jdone[0].split(" final_loss")[0] == "done: steps=10"
    assert done[0].endswith("resumed_from=0") and \
        jdone[0].endswith("resumed_from=0")
    job = re.search(r"^job: (\S+) report: (\S+)$", tout, re.M)
    assert job and job.group(2) == \
        f"{stack.http.url}/jobs/{job.group(1)}/report"
    assert "finding:" not in tout and "finding:" not in jout

    db = stack.backend.db("global")
    train = db.select("train", ["loss"], {"jobid": job.group(1)})
    assert len(train) == 1 and len(train[0].values["loss"]) == 10
    assert roofline_peaks(db) == PEAKS
    assert stack.router.jobs.get(job.group(1)).end_ns is not None


def test_train_cli_fails_and_resumes(stack, tmp_path, capsys):
    argv = ["--arch", "lms-demo", *SMALL, "--steps", "5",
            "--ckpt-interval", "2", "--ckpt-dir", str(tmp_path / "ck")] + \
        _port_args(stack)
    with pytest.raises(InjectedFailure):
        train_cli.main(argv + ["--fail-at-step", "3"])
    assert tckpt.latest_step(str(tmp_path / "ck")) == 2
    capsys.readouterr()
    train_cli.main(argv)
    out = capsys.readouterr().out
    assert "done: steps=3 " in out and out.count("resumed_from=2") == 1
    jobs = stack.router.jobs.all_jobs()
    assert len(jobs) == 2 and all(j.end_ns is not None for j in jobs)
    db = stack.backend.db("global")
    assert sum(len(s.times) for s in db.select("train", ["loss"])) == 3 + 3
    starts = [v for s in db.select("run_state", ["event"],
                                   {"jobid": jobs[1].job_id})
              for v in s.values["event"] if v.startswith("starting")]
    assert starts == ["starting lms-demo-smoke at step 2"]


def test_serve_cli_serves_and_reports(stack, tmp_path, capsys):
    assert serve_cli.main(["--arch", "lms-demo", "--smoke", "--requests",
                           "5", "--max-new-tokens", "4"] +
                          _port_args(stack)) == 0
    out = capsys.readouterr().out
    assert re.search(r"^served 5 requests \| ttft p50 \S+ms \| latency p50 "
                     r"\S+ms p99 \S+ms$", out, re.M)
    db = stack.backend.db("global")
    reqs = db.select("serve_request", ["ttft_s"],
                     {"jobid": "serve-lms-demo-smoke"})
    assert sum(len(s.times) for s in reqs) == 5
    assert {"serve_prefill", "serve_decode", "serve_request",
            "marker"} <= set(db.measurements())
    assert roofline_peaks(db) == PEAKS

    # weights restored from a training checkpoint of the port
    cfg = get_config("lms-demo", smoke=True)
    tckpt.save_checkpoint(str(tmp_path / "w"), 7, {
        "params": init_model_params(cfg, seed=1, device="cpu")})
    serve_cli.main(["--smoke", "--requests", "2", "--ckpt-dir",
                    str(tmp_path / "w")] + _port_args(stack))
    out = capsys.readouterr().out
    assert "restored weights from step 7" in out and \
        "served 2 requests" in out


def test_clis_need_a_stack_and_the_card_by_default(stack, monkeypatch):
    monkeypatch.delenv("LMS_URL", raising=False)
    for cli in (train_cli, serve_cli):
        with pytest.raises(SystemExit):
            cli.main(["--smoke", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cli in (train_cli, serve_cli):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--smoke", "--lms-url", stack.http.url])
    # off a known card, the peaks must be given
    with pytest.raises(ValueError, match="peak"):
        train_cli.main(["--smoke", "--device", "cpu", "--lms-url",
                        stack.http.url])
    monkeypatch.setenv("LMS_URL", "http://127.0.0.1:1")
    with pytest.raises(OSError):            # the stack is unreachable
        train_cli.main([*SMALL, "--steps", "1", "--device", "cpu",
                        *PEAK_ARGS])


def test_train_example_fails_resumes_and_saves_the_report(stack, tmp_path,
                                                          capsys):
    ex = _example("train_monitored_torch")
    assert ex.main(["--smoke", "--steps", "22", "--inject-failure", "21",
                    "--seq-len", "16", "--batch", "2",
                    "--ckpt-dir", str(tmp_path / "ck"),
                    "--out-dir", str(tmp_path / "out")] +
                   _port_args(stack)) == 0
    out = capsys.readouterr().out
    assert "resumed from step 20" in out
    assert "final loss" in out and "after 22 steps" in out
    saved = os.listdir(tmp_path / "out")
    assert len(saved) == 1 and saved[0].endswith("-restart.json")
    summary = [ln for ln in out.splitlines() if ln.startswith("summary: ")]
    assert len(summary) == 1 and '"resumed_from": 20' in summary[0]
    assert len(stack.router.jobs.all_jobs()) == 2


def test_serve_example_runs(stack, capsys):
    ex = _example("serve_requests_torch")
    assert ex.main(["--smoke"] + _port_args(stack)) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 4 and "mean decode throughput" in out
    db = stack.backend.db("global")
    assert sum(len(s.times) for s in db.select("serve_request",
                                               ["ttft_s"])) == 12


def test_compat_resolves_the_raw_stream_call(monkeypatch):
    assert callable(compat.current_raw_stream)
    want = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if want is not None:
        assert compat.current_raw_stream is want
    # a torch without the private call gets the public spelling
    monkeypatch.delattr(torch._C, "_cuda_getCurrentRawStream",
                        raising=False)
    calls = []

    class _Stream:
        cuda_stream = 1234

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: calls.append(dev) or _Stream())
    fn = compat._resolve_raw_stream()
    assert fn is not want and fn(3) == 1234 and calls == [3]
