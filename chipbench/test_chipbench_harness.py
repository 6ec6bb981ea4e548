"""The harness's plumbing on the CPU: the check of loaded modules, files
found by name, the receiver, the trace reader, and a run that finds no
card."""

import json
import subprocess
import sys
import urllib.request

import pytest

from chipbench import common, testing
from chipbench import trace as tracing
from chipbench.train_driver import ReceiverProcess


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["repro_torch", "repro_torch.models", "torch", "jaxtyping",
            "reproduce"]
    assert common.forbidden_modules(mods) == []
    assert common.forbidden_modules(mods + ["repro.core", "jax.numpy",
                                            "jaxlib", "flax"]) == \
        ["flax", "jax.numpy", "jaxlib", "repro.core"]


def test_the_harness_loads_no_forbidden_module():
    code = ("import sys; sys.path[:0] = ['.', 'src']; "
            "import chipbench.run, chipbench.train_driver, "
            "chipbench.readings, repro_torch.train.loop; "
            "from chipbench import common; "
            "print(common.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_added_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a metric and limits added as files
    are found without editing a file that is there."""
    here = tmp_path / "chipbench"
    testing.write_json(here / "configs" / "new.json",
                       {"port": testing.port("dense")})
    testing.write_json(here / "traffic" / "mix.json", {"kind": "train"})
    testing.write_json(here / "limits" / "new-cell.json", {"loss": 0.5})
    (here / "metrics").mkdir()
    (here / "metrics" / "layer.new_ms.py").write_text(
        "UNIT = 'ms'\n\ndef read(run):\n    return run.get('x')\n")
    (here / "metrics" / "e2e_rate.py").write_text(
        "UNIT = 'x/s'\n\ndef read(run):\n    return 2 * run['x']\n")
    bench = {"configs": [{"name": "new", "file": "chipbench/configs/"
                          "new.json"}],
             "workloads": [{"name": "new-cell", "config": "new",
                            "traffic": "mix", "chips": 1}],
             "end_to_end": [{"name": "e2e_rate", "unit": "x/s"}],
             "per_layer": [{"name": "layer.new_ms", "unit": "ms",
                            "workloads": ["new-cell"]},
                           {"name": "layer.other", "unit": "ms",
                            "workloads": ["another"]}]}
    c = common.cell("new-cell", bench)
    assert common.config_file(c["config"], bench, root=tmp_path)["port"][
        "family"] == "dense"
    assert common.traffic_file(c["traffic"], here=here)["kind"] == "train"
    assert common.limits_file("new-cell", here=here) == {"loss": 0.5}
    assert common.read_metrics("new-cell", bench, True, {"x": 3.0},
                               here=here) == {
        "layer.new_ms": {"value": 3.0, "unit": "ms"}}
    assert common.read_metrics("new-cell", bench, False, {"x": 3.0},
                               here=here) == {
        "e2e_rate": {"value": 6.0, "unit": "x/s"}}
    # a reader that finds nothing leaves its metric out
    assert common.read_metrics("new-cell", bench, True, {},
                               here=here) == {}


def test_an_added_family_and_arrival_kind_are_found_by_name(tmp_path,
                                                           monkeypatch):
    """A model family and a kind of arrivals added as files reach the
    references, the parameter count and the traffic generator without
    editing a file that is there."""
    import shutil

    import numpy as np
    import torch

    from chipbench import costs, requests
    from chipbench.reference import model, params as rparams
    here = tmp_path / "chipbench"
    for folder in ("families", "arrivals"):
        shutil.copytree(common.HERE / folder, here / folder)
    (here / "families" / "twin.py").write_text(
        "from chipbench import common\n"
        "_dense = common.load_module('families', 'dense')\n"
        "leaves, hidden = _dense.leaves, _dense.hidden\n\n"
        "def flop_params(port):\n"
        "    return 2 * _dense.flop_params(port)\n")
    (here / "arrivals" / "even.py").write_text(
        "import numpy as np\n\n"
        "def count(mix, seconds):\n"
        "    return int(mix['rate'] * seconds)\n\n"
        "def gaps(mix, n, rng):\n"
        "    return np.full(n, 1.0 / mix['rate'])\n")
    monkeypatch.setattr(common, "HERE", here)
    dense = testing.port("dense")
    twin = dict(dense, family="twin")
    assert rparams.leaves(twin) == rparams.leaves(dense)
    assert costs.flop_params(twin) == 2 * costs.flop_params(dense)
    p = rparams.init_params(twin, 0, "cpu")
    tokens = torch.zeros(1, 4, dtype=torch.long)
    assert torch.equal(model.logits(p, twin, tokens, model.Products()),
                       model.logits(p, dense, tokens, model.Products()))
    mix = {"arrivals": "even", "rate": 4.0, "shape_seed": 1,
           "prompt_median": 8, "prompt_sigma": 0.5, "prompt_min": 2,
           "prompt_max": 16, "new_min": 1, "new_max": 2}
    due = [p.due_s for p in requests.plan(mix, 0, 2.0, 100)]
    assert np.allclose(due, np.arange(1, 9) / 4.0)


def test_every_benchmark_metric_has_a_reader_and_every_cell_its_files():
    bench = common.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert common.metric_reader(m["name"]).UNIT == m["unit"]
    for w in bench["workloads"]:
        port = common.config_file(w["config"], bench)["port"]
        assert callable(common.family(port).hidden)
        mix = common.traffic_file(w["traffic"])
        assert mix["kind"] in ("train", "serve")
        if mix["kind"] == "serve":
            assert callable(common.arrivals(mix).gaps)
        assert common.limits_file(w["name"])


def test_receiver_keeps_what_it_is_sent():
    rec = ReceiverProcess()
    try:
        body = ('hpm,hostname=h0 step=3i,step_time_s=0.5 1000\n'
                'train loss=2.5\nnot a line').encode()
        req = urllib.request.Request(rec.url + "/write?db=global",
                                     data=body, method="POST")
        urllib.request.urlopen(req, timeout=10).read()
        req = urllib.request.Request(rec.url + "/job/start",
                                     data=b'{"jobid": "j"}', method="POST")
        urllib.request.urlopen(req, timeout=10).read()
        alerts = json.loads(urllib.request.urlopen(
            rec.url + "/alerts?jobid=j", timeout=10).read())
        s = rec.summary()
    finally:
        rec.close()
    assert alerts == {"alerts": []}
    assert rec.proc.returncode == 0
    assert [p["measurement"] for p in s["points"]] == ["hpm", "train"]
    assert s["points"][0]["fields"] == {"step": 3, "step_time_s": 0.5}
    assert s["points"][0]["tags"] == {"hostname": "h0"}
    assert s["signals"] == [["start", "j"]] and len(s["bad_lines"]) == 1


def test_trace_reader_unions_device_time_and_names_gaps():
    ev = [{"cat": "user_annotation", "name": tracing.WINDOW, "ts": 0,
           "dur": 100},
          {"cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
          {"cat": "kernel", "name": "k2", "ts": 20, "dur": 20},
          {"cat": "gpu_memcpy", "name": "copy", "ts": 60, "dur": 10},
          {"cat": "kernel", "name": "k1", "ts": 95, "dur": 20},
          {"cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 50},
          {"cat": "cpu_op", "name": "aten::add", "ts": 38, "dur": 5}]
    t = tracing.read(ev)
    assert t["window_s"] == 100e-6
    assert t["busy_s"] == pytest.approx(45e-6)
    assert t["device_ops"][0] == ("k1", pytest.approx(25e-6))
    gaps = dict(t["idle_gaps"])
    assert gaps["host: aten::mm"] == pytest.approx(10e-6)
    assert gaps["host: aten::add"] == pytest.approx(20e-6)
    assert gaps["host: python"] == pytest.approx(25e-6)


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload",
         common.benchmark()["workloads"][0]["name"], "--seed",
         str(testing.SEED), "--seconds", "1", "--trace", "0"],
        cwd=common.ROOT, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_the_references_import_nothing_of_the_program():
    """The plain references, the families, the arrivals, the generator
    and the receiver import neither the port nor JAX nor the JAX package,
    by an AST scan of their imports."""
    import ast
    files = sorted((common.HERE / "reference").glob("*.py")) + \
        sorted((common.HERE / "families").glob("*.py")) + \
        sorted((common.HERE / "arrivals").glob("*.py")) + \
        [common.HERE / "receiver.py", common.HERE / "costs.py",
         common.HERE / "requests.py", common.HERE / "common.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "jax",
                                               "jaxlib", "flax", "repro"), \
                    (path.name, n)
