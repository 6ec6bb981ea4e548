"""The serving driver at smoke sizes on the CPU, with the look for a card
skipped: the open-loop plan repeats for a seed and holds the same sizes
and arrivals for every seed; a run serves every request due in its window;
and the comparison comes out not correct with each fault a serving cell
can have planted where the tokens are produced (a decode step that leaves
the cache unchanged; a served token altered).  The control (the reference
in fp8 put in the program's place) fails the cell's limit at the cell's
own size on the card (``PERF.md``); at this size its gaps are smaller, and
the test holds it to several times the sound program's."""

import numpy as np
import pytest
import torch

from chipbench import common, requests, serve_driver, testing

MIX = {"kind": "serve", "arrivals": "poisson", "rate": 20.0,
       "shape_seed": 7, "prompt_median": 24, "prompt_sigma": 0.6,
       "prompt_min": 8, "prompt_max": 60, "new_min": 3, "new_max": 6,
       "max_batch": 4, "max_len": 72, "trace_batches": 2,
       "check_tokens": 40}


def _cell_limits() -> dict:
    bench = common.benchmark()
    name = next(w["name"] for w in bench["workloads"]
                if common.traffic_file(w["traffic"])["kind"] == "serve")
    return common.limits_file(name)


def test_plan_repeats_and_keeps_the_work_across_seeds():
    a = requests.plan(MIX, testing.SEED, 2.0, 500)
    b = requests.plan(MIX, testing.SEED, 2.0, 500)
    c = requests.plan(MIX, 3, 2.0, 500)
    assert len(a) == int(MIX["rate"] * 2.0) == len(c)
    assert [p.due_s for p in a] == [p.due_s for p in b] == \
        [p.due_s for p in c]
    assert all(np.array_equal(p.prompt, q.prompt) for p, q in zip(a, b))
    assert [len(p.prompt) for p in a] == [len(p.prompt) for p in c]
    assert [p.new_tokens for p in a] == [p.new_tokens for p in c]
    assert not all(np.array_equal(p.prompt, q.prompt)
                   for p, q in zip(a, c))
    assert a[0].due_s == 0.0 and a[-1].due_s == pytest.approx(
        len(a) / MIX["rate"])
    assert all(MIX["prompt_min"] <= len(p.prompt) <= MIX["prompt_max"]
               for p in a)


def _run(fault=None):
    port = testing.port("dense")
    orig = serve_driver.make_engine

    def planted(*args, **kwargs):
        eng = orig(*args, **kwargs)
        decode = eng.decode
        if fault == "unchanged":
            def stale(params, cache, tokens, pos):
                scratch = {k: {kk: vv.clone() for kk, vv in v.items()}
                           for k, v in cache.items()}
                return decode(params, scratch, tokens, pos)[0], cache
            eng.decode = stale
        elif fault == "token":
            def altered(params, cache, tokens, pos):
                logits, cache = decode(params, cache, tokens, pos)
                logits = logits.clone()
                logits[:, 7] += 1e4
                return logits, cache
            eng.decode = altered
        return eng

    serve_driver.make_engine = planted
    try:
        got = serve_driver.run({"name": "x"}, {"port": port}, MIX,
                               seed=testing.SEED, seconds=1.0, trace=False,
                               device="cpu")
    finally:
        serve_driver.make_engine = orig
    return port, got


def test_a_run_serves_every_request_due_in_its_window():
    port, got = _run()
    run = got["run"]
    assert run["attempted"] >= 10 and run["failed"] == 0
    # set-up's phases account for all of it but the step into the window
    phases = run["setup_phases"]
    assert list(phases) == ["imports, CUDA", "weights", "receiver",
                            "engine", "warm-up"]
    assert 0 <= run["setup_s"] - sum(phases.values()) < 0.5
    assert all(np.isfinite(run["ttft_s"]))
    assert 0 <= run["padded_positions"] < run["prefilled_positions"]
    # every due request was served, in batches that pad to their longest
    served = [r for b in got["batches"] for r in b["requests"]]
    assert len(served) == run["attempted"]
    assert any(len({r[1] for r in b["requests"]}) > 1
               for b in got["batches"])
    ok, checks = common.checks_block(
        serve_driver.check({"port": port}, MIX, testing.SEED, got,
                           "cpu")["gaps"], _cell_limits())
    assert ok, checks


@pytest.mark.parametrize("fault", ["unchanged", "token"])
def test_a_planted_fault_is_not_correct(fault):
    port, got = _run(fault)
    gaps = serve_driver.check({"port": port}, MIX, testing.SEED, got,
                              "cpu")["gaps"]
    assert not common.checks_block(gaps, _cell_limits())[0], gaps


def test_the_control_reads_far_above_the_program():
    port, got = _run()
    sound = serve_driver.check({"port": port}, MIX, testing.SEED, got,
                               "cpu")["gaps"]["token_gap"]
    control = serve_driver.check({"port": port}, MIX, testing.SEED, got,
                                 "cpu", control=True)["gaps"]["token_gap"]
    assert control > 4 * max(sound, 0.02), (sound, control)


def test_weights_repeat_for_a_seed():
    port = testing.port("dense")
    from chipbench import weights
    a = weights.make(port, testing.SEED, "cpu")
    b = weights.make(port, testing.SEED, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["dense_layers/attn/wq"].dtype == torch.bfloat16
    assert a["final_norm/scale"].dtype == torch.float32
