"""The comparison that decides ``correct`` fails what it must: at smoke
sizes on the CPU, with the look for a card skipped, the training driver's
run (set-up, window, the reference's check under the cell's limits) comes
out not correct with each fault a training cell can have planted under
the timed path, and with the control (the reference in fp8 put in the
program's place)."""

import pytest

from chipbench import common, testing
from chipbench import train_driver as driver
from chipbench.reference import train as rtrain


def _correct(family: str, got: dict, tr: dict) -> bool:
    port = testing.port(family)
    gaps = driver.check({"port": port}, tr, testing.SEED, got, "cpu")["gaps"]
    ok, _ = common.checks_block(gaps, common.limits_file(
        testing.cell_for(family)))
    return ok


@pytest.mark.parametrize("family", ["dense", "hybrid"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "tokens"])
def test_a_planted_fault_is_not_correct(family, fault):
    tr = testing.traffic()
    got = driver.run({"traffic": "train-2k"}, {"port": testing.port(family)},
                     tr, seed=testing.SEED, seconds=0, trace=False,
                     device="cpu", fault=fault)
    assert got["run"]["window_steps"] >= 1
    assert not _correct(family, got, tr)


def test_set_up_phases_account_for_setup_s():
    tr = testing.traffic()
    got = driver.run({"traffic": "train-2k"}, {"port": testing.port("dense")},
                     tr, seed=testing.SEED, seconds=0, trace=False,
                     device="cpu")
    phases = got["run"]["setup_phases"]
    steps = [f"step {i}" for i in range(1, tr["set_up_steps"] + 1)]
    assert list(phases) == ["imports, CUDA", "receiver", "build",
                            "meta count"] + steps + ["read change"]
    assert 0 <= got["run"]["setup_s"] - sum(phases.values()) < 0.5


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_the_control_is_not_correct(family):
    tr = testing.traffic()
    port = testing.port(family)
    ctl = rtrain.follow(port, tr, testing.SEED, tr["set_up_steps"], "cpu",
                        fp8=True)
    assert not _correct(family, ctl, tr)
