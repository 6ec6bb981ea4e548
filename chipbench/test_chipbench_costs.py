"""The yardstick's arithmetic against hand counts and against the port's
own cost models, of which it holds frozen copies."""

import pytest

from chipbench import common, costs
from repro_torch.kernels import flash_attention as fa, rmsnorm, ssd


def test_flash_cost_by_hand():
    # b=1, h=2, kv=1, s=4, d=8, bf16: 10 causal pairs a head
    c = costs.flash_cost(1, 2, 1, 4, 8, 2)
    assert c["flops"] == 2 * 2 * (8 + 8) * 10
    assert c["bytes"] == 4 * (2 + 1) * (8 + 8) * 2
    assert costs.attended_pairs(5, causal=True, window=2) == 9


@pytest.mark.parametrize("s,window", [(910, 0), (2048, 0), (300, 64)])
def test_flash_cost_is_the_ports(s, window):
    mine = costs.flash_cost(2, 32, 8, s, 128, 2, window=window)
    theirs = fa.cost_estimate((2, 32, s, 128), 8, 2, causal=True,
                              window=window)
    assert mine == theirs


def test_ssd_cost_by_hand():
    # b=1, h=1, l=2, p=1, g=1, n=1, fp32: 3 causal pairs, 2 steps
    c = costs.ssd_cost(1, 1, 2, 1, 1, 1, 4)
    assert c["flops"] == 2 * (1 + 1) * 3 + 4 * 2
    assert c["bytes"] == (2 * 2 + 2 * 2) * 4 + 2 * 4 + 4


@pytest.mark.parametrize("init", [False, True])
def test_ssd_costs_are_the_ports(init):
    shape = (8, 112, 2048, 64)
    assert costs.ssd_cost(*shape, 1, 64, 2, init_state=init) == \
        ssd.cost_estimate(shape, 1, 64, 2, init_state=init)
    assert costs.ssd_bwd_cost(*shape, 1, 64, 2, init_state=init) == \
        ssd.bwd_cost_estimate(shape, 1, 64, 2, init_state=init)


def test_rmsnorm_costs_are_the_ports():
    assert costs.rmsnorm_cost(16384, 4096, 2) == \
        rmsnorm.cost_estimate((8, 2048, 4096), 2)
    assert costs.rmsnorm_bwd_cost(16384, 4096, 2) == \
        rmsnorm.bwd_cost_estimate((8, 2048, 4096), 2)


def test_bound_takes_the_larger_term():
    peaks = {"flops": 10.0, "bytes": 2.0}
    assert costs.bound_s({"flops": 100.0, "bytes": 4.0}, peaks) == 10.0
    assert costs.bound_s({"flops": 10.0, "bytes": 40.0}, peaks) == 20.0
    assert costs.peaks_for("NVIDIA H100 80GB HBM3")["flops"] == 989e12
    with pytest.raises(ValueError):
        costs.peaks_for("a CPU")


def test_flop_params_by_hand():
    bench = common.benchmark()
    g = common.config_file("granite-3-8b-8l", bench)["port"]
    layer = 4096 * 32 * 128 * 2 + 2 * 4096 * 8 * 128 + 3 * 4096 * 12800 \
        + 2 * 4096
    assert costs.flop_params(g) == 8 * layer + 4096 + 49155 * 4096
    z = common.config_file("zamba2-7b-15l", bench)["port"]
    mamba = 3584 * (2 * 7168 + 128 + 112) + 4 * 7296 + 7296 + 3 * 112 \
        + 7168 + 7168 * 3584 + 3584
    shared = 4 * 3584 * 3584 + 3 * 3584 * 14336 + 2 * 3584
    assert costs.flop_params(z) == 15 * mamba + 2 * shared + 3584 \
        + 32000 * 3584
