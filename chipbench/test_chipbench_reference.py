"""The plain references against the port, at smoke sizes on the CPU: the
same initial parameters bit for bit, the same token rows, the same forward
pass and the same first steps of training (the port run in fp32)."""

import numpy as np
import pytest
import torch

from chipbench import common, testing
from chipbench import train_driver as driver
from chipbench.reference import data, model, params as rparams, train as rtrain
from repro_torch.data.pipeline import SyntheticTokenSource
from repro_torch.models.params import flatten
from repro_torch.models.transformer import forward, init_model_params


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_initial_parameters_are_the_ports_bit_for_bit(family):
    port = testing.port(family)
    mine = rparams.init_params(port, testing.SEED, "cpu")
    theirs = flatten(init_model_params(driver.model_config(port),
                                       seed=testing.SEED, device="cpu"))
    assert set(mine) == set(theirs)
    for k, t in theirs.items():
        assert torch.equal(mine[k], t), k


@pytest.mark.parametrize("seed", [0, testing.SEED])
def test_token_rows_are_the_ports_and_repeat_for_a_seed(seed):
    src = SyntheticTokenSource(500, seed=seed)
    for step in (0, 3):
        got = data.token_rows(seed, step, 4, 32, 500)
        assert np.array_equal(got, src.batch(step, 4, 32))
        assert np.array_equal(got, data.token_rows(seed, step, 4, 32, 500))
    assert not np.array_equal(data.token_rows(seed, 0, 4, 32, 500),
                              data.token_rows(seed, 1, 4, 32, 500))


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_forward_matches_the_port_in_fp32(family):
    port = testing.port(family, dtype="float32")
    cfg = driver.model_config(port)
    p = rparams.init_params(port, testing.SEED, "cpu")
    tokens = torch.from_numpy(
        data.token_rows(testing.SEED, 0, 2, 32, port["vocab_size"])
        [:, :-1].astype(np.int64))
    theirs, _ = forward(init_model_params(cfg, seed=testing.SEED,
                                          device="cpu"), cfg, tokens=tokens,
                        mode="train")
    mine = model.logits(p, port, tokens, model.Products())
    v = port["vocab_size"]
    assert torch.allclose(mine, theirs[..., :v].float(), atol=2e-5,
                          rtol=1e-5)


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_first_steps_match_the_port_in_fp32(family):
    """The port's job in fp32 through the driver against the reference:
    every number compared is at fp32 round-off."""
    port = testing.port(family, dtype="float32")
    tr = testing.traffic()
    got = driver.run({"traffic": "train-2k"}, {"port": port}, tr,
                     seed=testing.SEED, seconds=0, trace=False,
                     device="cpu", window=False)
    gaps = driver.check({"port": port}, tr, testing.SEED, got,
                        "cpu")["gaps"]
    assert gaps["loss"] < 1e-6 and gaps["grad"] < 1e-5 \
        and gaps["change"] < 1e-5, gaps


def test_fp8_products_round_their_operands():
    a = torch.randn(8, 16, dtype=torch.float64).float()
    b = torch.randn(16, 4).float()
    exact = model.Products()(a, b)
    low = model.Products(fp8=True)(a, b)
    rel = ((low - exact).norm() / exact.norm()).item()
    assert 1e-3 < rel < 0.2


def test_ssd_chunks_agree_with_the_sequential_recurrence():
    g = torch.Generator().manual_seed(0)
    b, l, h, p, n = 2, 40, 3, 4, 5
    x = torch.randn(b, l, h, p, generator=g)
    a = -torch.rand(b, l, h, generator=g)
    bm = torch.randn(b, l, 1, n, generator=g)
    cm = torch.randn(b, l, 1, n, generator=g)
    ssd = common.load_module("families", "hybrid").ssd
    y, state = ssd(x, a, bm, cm, chunk=16)
    s = torch.zeros(b, h, p, n)
    for t in range(l):
        s = s * torch.exp(a[:, t])[..., None, None] \
            + x[:, t, :, :, None] * bm[:, t, 0][:, None, None, :]
        yt = torch.einsum("bhpn,bn->bhp", s, cm[:, t, 0])
        assert torch.allclose(y[:, t], yt, atol=1e-5), t
    assert torch.allclose(state, s, atol=1e-5)


def test_gaps_leave_out_leaves_with_no_gradient():
    ref = {"losses": [1.0], "grad": {"a": 1.0, "b": 1.0, "c": 1e-9},
           "change": {"a": 1.0, "b": 2.0, "c": 5.0}}
    run = dict(ref, change={"a": 1.0, "b": 2.0, "c": 0.0})
    g = rtrain.gaps(run, ref)
    assert g["left_out"] == ["c"] and g["change"] == 0.0
