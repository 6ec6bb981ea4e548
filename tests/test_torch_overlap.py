"""The overlapped step (the train CLI's ``--overlap-flags``) against the
step without overlap, and the gathers in the compute dtype, over gloo ranks
on the CPU.

Three worlds (``torch_dist_ranks``, case ``overlap``): one rank on a
(1, 1) mesh, two ranks on (2, 1) and four ranks on (2, 2) and (4, 1).  Each
run takes three steps from the same params and global batches twice:
``make_train_step(..., overlap=False)`` and ``overlap=True``.  The
overlapped step must give the same bits: the loss, grad norm, param norm
and lr of every step (and the MoE statistics) and every piece after the
steps, on every rank.  The runs:

* lms-demo smoke (bf16 compute, fp32 params) on (2, 1) under remat
  ``"minimal"`` in 1 microbatch, on (2, 2) under ``"full"`` and on (4, 1)
  under ``"none"``, both in 2;
* mixtral smoke on (2, 2), rwkv6 smoke on (2, 2), the zamba2 smoke hybrid
  at 5 layers on (2, 1) (each shared block gathered at each of its 2 or 3
  uses, on the SSD's plain version), seamless smoke on (2, 1);
* lms-demo narrow in fp32 on (2, 2) with Adafactor in 2 microbatches (the
  ``lms-dm22`` run of ``test_torch_dist_step.py``), overlapped, held to the
  reference's single-device step at ``STEP_TOL``, the reference run as that
  file runs it;
* a one-rank (1, 1) mesh with overlap on: the one-device step's bits, and
  no worker thread, side stream or overlap group made.

Every rank logs the collectives as it issues them (process group, whether
in flight, kind, purpose, dtype, bytes): the ranks of each group issue the
same ones in the same order, and the overlapped step issues the same
multiset as the step without overlap (only in another thread and group).
Each overlapped run on a live "data" axis ran ``param_gather`` and
``grad_scatter`` exchanges in flight.

The gathers in the compute dtype (``sharding.wire_dtypes``): the same
(2, 1) run with every leaf gathered in its own dtype gives the same bits,
and its ``param_gather`` bytes are those of the bf16-gathered leaves
doubled; on one device, for one assigned arch of each family (its smoke
config), rounding
the listed leaves to bf16 leaves the loss and every gradient bit-equal,
while rounding the rest too moves them (the check can fail).

Two planted faults (``torch_dist_ranks._mutated``) must each break the
bits: a prefetch that hands layer i the leaves of layer i + 1
(``prefetch_own``), and gradients credited before their exchanges are
waited, each exchange held back by ``comm._DELAY_S`` (``grad_unwaited``).
On the two-rank world the train CLI takes ``--overlap-flags`` and passes
``overlap=True`` to ``train`` with its mesh; on one rank it says there is
nothing to overlap.
"""

import collections
import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_dist_step as dist_step  # noqa: E402
import torch_dist_ranks  # noqa: E402
from repro.models.transformer import model_specs as jmodel_specs  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.models.params import flatten, unflatten  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    init_model_params, loss_fn)
from repro_torch.parallel.sharding import wire_dtypes  # noqa: E402
from repro_torch.train.loop import stub_extras  # noqa: E402
from repro_torch.train.step import batch_to_device  # noqa: E402
from test_torch_moe import _numpy_params  # noqa: E402

STEPS = 3
BASE = dict(warmup_steps=1, learning_rate=3e-3, total_steps=100)
M21, M22, M41, M11 = (2, 1), (2, 2), (4, 1), (1, 1)
# name: (model, cfg overrides, mesh, remat, microbatches, options)
RUNS = {
    "lms-21-minimal": ("lms-demo", {}, M21, "minimal", 1, {"wire": False}),
    "lms-22-full-mb2": ("lms-demo", {}, M22, "full", 2, {}),
    "lms-41-none-mb2": ("lms-demo", {}, M41, "none", 2, {}),
    "zamba2-21": ("zamba2-7b", {"num_layers": 5}, M21, "minimal", 1, {}),
    "seamless-21": ("seamless-m4t-large-v2", {}, M21, "minimal", 1, {}),
    "mixtral-22": ("mixtral-8x7b", {}, M22, "minimal", 1, {}),
    "rwkv6-22": ("rwkv6-1.6b", {}, M22, "minimal", 1, {}),
    "lms-dm22-ref": ("lms-demo", dist_step.NARROW, M22, "minimal", 2,
                     {"optimizer": "adafactor", "held": True}),
    "one-rank": ("lms-demo", {}, M11, "minimal", 2, {"one_device": True}),
}
FAULTS = {
    "fault-prefetch": ("lms-demo", {}, M21, "full", 1,
                       {"mutate": "prefetch_own"}),
    "fault-grads": ("lms-demo", {}, M21, "minimal", 1,
                    {"mutate": "grad_unwaited"}),
}
METRICS = ("loss", "grad_norm", "param_norm", "lr", "moe_aux_loss",
           "moe_dropped_frac", "moe_max_load")
CLI = ["--smoke", "--device", "cpu", "--overlap-flags", "--lms-url",
       "http://localhost:1", "--peak-flops", "1e12", "--hbm-bw", "1e11"]


def _world_of(mesh) -> int:
    return mesh[0] * mesh[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("overlap")
    runs = {1: [], 2: [], 4: []}
    for n in runs:
        (d / f"w{n}").mkdir()
    held = {}
    for i, (name, (model, cfg, mesh, remat, nm, opts)) in enumerate(
            {**RUNS, **FAULTS}.items()):
        wd = d / f"w{_world_of(mesh)}"
        jc, tc = dist_step._cfgs(model, cfg, {})
        batches = dist_step._batches(tc.vocab_size, seed=i, n=STEPS)
        if tc.family == "encdec":
            rng = np.random.default_rng(100 + i)
            batches.update({f"src_frames{j}": rng.standard_normal(
                (dist_step.B, tc.encdec_source_len, tc.d_model)).astype(
                    np.float32) for j in range(STEPS)})
        np.savez(wd / f"{name}_batches.npz", **batches)
        tcfg = {**BASE, "remat_policy": remat, "num_microbatches": nm,
                "optimizer": opts.get("optimizer", "adamw")}
        run = {"name": name, "model": model, "cfg": cfg,
               "names": ("data", "model"), "shape": mesh, "tcfg": tcfg,
               "steps": STEPS, "batches": f"{name}_batches.npz",
               **{k: v for k, v in opts.items()
                  if k in ("wire", "mutate", "one_device")}}
        if model == "zamba2-7b":
            run["hybrid"] = {}
        if opts.get("held"):
            pn = _numpy_params(jmodel_specs(jc))
            np.savez(wd / f"{name}_params.npz", **dist_step._flat_np(pn))
            run["params"] = f"{name}_params.npz"
            held[name] = (jc, tcfg, pn, batches)
        runs[_world_of(mesh)].append(run)
    # the three worlds side by side (7 processes), the reference meanwhile
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = {n: pool.submit(
            torch_dist_ranks.launch, "overlap", n, str(d / f"w{n}"), {
                "runs": r, **({"cli": CLI} if n == 2 else {})}, 300)
            for n, r in runs.items()}
        want = {name: dist_step._reference(
            jc, {k: v for k, v in tcfg.items() if k not in BASE}, pn,
            batches, STEPS) for name, (jc, tcfg, pn, batches) in held.items()}
        out = {n: f.result() for n, f in futures.items()}
    return {"out": out, "want": want}


def _ranks(world, name):
    model, cfg, mesh, *_ = {**RUNS, **FAULTS}[name]
    return world["out"][_world_of(mesh)]


def _same(rank: dict, name: str, a: str, b: str) -> list:
    """The metrics and pieces in which runs ``a`` and ``b`` of ``name``
    differ on one rank (bit for bit)."""
    diff = [k for k in METRICS if f"{name}/{a}/m/{k}" in rank
            and not np.array_equal(rank[f"{name}/{a}/m/{k}"],
                                   rank[f"{name}/{b}/m/{k}"])]
    pre = f"{name}/{a}/p/"
    keys = [k[len(pre):] for k in rank if k.startswith(pre)]
    assert keys
    return diff + [k for k in keys if not np.array_equal(
        rank[pre + k], rank[f"{name}/{b}/p/{k}"])]


@pytest.mark.parametrize("name", list(RUNS))
def test_overlapped_step_equals_the_step_without_it(world, name):
    mesh = RUNS[name][2]
    for rank in _ranks(world, name):
        assert _same(rank, name, "on", "off") == []
        counts = json.loads(str(rank[f"{name}/on/overlapped"]))
        if mesh[0] > 1:
            assert counts.get("param_gather", 0) > 0, counts
            assert counts.get("grad_scatter", 0) > 0, counts
        else:
            assert counts == {}
        assert json.loads(str(rank[f"{name}/off/overlapped"])) == {}


def _log(rank, name, tag) -> list:
    return [json.loads(r) for r in rank[f"{name}/{tag}/log"].tolist() if r]


@pytest.mark.parametrize("name", [n for n in RUNS if RUNS[n][2] != M11])
def test_ranks_issue_the_same_collectives_in_one_order(world, name):
    ranks = _ranks(world, name)
    for tag in ("off", "on"):
        by_group = collections.defaultdict(dict)
        for r, rank in enumerate(ranks):
            for group, flight, *row in _log(rank, name, tag):
                by_group[(tuple(group), flight)].setdefault(r, []).append(
                    row)
        assert by_group
        for (group, flight), seqs in by_group.items():
            assert sorted(seqs) == sorted(group)
            first = seqs[group[0]]
            assert all(s == first for s in seqs.values()), (tag, group)
            if flight:
                assert {row[1] for row in first} <= {"param_gather",
                                                     "grad_scatter"}
        if tag == "on":
            assert any(flight for _, flight in by_group), name
    for rank in ranks:
        def bag(tag):
            return collections.Counter(
                json.dumps([g] + row) for g, _, *row in _log(rank, name,
                                                              tag))
        assert bag("on") == bag("off")


def test_overlapped_step_holds_to_the_reference(world):
    name = "lms-dm22-ref"
    metrics, trail = world["want"][name]
    cfg = dataclasses.replace(get_config("lms-demo", smoke=True),
                              **dist_step.NARROW)
    for rank in _ranks(world, name):
        sub = {k[len(name) + 4:]: v for k, v in rank.items()
               if k.startswith(f"{name}/on/")}
        dist_step._check_metrics(sub, metrics, dist_step.STEP_TOL, False)
        sub = {f"{name}/p/{k[len(name) + 6:]}": v for k, v in rank.items()
               if k.startswith(f"{name}/on/p/")}
        sub[f"{name}/coord"] = rank[f"{name}/coord"]
        dist_step._check_pieces(sub, name, cfg, ("data", "model"), M22,
                                trail[STEPS - 1])


def test_a_one_rank_mesh_gives_the_one_device_bits_and_starts_nothing(
        world):
    name = "one-rank"
    (rank,) = _ranks(world, name)
    assert _same(rank, name, "on", "one") == []
    assert _same(rank, name, "off", "one") == []
    assert int(rank[f"{name}/on/new_threads"]) == 0
    assert not bool(rank["started"])
    assert _log(rank, name, "on") == []


def test_bf16_gathers_halve_their_bytes_and_move_no_bit(world):
    name = "lms-21-minimal"
    for rank in _ranks(world, name):
        assert _same(rank, name, "off", "nowire") == []

        def gathers(tag):
            rows = [r for r in _log(rank, name, tag)
                    if r[3] == "param_gather"]
            return len(rows), {dt: sum(r[5] for r in rows if r[4] == dt)
                               for dt in {r[4] for r in rows}}
        n_wire, wire = gathers("off")
        n_plain, plain = gathers("nowire")
        assert n_wire == n_plain
        assert wire["bfloat16"] > 0 and set(plain) == {"float32"}
        assert plain["float32"] == wire.get("float32", 0) + \
            2 * wire["bfloat16"]


@pytest.mark.parametrize("name", list(FAULTS))
def test_planted_faults_break_the_bits(world, name):
    assert any(_same(rank, name, "on", "off")
               for rank in _ranks(world, name))


def test_overlap_flags_reach_train(world):
    for rank in world["out"][2]:
        assert int(rank["cli/rc"]) == 0
        assert bool(rank["cli/overlap"]) and bool(rank["cli/mesh"])
        assert "overlap: the FSDP gathers" in str(rank["cli/out"])


def test_overlap_flags_on_one_rank_say_nothing_to_overlap(monkeypatch,
                                                           capsys):
    from repro_torch.launch import train as train_cli
    got = {}

    class Stack:
        url, stats = "stub", {}

        def __init__(self, url):
            pass

        def close(self):
            pass

        def report_url(self, job):
            return ""

    def train(cfg, tcfg, shape, **kw):
        got.update(kw)
        return type("R", (), dict(steps_run=0, last_loss=0.0,
                                  resumed_from=None, findings=[]))()
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(train_cli, "train", train)
    monkeypatch.setattr(train_cli, "RemoteStack", Stack)
    assert train_cli.main(CLI) == 0
    assert got["overlap"] is False and got["mesh"] is None
    assert "nothing to overlap on one rank" in capsys.readouterr().out


def _rounded(params, keys):
    return unflatten({k: v.to(torch.bfloat16).float() if k in keys else v
                      for k, v in flatten(params).items()})


def _loss_and_grads(cfg, params, batch, grads=True):
    flat = {k: v.detach().requires_grad_(grads)
            for k, v in flatten(params).items()}
    loss, _ = loss_fn(unflatten(flat), cfg, batch)
    if not grads:
        return [loss]
    return [loss.detach()] + list(torch.autograd.grad(
        loss, list(flat.values()), allow_unused=True))


# one assigned arch of each family (dense GQA, MoE, MLA, hybrid, RWKV6,
# encoder-decoder, VLM)
FAMILIES = ("granite-3-8b", "mixtral-8x7b", "deepseek-v2-236b", "zamba2-7b",
            "rwkv6-1.6b", "seamless-m4t-large-v2", "qwen2-vl-7b")


@pytest.mark.parametrize("arch", FAMILIES)
def test_wire_dtypes_are_read_only_through_their_cast(arch):
    """Rounding every leaf ``wire_dtypes`` lists to bf16 moves no bit of
    the pass (loss and gradients: every use reads the rounded value);
    rounding every leaf moves them (the fp32 leaves are read in fp32)."""
    cfg = get_config(arch, smoke=True)
    assert cfg.dtype == "bfloat16"
    g = torch.Generator().manual_seed(0)
    # every leaf off the bf16 grid, the norms' ones and zeros too
    params = unflatten({k: v + 1e-3 * torch.randn(v.shape, generator=g)
                        for k, v in flatten(init_model_params(
                            cfg, seed=0, device="cpu")).items()})
    shape = ShapeConfig("w", seq_len=8, global_batch=1, kind="train")
    toks = torch.randint(1, cfg.vocab_size, (1, 9), generator=g)
    np_batch = {"tokens": toks[:, :-1].numpy(), "labels": toks[:, 1:].numpy()}
    if cfg.family == "encdec":
        np_batch["src_frames"] = torch.randn(
            (1, 8, cfg.d_model), generator=g).numpy()
    elif stub_extras(cfg, shape) is not None:
        np_batch.update(stub_extras(cfg, shape)(0, 1))
    batch = batch_to_device(np_batch, "cpu")
    wire = {k for k, dt in wire_dtypes(cfg).items() if dt is not None}
    assert wire and wire < set(flatten(params))
    base = _loss_and_grads(cfg, params, batch)
    same = _loss_and_grads(cfg, _rounded(params, wire), batch)
    assert all(a is b or torch.equal(a, b) for a, b in zip(base, same))
    moved = _loss_and_grads(cfg, _rounded(params, set(flatten(params))),
                            batch, grads=False)
    assert not torch.equal(base[0], moved[0])
