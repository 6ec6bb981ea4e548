"""Rank programs of the port's multi-process tests on the CPU (gloo).

:func:`launch` starts ``world`` processes, each running ``main()`` below with
its rank; they meet through a file store under the test's own directory
(never a fixed TCP port: the suite runs under pytest-xdist), each with one
intra-op thread, and the world has a deadline of its own, so a hang fails
the test instead of eating the suite's clock.  The test computes the JAX
side in its own process and hands inputs to the ranks as numpy (``*.npz``
and a JSON of options under the work directory); a rank writes its results
to ``<case>_<rank>.npz``.  This module imports only torch, numpy and
``repro_torch``: the ranks never load JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def launch(case: str, world: int, workdir: str, opts: dict,
           timeout: float = 240.0) -> list:
    """Run ``case`` on ``world`` ranks; returns each rank's outputs (a dict
    of numpy arrays, rank order).  Raises with the ranks' stderr if one
    fails or the world outlives ``timeout`` seconds."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, f"{case}.json"), "w") as f:
        json.dump(opts, f)
    # a world of the same case run here before may leave its store file
    # behind (its ranks' cleanup does not always remove it); this world's
    # ranks would read that world's addresses and wait on ranks that are gone
    store = os.path.join(workdir, f"{case}.store")
    if os.path.exists(store):
        os.remove(store)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [SRC, HERE, os.environ.get("PYTHONPATH", "")]))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(workdir, f"{case}_{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "import torch_dist_ranks as r; r.main()",
             case, str(rank), str(world), workdir],
            env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
        for p in hung:
            p.wait(timeout=30)
    text = []
    for rank, log in enumerate(logs):
        log.seek(0)
        text.append(f"--- rank {rank} (rc {procs[rank].returncode}) ---\n"
                    + log.read()[-3000:])
        log.close()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"{case} on {world} ranks failed or hung "
                             f"(deadline {timeout} s):\n" + "\n".join(text))
    out = []
    for rank in range(world):
        with np.load(os.path.join(workdir, f"{case}_{rank}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def main() -> None:
    case, rank, world, workdir = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(os.path.join(workdir, f"{case}.json")) as f:
        opts = json.load(f)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, case)}.store",
        rank=rank, world_size=world)
    try:
        out = CASES[case](rank, workdir, opts)
        np.savez(os.path.join(workdir, f"{case}_{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _mesh(names, shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def _config(run: dict):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(run["model"], smoke=True),
                              **run.get("cfg", {}))
    if run.get("moe"):
        cfg.moe = dataclasses.replace(cfg.moe, **run["moe"])
    if run.get("hybrid"):
        cfg.hybrid = dataclasses.replace(cfg.hybrid, **run["hybrid"])
    return cfg


def _load(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _flat(tree) -> dict:
    from repro_torch.models.params import flatten
    return {k: v.detach().float().numpy().copy()
            for k, v in flatten(tree).items()}


def _coord(mesh) -> np.ndarray:
    return np.asarray(mesh.get_coordinate(), np.int64)


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------


def case_collectives(rank: int, workdir: str, opts: dict) -> dict:
    """compressed_pmean over 4 ranks, pipeline_apply over 4 stages."""
    import torch
    from repro_torch.parallel.pipeline import bubble_fraction, pipeline_apply
    from repro_torch.train.compression import compressed_pmean
    data = _load(os.path.join(workdir, "collectives.npz"))
    pod = _mesh(("pod",), (4,))
    x = torch.from_numpy(data["grads"][rank])
    got = compressed_pmean({"g": x, "v": x[0, 0]}, pod.get_group("pod"),
                           "int8")
    plain = compressed_pmean({"g": x}, pod.get_group("pod"), "none")["g"]
    bf16 = compressed_pmean({"g": x}, pod.get_group("pod"), "bf16")["g"]
    pipe = _mesh(("pipe",), (4,))
    ws = torch.from_numpy(data["ws"])
    y = pipeline_apply(lambda w, xb: torch.tanh(xb @ w), ws,
                       torch.from_numpy(data["x"]), mesh=pipe,
                       num_microbatches=4)
    y2 = pipeline_apply(lambda w, xb: torch.tanh(xb @ w), ws,
                        torch.from_numpy(data["x"]), mesh=pipe,
                        num_microbatches=2)
    return {"pmean": got["g"].numpy(), "pmean_vec": got["v"].numpy(),
            "mean": plain.numpy(), "bf16": bf16.numpy(), "pipe": y.numpy(),
            "pipe2": y2.numpy(),
            "bubble": np.float64(bubble_fraction(4, 4))}


def _init_run(run: dict, workdir: str):
    """(cfg, tcfg, mesh, psh, osh, params pieces, opt state, step fn).
    ``run["rules"]``: overrides of ``TRAIN_RULES`` the step is built with
    (its storage and its compute); ``run["params"]``: the whole params'
    ``.npz`` (else ``init_model_params`` at seed 0); ``run["overlap"]``:
    the step's exchanges overlapped."""
    from repro_torch.configs import TrainConfig
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.parallel.sharding import (PartitionConstraints,
                                               TRAIN_RULES, shard_tree)
    from repro_torch.train import step as tstep
    cfg = _config(run)
    tcfg = TrainConfig(**run["tcfg"])
    mesh = _mesh(run["names"], run["shape"])
    pc = PartitionConstraints(
        TRAIN_RULES.with_overrides(**run.get("rules", {})), mesh,
        seq_parallel=tcfg.seq_parallel)
    psh, osh = tstep.shardings(cfg, tcfg, mesh, pc)
    if "params" in run:
        whole = params_from_numpy(
            _load(os.path.join(workdir, run["params"])), cfg, device="cpu")
    else:
        from repro_torch.models.transformer import init_model_params
        whole = init_model_params(cfg, seed=0, device="cpu")
    params = shard_tree(whole, psh, mesh)
    fn, opt = tstep.make_train_step(cfg, tcfg, mesh=mesh, pc=pc,
                                    overlap=run.get("overlap", False))
    return cfg, tcfg, mesh, psh, osh, params, opt.init(params, psh), fn


def _batches(workdir: str, name: str) -> list:
    """The global batches of ``name``: its entries ``<key><step>`` (tokens,
    labels and any extras: a VLM's patches stay floating, the rest int64),
    in step order."""
    import torch
    out = {}
    for k, v in _load(os.path.join(workdir, name)).items():
        key, i = re.fullmatch(r"(.*?)(\d+)", k).groups()
        t = torch.from_numpy(v)
        out.setdefault(int(i), {})[key] = t if t.is_floating_point() \
            else t.long()
    return [out[i] for i in sorted(out)]


METRICS = ("loss", "grad_norm", "param_norm", "lr", "moe_aux_loss",
           "moe_dropped_frac", "moe_max_load")


def _metrics_out(history: list) -> dict:
    out = {}
    for k in METRICS:
        if k in history[0]:
            out[f"m/{k}"] = np.asarray([float(m[k]) for m in history])
    return out


def _int8_gap(run, cfg, tcfg, mesh, psh, params, batch) -> dict:
    """Step 0's gradient piece through the int8 pod exchange and through
    the plain mean, and the quantisation bound of each element: the mean
    over the pods of scale/2 of the row the element sits in."""
    import torch
    from repro_torch.parallel import comm
    from repro_torch.parallel.sharding import PartitionConstraints, \
        TRAIN_RULES, gather_tree
    from repro_torch.models.params import flatten
    from repro_torch.train import step as tstep
    from repro_torch.train.compression import _rows, quantize_int8
    pc = PartitionConstraints(TRAIN_RULES, mesh)
    grads, _ = tstep._grads_and_metrics(
        gather_tree(params, psh, mesh), tstep.shard_batch(batch, mesh), cfg,
        tcfg, pc)
    per_pod = tstep.mean_over_data(grads, psh, mesh)
    exact = tstep.mean_over_pods(per_pod, mesh, "none")
    int8 = tstep.mean_over_pods(per_pod, mesh, "int8")
    gap, slack = [], []
    for k, g in flatten(int8).items():
        _, scale = quantize_int8(_rows(flatten(per_pod)[k]))
        bound = comm.all_reduce(scale.clone(), mesh, ("pod",), "mean") / 2
        err = (g - flatten(exact)[k]).abs()
        gap.append(float(err.max()))
        slack.append(float((_rows(err) - bound).max()))
    return {"int8_gap": np.asarray(gap), "int8_over_bound": np.asarray(slack)}


@contextlib.contextmanager
def _probe(out: dict, name: str):
    """Records, while the step runs, the shape of every leaf its pass
    computes with (as ``sharding.Pieces.gather``, the pass's one gather
    site, returns it, its stacked layer dimensions put back), every
    dimension ``comm.all_gather`` gathers over "model" outside the leaves'
    gathers (its first call of each only), and the whole shape of every
    leaf gathered over "model" (``model_leaf_gathers``, one row a leaf,
    none: shape (0, 0)), and how many tokens the MoE routes picked each
    expert (``expert_counts``, over every routing call of the step)."""
    from repro_torch.models import moe
    from repro_torch.models.params import flatten
    from repro_torch.parallel import comm
    from repro_torch.parallel.sharding import Pieces
    pieces_gather, all_gather, route_topk = Pieces.gather, comm.all_gather, \
        moe.route_topk
    dims, leaves, in_leaf, counts = [], set(), [], []

    def record_routes(logits, top_k):
        gates, experts, probs = route_topk(logits, top_k)
        counts.append(np.bincount(experts.reshape(-1).numpy(),
                                  minlength=logits.shape[-1]))
        return gates, experts, probs

    def record_gather(t, mesh, axis, dim=0):
        if axis == "model" and not in_leaf:
            dims.append(dim)
        return all_gather(t, mesh, axis, dim)

    def record_pieces(plan, tree, prefix, stacked=0, pending=None):
        in_leaf.append(1)
        try:
            got = pieces_gather(plan, tree, prefix, stacked, pending)
        finally:
            in_leaf.pop()
        for k, v in flatten(got).items():
            key = f"{prefix}/{k}"
            sh = plan.shardings[key]
            out.setdefault(f"{name}/local/{key}", np.asarray(
                tuple(sh.shape[:stacked]) + tuple(v.shape)))
            if plan.roles[key] != "split" and \
                    "model" in comm.live_axes(plan.mesh, sh.axes):
                leaves.add(tuple(sh.shape))
        return got
    Pieces.gather, comm.all_gather, moe.route_topk = record_pieces, \
        record_gather, record_routes
    try:
        yield
    finally:
        Pieces.gather, comm.all_gather, moe.route_topk = pieces_gather, \
            all_gather, route_topk
        if counts:
            key = f"{name}/expert_counts"
            out[key] = out.get(key, 0) + np.sum(counts, axis=0)
        out[f"{name}/model_gather_dims"] = np.asarray(sorted(set(dims)),
                                                      np.int64)
        rows = sorted(leaves)
        out[f"{name}/model_leaf_gathers"] = np.asarray(
            rows, np.int64) if rows else np.zeros((0, 0), np.int64)


class _NoGateSum:
    """``comm`` as the MoE layer sees it, with ``copy_to_model`` (which
    only the gates pass there) the identity: a mutation that drops the
    gates' gradient sum over "model"."""

    def __getattr__(self, name):
        from repro_torch.parallel import comm
        return getattr(comm, name)

    @staticmethod
    def copy_to_model(x, mesh):
        return x


@contextlib.contextmanager
def _patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _no_partial_sum(leaf: str):
    """``Pieces.gather`` treating the ``"partial"`` leaves named ``leaf``
    as ``"whole"``: their gradients are cut to this rank's chunk without
    the sum over "model"."""
    import dataclasses as dc
    from repro_torch.parallel.sharding import Pieces
    gather = Pieces.gather

    def mutant(plan, tree, prefix, stacked=0, pending=None):
        roles = {k: "whole" if k.endswith(f"/{leaf}") and r == "partial"
                 else r for k, r in plan.roles.items()}
        return gather(dc.replace(plan, roles=roles), tree, prefix, stacked,
                      pending)
    return _patched(Pieces, "gather", mutant)


def _no_offset(total: int):
    """``transformer._row_positions`` giving a sequence-parallel rank the
    first rows' positions of a sequence of ``total`` (the encoder's frames
    or the decoder's tokens, by their length)."""
    from repro_torch.models import transformer
    rows_of = transformer._row_positions

    def mutant(positions, rows, tp):
        if positions.shape[-1] == total:
            return positions[..., :rows]
        return rows_of(positions, rows, tp)
    return _patched(transformer, "_row_positions", mutant)


def _row_shift(n: int):
    """``ssm._token_shift`` on each of ``n`` blocks of rows on its own (a
    sequence-parallel rank's rows, shifting in zeros at their first row
    instead of the row before): the token-shift trap."""
    import torch
    from repro_torch.models import ssm
    shift = ssm._token_shift

    def mutant(x, last=None):
        if x.shape[1] < n:
            return shift(x, last)
        return torch.cat([shift(c, last if i == 0 else None)
                          for i, c in enumerate(x.chunk(n, dim=1))], dim=1)
    return _patched(ssm, "_token_shift", mutant)


def _column_fault(kind: str):
    """A column exchange with the wrong backward: ``"bc_slice"``, Mamba2's
    B / C gather keeping this rank's columns of the gradient (no sum over
    "model"); ``"cm_sum"``, RWKV6's channel-mix gather summing the
    gradient over "model" (each rank holds it whole already)."""
    from repro_torch.parallel import comm
    if kind == "bc_slice":
        return _patched(comm, "gather_shared_columns",
                        lambda x, mesh, name="bc_gather":
                        comm.gather_columns(x, mesh, name))
    shared = comm.gather_shared_columns
    return _patched(comm, "gather_columns",
                    lambda x, mesh, name="channel_mix": shared(x, mesh, name))


def _local_norm():
    """Mamba2's gated norm on this rank's columns' own statistic (no sum
    over "model")."""
    from repro_torch.kernels import ops
    return _patched(ops, "fused_rmsnorm_split",
                    lambda x, scale, *, width, mesh, eps=1e-5:
                    ops.fused_rmsnorm(x, scale, eps=eps))


def _identity_layout():
    """A segmented leaf cut as a contiguous chunk (the identity in place of
    ``comm.segment_columns``' permutation), in its storage and its
    gathers alike."""
    from repro_torch.parallel import comm

    def contiguous(segments, idx, n):
        k = sum(segments) // n
        return list(range(idx * k, (idx + 1) * k))
    return _patched(comm, "segment_columns", contiguous)


def _pipe_fault(kind: str):
    """A planted fault in ``pipeline_apply``'s backward: ``"pipe_sum"``,
    the output's gradient summed over the stages before the last stage
    takes it (S times the gradient); ``"pipe_dx_rank0"``, the input's
    gradient left on stage 0 (no broadcast); ``"pipe_wrong_stage"``,
    stages 1 and 2 trading places in the reverse schedule, so each sends
    its input's gradient to the wrong stage (every send still meets its
    receive: no hang)."""
    from repro_torch.parallel import comm, pipeline
    if kind == "pipe_dx_rank0":
        broadcast = comm.broadcast

        def mutant(t, src, group, n):
            if comm._PURPOSES[-1:] == ["pipe_grad"]:
                return t
            return broadcast(t, src, group, n)
        return _patched(comm, "broadcast", mutant)
    backward = pipeline._Pipeline.backward

    def mutant_backward(ctx, grad_out):
        sched = ctx.sched
        if kind == "pipe_sum":
            grad_out = grad_out.clone()
            comm.all_reduce_over_group(grad_out, sched.group)
        else:
            swap = {1: 2, 2: 1}
            ctx.sched = sched._replace(
                stage=swap.get(sched.stage, sched.stage),
                ranks=[sched.ranks[swap.get(i, i)]
                       for i in range(sched.stages)])
        return backward(ctx, grad_out)
    return _patched(pipeline._Pipeline, "backward",
                    staticmethod(mutant_backward))


def _prefetch_fault():
    """The overlapped step's prefetch handing layer i the leaves of layer
    i + 1 (the last layer of a loop its own)."""
    from repro_torch.parallel.sharding import LayerGathers

    def mutant(self, j):
        if j is not None and j not in self.pending:
            k = j + 1 if j + 1 < len(self.entries) and \
                self.entries[j + 1][1] == self.entries[j][1] else j
            tree, prefix, stacked, _ = self.entries[k]
            self.pending[j] = self.plan.start(tree, prefix, stacked)
    return _patched(LayerGathers, "issue", mutant)


@contextlib.contextmanager
def _unwaited_grads():
    """The overlapped step's gradients credited from their exchanges'
    buffers before those are waited, each exchange held back by
    ``comm._DELAY_S`` so it has not written them yet (the exchanges are
    waited after, so the ranks stay in step)."""
    from repro_torch.parallel import comm
    collect = comm.GradSink.collect

    def mutant(self, leaves, grads):
        pending = [p for _, p in self.pending]
        with _patched(comm.Pending, "wait",
                      lambda p: p.out.movedim(0, p.dim)):
            out = collect(self, leaves, grads)
        for p in pending:
            p.wait()
        return out
    with _patched(comm, "_DELAY_S", 0.02), \
            _patched(comm.GradSink, "collect", mutant):
        yield


@contextlib.contextmanager
def _mutated(kind):
    """The step with a planted fault (``"gate_sum"``: :class:`_NoGateSum`;
    ``"no_merge"``: decode over a cache split by its slots merges no
    partials, so each rank attends to its own slots only;
    ``"no_partial_sum:<leaf>"``: the gradient of the ``"partial"`` leaves
    named ``<leaf>`` not summed over "model"; ``"no_offset:<S>"``: the
    sinusoidal positions of a sequence of S not offset to a
    sequence-parallel rank's rows; ``"row_shift:<N>"``: :func:`_row_shift`;
    ``"bc_slice"`` / ``"cm_sum"``: :func:`_column_fault`;
    ``"local_norm"``: :func:`_local_norm`; ``"identity_layout"``:
    :func:`_identity_layout`; ``"pipe_*"``: :func:`_pipe_fault`;
    ``"prefetch_own"``: :func:`_prefetch_fault`; ``"grad_unwaited"``:
    :func:`_unwaited_grads`), or as it is (None)."""
    if kind is None:
        yield
        return
    if ":" in kind:
        what, arg = kind.split(":")
        mutant = {"no_partial_sum": lambda: _no_partial_sum(arg),
                  "no_offset": lambda: _no_offset(int(arg)),
                  "row_shift": lambda: _row_shift(int(arg))}[what]()
        with mutant:
            yield
        return
    planted = {"prefetch_own": _prefetch_fault,
               "grad_unwaited": _unwaited_grads,
               "bc_slice": lambda: _column_fault("bc_slice"),
               "cm_sum": lambda: _column_fault("cm_sum"),
               "local_norm": _local_norm,
               "identity_layout": _identity_layout,
               **{k: (lambda k=k: _pipe_fault(k)) for k in (
                   "pipe_sum", "pipe_dx_rank0", "pipe_wrong_stage")}
               }.get(kind)
    if planted is not None:
        with planted():
            yield
        return
    if kind == "no_merge":
        from repro_torch.models import attention
        merge = attention._merge_over_model
        attention._merge_over_model = lambda part, mesh: part
        try:
            yield
        finally:
            attention._merge_over_model = merge
        return
    if kind != "gate_sum":
        raise ValueError(kind)
    from repro_torch.models import moe
    comm = moe.comm
    moe.comm = _NoGateSum()
    try:
        yield
    finally:
        moe.comm = comm


def case_steps(rank: int, workdir: str, opts: dict) -> dict:
    """Each run: the data-parallel step on its mesh from the same params
    and global batches as the reference's single-device step; a run may
    write a checkpoint of its pieces after its steps, and ``probe`` its
    computed leaves' shapes and the dimensions it gathers over "model"
    (:func:`_probe`)."""
    out = {}
    for run in opts["runs"]:
        # a planted fault covers the run's set-up too (a layout fault cuts
        # the pieces)
        with _mutated(run.get("mutate")):
            _steps_run(run, workdir, out)
    return out


def _steps_run(run: dict, workdir: str, out: dict) -> None:
    """One run of :func:`case_steps`, its outputs added to ``out``."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.models import moe
    from repro_torch.train import step as tstep
    cfg, tcfg, mesh, psh, osh, params, state, fn = _init_run(run,
                                                             workdir)
    batches = _batches(workdir, run["batches"])[:run["steps"]]
    if tcfg.grad_compression == "int8":
        out.update({f"{run['name']}/{k}": v for k, v in _int8_gap(
            run, cfg, tcfg, mesh, psh, params, batches[0]).items()})
    history = []
    moe.reset_dispatch_counts()
    for i, batch in enumerate(batches):
        with _probe(out, run["name"]) if run.get("probe") \
                else contextlib.nullcontext():
            params, state, m = fn(params, state,
                                  tstep.shard_batch(batch, mesh), i)
        history.append(m)
    counts = moe.dispatch_counts()
    out[f"{run['name']}/dispatches"] = np.asarray(
        [counts["grouped"], counts["a2a"]], np.int64)
    out.update({f"{run['name']}/{k}": v
                for k, v in _metrics_out(history).items()})
    out.update({f"{run['name']}/p/{k}": v
                for k, v in _flat(params).items()})
    out[f"{run['name']}/coord"] = _coord(mesh)
    if run.get("ckpt"):
        mgr = CheckpointManager(os.path.join(workdir, run["ckpt"]),
                                async_write=False)
        mgr.save(len(batches), {"params": params, "opt_state": state},
                 shardings={"params": psh, "opt_state": osh}, mesh=mesh)


def case_elastic(rank: int, workdir: str, opts: dict) -> dict:
    """Restore a checkpoint written on 4 ranks onto this (smaller) mesh,
    then take the next step."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.train import step as tstep
    run = opts["run"]
    cfg, tcfg, mesh, psh, osh, params, state, fn = _init_run(run, workdir)
    mgr = CheckpointManager(os.path.join(workdir, run["ckpt"]))
    step, trees = mgr.restore({"params": params, "opt_state": state},
                              shardings={"params": psh, "opt_state": osh},
                              mesh=mesh)
    params, state = trees["params"], trees["opt_state"]
    out = {"step": np.int64(step), "coord": _coord(mesh)}
    out.update({f"restored/{k}": v for k, v in _flat(params).items()})
    out.update({f"restored_m/{k}": v for k, v in _flat(state["m"]).items()})
    batch = _batches(workdir, run["batches"])[step]
    params, state, m = fn(params, state, tstep.shard_batch(batch, mesh),
                          step)
    out.update(_metrics_out([m]))
    return out


def case_loop(rank: int, workdir: str, opts: dict) -> dict:
    """``train(..., mesh=)`` resuming from a step-0 checkpoint, reporting
    to the test's stack over HTTP."""
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.core import RemoteStack
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.train.loop import train
    cfg = _config(opts)
    tcfg = TrainConfig(**opts["tcfg"])
    mesh = make_mesh_for(device_type="cpu")
    stack = RemoteStack(opts["url"])
    losses = []
    try:
        r = train(cfg, tcfg, ShapeConfig(**opts["shape"]), stack=stack,
                  mesh=mesh, device="cpu", job_id=opts["job_id"],
                  step_callback=lambda s, m: losses.append(float(m["loss"])),
                  **opts["peaks"])
    finally:
        stack.close()
    return {"losses": np.asarray(losses), "resumed_from": np.int64(
        r.resumed_from), "final_step": np.int64(r.final_step),
        "mesh_shape": np.asarray(mesh.shape)}


def case_moe(rank: int, workdir: str, opts: dict) -> dict:
    """apply_moe_a2a and apply_moe(impl="a2a", pc) on a (2, 4) mesh: this
    rank's rows out, and the gradients of sum(y^2) over the global batch
    (this rank's rows' term, summed over "data")."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.params import flatten, unflatten
    from repro_torch.parallel import comm
    from repro_torch.parallel.sharding import PartitionConstraints, \
        TRAIN_RULES
    from repro_torch.train.step import shard_batch
    cfg = _config(opts)
    data = _load(os.path.join(workdir, "moe.npz"))
    mesh = _mesh(("data", "model"), (2, 4))
    x = shard_batch({"x": torch.from_numpy(data["x"])}, mesh)["x"]
    p = unflatten({k[2:]: torch.from_numpy(v) for k, v in data.items()
                   if k.startswith("p/")})
    out = {}
    moe.reset_dispatch_counts()
    leaves = {k: v.clone().requires_grad_() for k, v in flatten(p).items()}
    y, aux = moe.apply_moe_a2a(unflatten(leaves), x, cfg, mesh)
    grads = torch.autograd.grad((y.float() ** 2).sum(),
                                list(leaves.values()))
    for k, g in zip(leaves, grads):
        out[f"grad/{k}"] = comm.all_reduce(g.clone(), mesh, ("data",)
                                           ).numpy()
    out["y"] = y.detach().numpy()
    out["aux_loss"] = np.float64(float(aux["moe_aux_loss"]))
    out["max_load"] = np.float64(float(aux["moe_max_load"]))
    pc = PartitionConstraints(TRAIN_RULES, mesh)
    y2, _ = moe.apply_moe(p, x, dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, impl="a2a")), pc=pc)
    out["y_apply"] = y2.detach().numpy()
    # with a "pod" axis the a2a dispatch does not apply: the grouped one
    # over the pod x data ranks' rows
    pods = _mesh(("pod", "data", "model"), (2, 2, 2))
    xp = shard_batch({"x": torch.from_numpy(data["x"])}, pods)["x"]
    y3, aux3 = moe.apply_moe(p, xp, dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, impl="a2a")),
        pc=PartitionConstraints(TRAIN_RULES, pods))
    out["y_pods"] = y3.detach().numpy()
    out["pods_coord"] = _coord(pods)
    out["pods_max_load"] = np.float64(float(aux3["moe_max_load"]))
    counts = moe.dispatch_counts()
    out["dispatches"] = np.asarray([counts["grouped"], counts["a2a"]])
    return out


def case_analysis(rank: int, workdir: str, opts: dict) -> dict:
    """Each run: one data-parallel step's collectives (or, with
    ``"pipeline"``, one ``pipeline_apply``'s hand-offs and broadcast; with
    ``"pipeline": "grad"``, its backward's too) as
    ``launch.cost_analysis`` counts them on meta copies of this rank's
    pieces and rows, and as the real step's ``comm`` calls report them (a
    counter installed in ``comm`` while the step runs over gloo): operand
    and wire bytes, and operand bytes by kind and by purpose."""
    import torch
    from repro_torch.launch.cost_analysis import (COLLECTIVES, StepCounter,
                                                  analyze_step)
    from repro_torch.configs import TrainConfig
    from repro_torch.models.transformer import init_model_params
    from repro_torch.parallel import comm
    from repro_torch.parallel.sharding import shard_tree
    from repro_torch.train import step as tstep
    out = {}
    for run in opts["runs"]:
        mesh = _mesh(run["names"], run["shape"])
        g = torch.Generator().manual_seed(0)
        if run.get("pipeline"):
            from repro_torch.parallel.pipeline import pipeline_apply

            def fn(ws, x, grad=run["pipeline"] == "grad"):
                if grad:
                    ws, x = ws.detach().requires_grad_(), \
                        x.detach().requires_grad_()
                y = pipeline_apply(lambda w, xb: torch.tanh(xb @ w), ws,
                                   x, mesh=mesh, num_microbatches=4)
                if grad:
                    (y ** 2).sum().backward()
                return y
            args = (torch.randn(4, 8, 8, generator=g),
                    torch.randn(8, 8, generator=g))
        else:
            cfg = _config(run)
            tcfg = TrainConfig(**run["tcfg"])
            psh, _ = tstep.shardings(cfg, tcfg, mesh)
            params = shard_tree(init_model_params(cfg, seed=0, device="cpu"),
                                psh, mesh)
            fn, opt = tstep.make_train_step(cfg, tcfg, mesh=mesh)
            state = opt.init(params, psh)
            toks = torch.randint(1, cfg.vocab_size, (4, 17), generator=g)
            batch = tstep.shard_batch({"tokens": toks[:, :-1],
                                       "labels": toks[:, 1:]}, mesh)
            args = (params, state, batch, 0)
        counted = analyze_step(fn, args)["per_device"]
        sent = StepCounter()
        prev = comm.set_counter(sent)
        try:
            fn(*args)
        finally:
            comm.set_counter(prev)

        def row(d):
            return np.asarray([d.get(k, 0.0) for k in COLLECTIVES])
        out[f"{run['name']}/counted"] = np.asarray(
            [counted["collective_operand_bytes"],
             counted["collective_wire_bytes"]])
        out[f"{run['name']}/sent"] = np.asarray(
            [sent.collective_operand_bytes, sent.collective_wire_bytes])
        out[f"{run['name']}/counted_kinds"] = row(counted["by_collective"])
        out[f"{run['name']}/sent_kinds"] = row(sent.by_collective)
        out[f"{run['name']}/counted_purposes"] = np.asarray(
            json.dumps(counted["by_purpose"], sort_keys=True))
        out[f"{run['name']}/sent_purposes"] = np.asarray(
            json.dumps(sent.by_purpose, sort_keys=True))
    return out


def case_pipeline(rank: int, workdir: str, opts: dict) -> dict:
    """Each run: ``pipeline_apply`` forward and backward on a ("pipe",)
    mesh of the world's ranks, from the test's numpy (the ``.npz`` at
    ``opts["inputs"]``, keys ``<run>/...``), under the run's planted fault (``"mutant"``) or
    none: ``"tanh"`` stages (tanh(x @ w), loss sum(y ** 2)) or a smoke
    config's dense layers (``_train_layers`` on a stage's slice of the
    stacked layers, carried across by ``params_from_numpy``; loss
    sum(y * r)).  Returns the output, this rank's gradient of every stacked
    leaf (its slice's and zeros) and of x, and the forward again under
    ``torch.no_grad`` with whether its output requires grad."""
    import torch
    import torch.distributed as dist
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models.layers import rope_table
    from repro_torch.models.params import flatten, unflatten
    from repro_torch.models.transformer import _train_layers
    from repro_torch.parallel.pipeline import pipeline_apply
    data = _load(opts["inputs"])
    stages = dist.get_world_size()
    mesh = _mesh(("pipe",), (stages,))
    out = {}
    for run in opts["runs"]:
        name = run["name"]
        x = torch.from_numpy(data[f"{name}/x"]).requires_grad_()
        if run["kind"] == "tanh":
            params = {"ws": torch.from_numpy(data[f"{name}/ws"])}

            def stage_fn(p, xb):
                return torch.tanh(xb @ p["ws"])

            def loss(y):
                return (y ** 2).sum()
        else:
            cfg = _config(run)
            key = f"{name}/params/"
            layers = params_from_numpy(
                {k[len(key):]: v for k, v in data.items()
                 if k.startswith(key)}, cfg, device="cpu")["dense_layers"]
            per = cfg.num_layers // stages
            params = {k: v.reshape((stages, per) + tuple(v.shape[1:]))
                      for k, v in flatten(layers).items()}
            rope = rope_table(torch.arange(x.shape[1])[None, :],
                              cfg.head_dim, cfg.rope_theta)
            r = torch.from_numpy(data[f"{name}/r"])

            def stage_fn(p, xb, cfg=cfg, rope=rope, remat=run["remat"]):
                return _train_layers(unflatten(p), xb, cfg,
                                     prefix="dense_layers", rope=rope,
                                     attn_impl="masked", remat=remat)

            def loss(y, r=r):
                return (y * r).sum()
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in params.items()}
        with _mutated(run.get("mutant")):
            y = pipeline_apply(stage_fn, params, x, mesh=mesh,
                               num_microbatches=run["microbatches"])
            loss(y).backward()
        with torch.no_grad():
            y0 = pipeline_apply(stage_fn, params, x, mesh=mesh,
                                num_microbatches=run["microbatches"])
        out[f"{name}/y"] = y.detach().numpy()
        out[f"{name}/dx"] = x.grad.numpy()
        out.update({f"{name}/grad/{k}": v.grad.numpy()
                    for k, v in params.items()})
        out[f"{name}/nograd_y"] = y0.numpy()
        out[f"{name}/nograd_requires_grad"] = np.bool_(y0.requires_grad)
    return out


def case_cli(rank: int, workdir: str, opts: dict) -> dict:
    """The train CLI on every rank of the world (as ``torchrun`` starts
    it: ``WORLD_SIZE`` set, the group already joined here), reporting to
    the test's stack over HTTP: once with ``opts["argv"]``, or once for
    each of ``opts["argvs"]`` in turn (``losses``: each call's step
    losses, a row a call)."""
    import contextlib
    import io
    from repro_torch.launch import train as train_cli
    os.environ["WORLD_SIZE"] = str(opts["world"])
    out = io.StringIO()
    rcs, losses = [], []
    with contextlib.redirect_stdout(out):
        for argv in opts.get("argvs", [opts.get("argv")]):
            losses.append([])
            rcs.append(train_cli.main(argv, step_callback=lambda step, m:
                                      losses[-1].append(float(m["loss"]))))
    rc = max(rcs)
    text = out.getvalue()
    mesh = [ln for ln in text.splitlines() if ln.startswith("mesh: ")]
    job = [ln.split()[1] for ln in text.splitlines()
           if ln.startswith("job: ")]
    return {"rc": np.int64(rc), "mesh": np.asarray(mesh),
            "job": np.asarray(job), "losses": np.asarray(losses)}


def _regions(workdir: str) -> dict:
    """The four tensor-parallel region operations on a (1, 2) mesh: each
    one's output and its input's gradient under this rank's upstream
    weights ``w[rank]`` (``reduce_from_model``: ``w[0]`` on both ranks, the
    one loss it assumes); then on meta operands (shapes only)."""
    import torch
    from repro_torch.parallel import comm
    data = _load(os.path.join(workdir, "regions.npz"))
    mesh = _mesh(("data", "model"), (1, 2))
    r = int(_coord(mesh)[1])
    w = torch.from_numpy(data["w"])
    x_all, parts = torch.from_numpy(data["x"]), torch.from_numpy(
        data["parts"])
    half = x_all.shape[1] // 2
    mine = slice(r * half, (r + 1) * half)
    out = {}
    for name, fn, x, up in (
            ("copy", comm.copy_to_model, x_all, w[r]),
            ("reduce", comm.reduce_from_model, parts[r], w[0]),
            ("gather", comm.gather_seq, x_all[:, mine], w[r]),
            ("scatter", comm.scatter_seq, parts[r], w[r][:, mine])):
        x = x.clone().requires_grad_()
        y = fn(x, mesh)
        (y * up).sum().backward()
        out[f"{name}/y"] = y.detach().numpy()
        out[f"{name}/dx"] = x.grad.numpy()
        meta = fn(torch.empty(x.shape, device="meta"), mesh)
        out[f"{name}/meta_shape"] = np.asarray(meta.shape)
    return out


def _vocab_ce(workdir: str, opts: dict) -> dict:
    """The vocabulary-parallel cross-entropy of this rank's columns of the
    logits on a (1, 2) mesh: the loss and its columns' gradient, with the
    mask and the denominator given, with the mask alone, and with
    neither."""
    import torch
    from repro_torch.models.layers import cross_entropy
    from repro_torch.parallel.sharding import PartitionConstraints, \
        TRAIN_RULES
    data = _load(os.path.join(workdir, "ce.npz"))
    cfg = _config(opts)
    mesh = _mesh(("data", "model"), (1, 2))
    logits = torch.from_numpy(data["logits"])
    tp = PartitionConstraints(TRAIN_RULES, mesh).tensor_parallel(
        cfg, logits.shape[1])
    n = logits.shape[-1] // tp.size
    targets = torch.from_numpy(data["targets"]).long()
    mask = torch.from_numpy(data["mask"])
    out = {"rank": np.int64(tp.rank)}
    for name, kw in (("den", {"mask": mask, "denominator": torch.tensor(
            float(data["denominator"]))}), ("mask", {"mask": mask}),
            ("none", {})):
        local = logits[..., tp.rank * n:(tp.rank + 1) * n].clone() \
            .requires_grad_()
        loss = cross_entropy(local, targets, cfg, tp=tp, **kw)
        out[f"{name}/loss"] = np.float64(float(loss))
        out[f"{name}/grad"] = torch.autograd.grad(loss, local)[0].numpy()
    return out


def _grad_piece(workdir: str) -> dict:
    """``comm.gather_piece`` on a (2, 2) mesh for a leaf split over "data"
    (dim 0) and "model" (dim 1), once in each role: the leaf it returns
    from this rank's piece, and its backward under this rank's upstream
    gradient ``up[rank]`` (cut to the returned leaf's shape) beside
    ``mean_over_data`` of that same gradient."""
    import torch
    import torch.distributed as dist
    from repro_torch.parallel import comm
    from repro_torch.parallel.sharding import ROLES, Sharding, shard_leaf
    from repro_torch.train.step import mean_over_data
    data = _load(os.path.join(workdir, "grad_piece.npz"))
    mesh = _mesh(("data", "model"), (2, 2))
    w = torch.from_numpy(data["w"])
    sh = Sharding(("data", "model"), tuple(w.shape),
                  (("data", 2), ("model", 2)))
    out = {"coord": _coord(mesh)}
    for role in ROLES:
        piece = shard_leaf(w, sh, mesh).requires_grad_()
        y = comm.gather_piece(piece, sh, mesh, role)
        up = torch.from_numpy(data["up"][dist.get_rank()])[:, :y.shape[1]]
        (y * up).sum().backward()
        out[f"{role}/y"] = y.detach().numpy()
        out[f"{role}/grad"] = piece.grad.numpy()
        out[f"{role}/mean_over_data"] = mean_over_data(
            {"w": up}, {"w": sh}, mesh, {"w": role})["w"].numpy()
    return out


def case_tp(rank: int, workdir: str, opts: dict) -> dict:
    """Tensor-parallel compute: the region operations and the
    vocabulary-parallel cross-entropy (with ``regions`` / ``ce``, on a
    world of 2), the gather of a piece in each role (with ``grad_piece``,
    on a world of 4), then the step runs of :func:`case_steps`."""
    out = {}
    if opts.get("regions"):
        out.update(_regions(workdir))
    if opts.get("ce"):
        out.update({f"ce/{k}": v for k, v in _vocab_ce(
            workdir, opts["ce"]).items()})
    if opts.get("grad_piece"):
        out.update({f"gp/{k}": v for k, v in _grad_piece(workdir).items()})
    out.update(case_steps(rank, workdir, opts))
    return out


def case_serve(rank: int, workdir: str, opts: dict) -> dict:
    """Each run: ``make_serve_fns(cfg, pc=)`` on its mesh under its rules,
    from this rank's pieces of the same params (whole ones in
    ``<ref>_params.npz``) and its rows of the same prompts
    (``<ref>_inputs.npz``: ``tokens`` (B, S), the teacher-forced decode
    tokens ``steps`` (B, n), a VLM's ``patches``, ``mrope_pos`` and decode
    positions ``dec_mrope`` (B, n, 3), an encoder-decoder's
    ``src_frames``): one prefill and n decode steps.
    Writes each step's last logits gathered over "model" (this rank's
    rows), the rows it held, its coordinate and its cache piece."""
    import torch
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.parallel.sharding import (
        SERVE_RULES, PartitionConstraints, shard_tree)
    from repro_torch.serve.engine import (
        gather_logits, init_cache_piece, make_serve_fns, serve_shardings)
    from repro_torch.train.step import rows_for
    out = {}
    for run in opts["runs"]:
        name = run["name"]
        cfg = _config(run)
        mesh = _mesh(run["names"], run["shape"])
        inputs = _load(os.path.join(workdir, run["inputs"]))
        b, s = inputs["tokens"].shape
        pc = PartitionConstraints(
            SERVE_RULES.with_overrides(**run.get("rules", {})), mesh,
            batch=b, max_len=run["max_len"])
        psh, _ = serve_shardings(cfg, pc)
        params = shard_tree(params_from_numpy(
            _load(os.path.join(workdir, run["params"])), cfg, device="cpu"),
            psh, mesh)
        rows = rows_for({"i": torch.arange(b)}, pc)["i"]
        take = {k: torch.from_numpy(v)[rows] for k, v in inputs.items()}
        for k in ("tokens", "steps", "mrope_pos", "dec_mrope"):
            if k in take:
                take[k] = take[k].long()
        cache = init_cache_piece(cfg, pc, dtype=torch.float32, device="cpu")
        prefill, decode = make_serve_fns(cfg, pc=pc)
        extras = {k: take[k] for k in ("patches", "mrope_pos", "src_frames")
                  if k in take}
        logits = []
        with _mutated(run.get("mutate")):
            last, cache = prefill(params, take["tokens"], cache, extras)
            logits.append(gather_logits(cfg, last, pc))
            for i in range(take["steps"].shape[1]):
                ex = ({"mrope_pos": take["dec_mrope"][:, i:i + 1]}
                      if "dec_mrope" in take else None)
                last, cache = decode(params, cache,
                                     take["steps"][:, i:i + 1], s + i, ex)
                logits.append(gather_logits(cfg, last, pc))
        out[f"{name}/logits"] = torch.stack(logits).float().numpy()
        out[f"{name}/rows"] = rows.numpy()
        out[f"{name}/coord"] = _coord(mesh)
        out.update({f"{name}/c/{k}": v for k, v in _flat(cache).items()})
    return out


def case_layout(rank: int, workdir: str, opts: dict) -> dict:
    """Mamba2's segmented leaves on a (1, world) mesh: this rank's pieces
    of the params (``layout_params.npz``) and of the serving cache
    (``layout_cache.npz``, under ``SERVE_RULES``), the leaves
    ``gather_tree`` puts back together from them, and the pieces a
    checkpoint saved from them restores (written by the mesh's origin,
    read by every rank after a barrier)."""
    import torch
    import torch.distributed as dist
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models.params import unflatten
    from repro_torch.models.transformer import model_specs
    from repro_torch.parallel.sharding import (
        SERVE_RULES, TRAIN_RULES, cache_shardings, gather_tree,
        shard_tree, shardings_for_specs)
    cfg = _config(opts)
    mesh = _mesh(("data", "model"), (1, dist.get_world_size()))
    psh = shardings_for_specs(model_specs(cfg), TRAIN_RULES, mesh)
    whole = params_from_numpy(_load(os.path.join(workdir,
                                                 "layout_params.npz")),
                              cfg, device="cpu")
    pieces = shard_tree(whole, psh, mesh)
    cache = _load(os.path.join(workdir, "layout_cache.npz"))
    b, length = opts["cache"]
    csh = cache_shardings(cfg, SERVE_RULES, mesh, b, length)
    cwhole = unflatten({k: torch.from_numpy(v) for k, v in cache.items()})
    cpieces = shard_tree(cwhole, csh, mesh)
    out = {"coord": _coord(mesh)}
    out.update({f"piece/{k}": v for k, v in _flat(pieces).items()})
    out.update({f"cpiece/{k}": v for k, v in _flat(cpieces).items()})
    out.update({f"gathered/{k}": v for k, v in _flat(
        gather_tree(pieces, psh, mesh)).items()})
    out.update({f"cgathered/{k}": v for k, v in _flat(
        gather_tree(cpieces, csh, mesh)).items()})
    mgr = CheckpointManager(os.path.join(workdir, f"layout_ckpt_"
                                         f"{dist.get_world_size()}"),
                            async_write=False)
    mgr.save(0, {"params": pieces}, shardings={"params": psh}, mesh=mesh)
    dist.barrier()
    _, trees = mgr.restore({"params": pieces}, shardings={"params": psh},
                           mesh=mesh)
    out.update({f"restored/{k}": v for k, v in _flat(
        trees["params"]).items()})
    return out


@contextlib.contextmanager
def _issue_log(log: list):
    """Appends each collective the step runs to ``log`` in the order its
    thread issues it: [its process group's ranks, whether it runs in
    flight, kind, purpose, output dtype, output bytes], by wrapping
    ``comm._run``, which every collective of the port passes."""
    import threading
    import torch.distributed as dist
    from repro_torch.parallel import comm
    run, lock = comm._run, threading.Lock()

    def logged(fn, group, out, inp=None, **kw):
        with lock:
            log.append([dist.get_process_group_ranks(group),
                        getattr(comm._local, "groups", None) is not None,
                        fn.__name__, comm._purpose() or "other",
                        str(out.dtype).split(".")[-1],
                        out.numel() * out.element_size()])
        return run(fn, group, out, inp, **kw)
    with _patched(comm, "_run", logged):
        yield


def _group_log(log: list):
    """``_issue_log``'s rows as JSON strings."""
    return np.asarray([json.dumps(r) for r in log] or [""])


def case_overlap(rank: int, workdir: str, opts: dict) -> dict:
    """Each run: the step without and with its exchanges overlapped
    (``make_train_step(..., overlap=)``) from the same params and batches,
    under the run's planted fault (``"mutate"``, the overlapped step only)
    or none: each step's metrics, the pieces after the steps, the
    collectives as issued (:func:`_issue_log`), the count of those run in
    flight by purpose and whether any worker thread, side stream or
    overlap group was made; a run with ``"wire": false`` takes the step
    without the bf16 gathers too (``sharding.wire_dtypes`` empty)."""
    import threading
    import torch.distributed as dist
    from repro_torch.models.params import flatten
    from repro_torch.parallel import comm
    from repro_torch.train import step as tstep
    out = {}
    for run in opts["runs"]:
        name = run["name"]
        variants = [("off", False, None), ("on", True, run.get("mutate"))]
        if run.get("wire") is False:
            variants.append(("nowire", False, None))
        for tag, overlap, mutate in variants:
            threads = threading.active_count()
            comm.reset_staged()
            log = []
            with _mutated(mutate), _issue_log(log), (
                    _patched(tstep, "wire_dtypes", lambda cfg: {})
                    if tag == "nowire" else contextlib.nullcontext()):
                cfg, tcfg, mesh, psh, osh, params, state, fn = _init_run(
                    {**run, "overlap": overlap}, workdir)
                batches = _batches(workdir, run["batches"])[:run["steps"]]
                history = []
                for i, batch in enumerate(batches):
                    params, state, m = fn(params, state,
                                          tstep.shard_batch(batch, mesh), i)
                    history.append(m)
            key = f"{name}/{tag}"
            out.update({f"{key}/{k}": v
                        for k, v in _metrics_out(history).items()})
            out.update({f"{key}/p/{k}": v for k, v in _flat(params).items()})
            out[f"{key}/log"] = _group_log(log)
            out[f"{key}/overlapped"] = np.asarray(json.dumps(
                comm.overlapped(), sort_keys=True))
            out[f"{key}/new_threads"] = np.int64(
                threading.active_count() - threads)
            out[f"{key}/groups"] = np.asarray(json.dumps(
                {a: dist.get_process_group_ranks(mesh.get_group(a))
                 for a in mesh.mesh_dim_names}, sort_keys=True))
        out[f"{name}/coord"] = _coord(mesh)
        if run.get("one_device"):
            out.update(_one_device_run(run, workdir, f"{name}/one"))
    out["started"] = np.bool_(comm.overlap_started())
    if "cli" in opts:
        out.update(_cli_reaches_train(opts["cli"]))
    return out


def _one_device_run(run: dict, workdir: str, key: str) -> dict:
    """The run's steps on one device (no mesh): its metrics and params."""
    from repro_torch.configs import TrainConfig
    from repro_torch.models.transformer import init_model_params
    from repro_torch.train import step as tstep
    cfg, tcfg = _config(run), TrainConfig(**run["tcfg"])
    params = init_model_params(cfg, seed=0, device="cpu")
    fn, opt = tstep.make_train_step(cfg, tcfg)
    state, history = opt.init(params), []
    for i, batch in enumerate(_batches(workdir, run["batches"])[
            :run["steps"]]):
        params, state, m = fn(params, state, batch, i)
        history.append(m)
    out = {f"{key}/{k}": v for k, v in _metrics_out(history).items()}
    out.update({f"{key}/p/{k}": v for k, v in _flat(params).items()})
    return out


def _cli_reaches_train(argv: list) -> dict:
    """The train CLI on every rank of the world with ``argv``, its
    ``train`` and stack stubbed: the keywords ``train`` was called with
    (``overlap``, whether it got a mesh) and the CLI's output."""
    import io
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

    class Result:
        steps_run, last_loss, resumed_from, findings = 0, 0.0, None, []

    def train(cfg, tcfg, shape, **kw):
        got.update(overlap=kw["overlap"], mesh=kw["mesh"] is not None)
        return Result()
    import torch.distributed as dist
    os.environ["WORLD_SIZE"] = str(dist.get_world_size())
    text = io.StringIO()
    with _patched(train_cli, "train", train), \
            _patched(train_cli, "RemoteStack", Stack), \
            contextlib.redirect_stdout(text):
        rc = train_cli.main(argv)
    return {"cli/rc": np.int64(rc), "cli/overlap": np.bool_(got["overlap"]),
            "cli/mesh": np.bool_(got["mesh"]),
            "cli/out": np.asarray(text.getvalue())}


CASES = {"collectives": case_collectives, "steps": case_steps,
         "elastic": case_elastic, "loop": case_loop, "moe": case_moe,
         "analysis": case_analysis, "cli": case_cli, "tp": case_tp,
         "serve": case_serve, "layout": case_layout,
         "pipeline": case_pipeline, "overlap": case_overlap}
