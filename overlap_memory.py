#!/usr/bin/env python3
"""Where the FSDP world's step holds its memory, on the card and in its
count: ``chip_smoke.py`` phase 6 (e)'s granite world (2 of 40 layers, bf16,
(data 2, model 1), 2 microbatches, seq 2048 x batch 4), one step without
and one with its exchanges overlapped.

Run from the root of a checkout on a machine with a CUDA card::

    python3 overlap_memory.py

It builds the kernels, starts two processes of itself sharing the card
over gloo (as phase 6 (e) does), and in each traces the step on meta
tensors (``launch.cost_analysis.StepCounter``) and then runs it on the
card, with probes around ``sharding.LayerGathers.issue`` / ``wait``,
``sharding.Pieces.gather`` and ``comm.GradSink.start`` / ``collect``: at
each, the counter's live bytes and the most since the probe before, beside
the card's ``memory_allocated`` and ``max_memory_allocated`` (reset at each
probe).  The probes fire in the same order in both.  Prints, for each
step, both peaks and where each sits, then the probes whose peak lies
within 10% of the larger; rank 0's rows go to
``chiprun_out/overlap_memory.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import chip_smoke as cs  # also puts the checkout's src/ on sys.path

WORKDIR = os.path.join(cs.ROOT, "build", "overlap_memory")


def rank_main(rank: int) -> None:
    """One rank: the step without and with overlap, each traced then run,
    probed; writes its rows to ``WORKDIR/rank<R>.json``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.cost_analysis import StepCounter, meta_like
    from repro_torch.parallel import comm, sharding
    from repro_torch.parallel.sharding import (PartitionConstraints,
                                               TRAIN_RULES)
    from repro_torch.train.step import (make_train_step, shard_batch,
                                        shardings)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    cs.kbuild.load_library()
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(WORKDIR, "store"), 2), rank=rank, world_size=2)
    mesh = cs.make_mesh_for(2, model=1, device_type="cpu")
    case = cs.TP_CASES["granite-fsdp"]
    cfg, tcfg = cs.tp_cfg(case), cs.tp_train_cfg(case)
    batch = shard_batch(cs.dist_batches(cfg, case.shape, 1, "cuda")[0],
                        mesh)
    pc = PartitionConstraints(TRAIN_RULES, mesh)
    psh, _ = shardings(cfg, tcfg, mesh, pc)
    counter = {"on": None}
    probes: list = []

    def probe(label: str) -> None:
        c = counter["on"]
        if c is not None:
            probes.append((label, c.live, c.peak))
            c.peak = c.live
            return
        torch.cuda.synchronize()
        probes.append((label, torch.cuda.memory_allocated(),
                       torch.cuda.max_memory_allocated()))
        torch.cuda.reset_peak_memory_stats()

    def probed(obj, name: str):
        fn = getattr(obj, name)

        def wrapper(*a, **k):
            probe(f"{name}<")
            out = fn(*a, **k)
            probe(f"{name}>")
            return out
        setattr(obj, name, wrapper)
        return obj, name, fn
    kept = [probed(sharding.LayerGathers, "issue"),
            probed(sharding.LayerGathers, "wait"),
            probed(sharding.Pieces, "gather"),
            probed(comm.GradSink, "start"),
            probed(comm.GradSink, "collect")]
    out = {}
    try:
        for overlap in (False, True):
            step, opt = make_train_step(cfg, tcfg, mesh=mesh, pc=pc,
                                        overlap=overlap)
            params = cs.init_pieces(cfg, psh, mesh, "cuda")
            state = opt.init(params, psh)
            rows = {}
            for kind in ("count", "card"):
                probes.clear()
                if kind == "count":
                    args = meta_like((params, state, batch, 0))
                    counter["on"] = StepCounter()
                    with counter["on"].counting(args):
                        step(*args)
                    probe("end")
                    counter["on"] = None
                else:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    step(params, state, batch, 0)
                    probe("end")
                rows[kind] = list(probes)
            out["overlap" if overlap else "plain"] = rows
            del params, state
            cs.free_device("cuda")
    finally:
        for obj, name, fn in kept:
            setattr(obj, name, fn)
        dist.destroy_process_group()
    with open(os.path.join(WORKDIR, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def report(out: dict) -> None:
    for step, rows in out.items():
        peaks = {k: max(rows[k], key=lambda r: r[2]) for k in rows}
        print(f"{step}: " + ", ".join(
            f"{k} peak {r[2] / 1e9:.3f} GB at {r[0]}"
            for k, r in peaks.items()))
        top = max(r[2] for r in peaks.values())
        for i, (c, d) in enumerate(zip(rows["count"], rows["card"])):
            if max(c[2], d[2]) >= 0.9 * top:
                print(f"  probe {i:4d} {c[0]:9s} count live {c[1] / 1e9:.3f}"
                      f" most {c[2] / 1e9:.3f} | card live {d[1] / 1e9:.3f}"
                      f" most {d[2] / 1e9:.3f}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("overlap_memory: CUDA is not available", file=sys.stderr)
        return 1
    cs.kbuild.build()
    cs.log(f"gpu: {cs.gpu_line()}")
    os.makedirs(WORKDIR, exist_ok=True)
    for f in os.listdir(WORKDIR):
        os.remove(os.path.join(WORKDIR, f))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--rank", str(r)]) for r in range(2)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(rcs):
        print(f"overlap_memory: ranks exited {rcs}", file=sys.stderr)
        return 1
    with open(os.path.join(WORKDIR, "rank0.json")) as f:
        out = json.load(f)
    os.makedirs(os.path.join(cs.ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(cs.ROOT, "chiprun_out", "overlap_memory.json"),
              "w") as f:
        json.dump(out, f)
    report(out)
    return 0


if __name__ == "__main__":
    if "--rank" in sys.argv:
        rank_main(int(sys.argv[sys.argv.index("--rank") + 1]))
        sys.exit(0)
    sys.exit(main())
