"""Counted peaks of a world of ``chip_smoke.py`` phase 6 (e), on meta
tensors: the one-device step's and rank 0's, at each shape asked.

A world: ``--model`` at full width, cut to ``--layers`` (an
encoder-decoder's encoder and decoder both), in ``--dtype`` (default: the
config's), trained by ``--optimizer`` under remat "minimal" in
``--microbatches`` on a (data, model) ``--mesh``, with ``--sp`` sequence
parallelism and, with ``--overlap``, its exchanges overlapped (the FSDP
world's ``dist:fsdp-overlap`` run).  For each ``--shape SEQxBATCH`` the
script lays a (1, 1) mesh and then the world's mesh out on a fake process
group and traces the step
once on each (``launch.steps.build_train_bundle`` + ``trace_bundle``):
nothing is computed and no device is touched.  A (1, 1) mesh's step is the
one-device step (every size-1 axis exchanges nothing).  It imports neither
``chip_smoke`` nor JAX, so it counts whichever tree's ``repro_torch`` is on
``PYTHONPATH``: an older checkout gives the count of the same world under
its step.  Prints one JSON line a shape, with rank 0's collective operand
bytes by purpose.

Usage (the deepseek tensor-parallel world's shapes; the FSDP world)::

    PYTHONPATH=src python world_count.py --model deepseek-v2-236b \\
        --dtype float32 --optimizer adafactor --sp \\
        --shape 2048x4 --shape 2048x2 --shape 1024x4
    PYTHONPATH=src python world_count.py --model granite-3-8b \\
        --mesh 2,1 --microbatches 2 [--overlap]

The recurrent tensor-parallel worlds (zamba2's Mamba2 layers and shared
blocks, rwkv6's time and channel mix), at the depths ``chip_smoke.py``
weighs against 75 GB::

    PYTHONPATH=src python world_count.py --model zamba2-7b --layers 13 \\
        --dtype float32 --sp
    PYTHONPATH=src python world_count.py --model rwkv6-1.6b --layers 24 \\
        --dtype float32 --sp
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import ShapeConfig, TrainConfig, get_config
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.steps import build_train_bundle, trace_bundle


def count(cfg, shape, tcfg, mesh_shape, overlap: bool = False) -> dict:
    with fake_world(mesh_shape[0] * mesh_shape[1]):
        mesh = init_device_mesh("cpu", mesh_shape,
                                mesh_dim_names=("data", "model"))
        r = trace_bundle(build_train_bundle(cfg, shape, tcfg, mesh,
                                            overlap=overlap))
    return {"peak_gb": r["memory"]["peak_bytes"] / 1e9,
            "argument_gb": r["memory"]["argument_bytes"] / 1e9,
            "collective_operand_gb_by_purpose": {
                k: v / 1e9 for k, v in
                sorted(r["per_device"]["by_purpose"].items())}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--mesh", default="1,2")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--overlap", action="store_true",
                    help="the step with its exchanges overlapped (the "
                         "layer gathered ahead counts in rank 0's peak)")
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(get_config(args.model), num_layers=args.layers)
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, num_encoder_layers=args.layers)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    tcfg = TrainConfig(warmup_steps=0, total_steps=3, learning_rate=1e-3,
                       remat_policy="minimal", optimizer=args.optimizer,
                       num_microbatches=args.microbatches,
                       seq_parallel=args.sp)
    mesh = tuple(int(n) for n in args.mesh.split(","))
    for text in args.shape or ["2048x4"]:
        seq, batch = (int(n) for n in text.split("x"))
        shape = ShapeConfig(f"tp_{text}", seq_len=seq, global_batch=batch,
                            kind="train")
        print(json.dumps({
            "model": args.model, "layers": args.layers, "dtype": cfg.dtype,
            "shape": text, "mesh": mesh, "microbatches": args.microbatches,
            "sp": args.sp, "overlap": args.overlap,
            "one_device": count(cfg, shape, tcfg, (1, 1)),
            "rank0": count(cfg, shape, tcfg, mesh, args.overlap)}),
            flush=True)


if __name__ == "__main__":
    main()
