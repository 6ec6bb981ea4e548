"""Counted peak of rank 0 of ``chip_smoke.py``'s FSDP world, on meta tensors.

The world: granite-3-8b at full width, 2 of its 40 layers (fp32 params,
bf16 compute), on a (data 2, model 1) mesh, 4 rows of 2048 tokens (2 a
rank) in 2 microbatches, remat "minimal", AdamW.  This script lays the mesh
out on a fake process group of 2 ranks and traces rank 0's step once on
meta tensors (``launch.steps.build_train_bundle`` + ``trace_bundle``):
nothing is computed and no device is touched.  It stands alone (it imports
neither ``chip_smoke`` nor JAX), so it traces whichever tree's
``repro_torch`` is on ``PYTHONPATH``: an older checkout gives the count of
the same world under its step.

Usage::

    PYTHONPATH=src python fsdp_world_count.py
"""

from __future__ import annotations

import dataclasses
import json

from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import ShapeConfig, TrainConfig, get_config
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.steps import build_train_bundle, trace_bundle

LAYERS, MESH, MICROBATCHES = 2, (2, 1), 2
SHAPE = ShapeConfig("tp_2k_b4", seq_len=2048, global_batch=4, kind="train")


def main() -> None:
    cfg = dataclasses.replace(get_config("granite-3-8b"), num_layers=LAYERS)
    tcfg = TrainConfig(warmup_steps=0, total_steps=3, learning_rate=1e-3,
                       remat_policy="minimal", optimizer="adamw",
                       num_microbatches=MICROBATCHES)
    with fake_world(MESH[0] * MESH[1]):
        mesh = init_device_mesh("cpu", MESH,
                                mesh_dim_names=("data", "model"))
        r = trace_bundle(build_train_bundle(cfg, SHAPE, tcfg, mesh))
    mem, per = r["memory"], r["per_device"]
    print(json.dumps({
        "peak_gb": mem["peak_bytes"] / 1e9,
        "argument_gb": mem["argument_bytes"] / 1e9,
        "collective_operand_gb_by_purpose": {
            k: v / 1e9 for k, v in sorted(per["by_purpose"].items())}}))


if __name__ == "__main__":
    main()
