"""Dry run over the production meshes: trace every (arch x shape x mesh)
cell without a card (port of ``repro.launch.dryrun``).

For each cell the dry run:

1. lays the production mesh out (16 x 16 single-pod / 2 x 16 x 16
   multi-pod) on a "fake" process group of 256 or 512 ranks in this one
   process (:func:`repro_torch.launch.mesh.fake_world`), as rank 0;
2. builds the cell's bundle (:mod:`repro_torch.launch.steps`): the
   arguments as rank 0's pieces under the logical-axis rules;
3. traces the step once on meta tensors
   (:func:`~repro_torch.launch.steps.trace_bundle`), which counts rank 0's
   flops, bytes, collectives and peak memory; nothing is computed and no
   device is touched (each record says so: ``device``);
4. writes ``<out>/<mesh>/<arch>__<shape>.json`` with the reference's keys
   (``status``, ``memory_per_device``, ``hlo_analysis``, ``roofline``) and
   the port's: ``device``, ``peaks`` (the H100's data sheet, which the
   roofline terms are reckoned against), ``fits_80gb``, and for a train
   cell ``tp_compute``: ``"sharded"`` where the step computes
   tensor-parallel under "model" (``sharding.tp_roles``: some leaf
   ``"split"``), else ``"whole"``, with ``tp_whole_leaves``, the leaves
   stored split over "model" that each rank still gathers and computes
   whole (a MoE router whose experts bind "model"; a recurrent mixer's
   leaves where its heads or parts do not divide).

A prefill or decode cell serves on the mesh (``make_serve_fns`` with the
mesh, ``SERVE_RULES``) and its record adds ``serve``: the cache layout
(``"heads"``, ``"seq"`` or ``"whole"``), whether the rows split or are
replicated and how many a rank takes, ``tp_compute``, the reference's
decode ``cache_update`` (``"dus"`` / ``"onehot"``), a rank's params and
cache bytes and the collectives' bytes by purpose; ``fits_note`` says why
a cell over 80 GB does not fit.  The ``long_500k`` cells of the quadratic
archs are ``skipped`` with the reference's reason.

Usage::

    python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --mesh both --skip-existing
    python -m repro_torch.launch.dryrun --shape train_4k --overlap --out DIR
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from contextlib import contextmanager

import torch.distributed as dist

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, TrainConfig,
                                 get_config, supports_shape)
from repro_torch.core.analysis import RooflineAnalyzer
from repro_torch.launch import cost_analysis
from repro_torch.launch.mesh import (PRODUCTION_SHAPES, fake_world,
                                     make_production_mesh)
from repro_torch.launch.steps import build_bundle, trace_bundle
from repro_torch.models.params import flatten
from repro_torch.models.transformer import model_specs
from repro_torch.parallel.sharding import (TRAIN_RULES, binds_model,
                                          tp_roles)
from repro_torch.train.loop import DEVICE_PEAKS

CARD = "H100"
CARD_BYTES = 80e9               # the card's 80 GB, the fits_80gb line
OUT = "results/dryrun_torch"


def default_train_cfg(cfg, shape=None, dp: int = 16) -> TrainConfig:
    """The reference's production defaults by model size: microbatch count
    and remat policy so saved activations fit beside the (sharded)
    optimizer state; giants drop to factored Adafactor without a first
    moment.  ``nm`` is capped so every microbatch still spans the whole
    data-parallel axis (global_batch / nm >= dp)."""
    n = cfg.param_count()
    if n > 100e9:
        tc = TrainConfig(optimizer="adafactor", beta1=0.0,
                         num_microbatches=32, remat_policy="minimal")
    elif n > 5e9:
        tc = TrainConfig(optimizer="adamw", num_microbatches=16,
                         remat_policy="minimal")
    else:
        tc = TrainConfig(optimizer="adamw", num_microbatches=1,
                         remat_policy="minimal")
    if shape is not None:
        max_nm = max(1, shape.global_batch // max(dp, 1))
        while tc.num_microbatches > max_nm or \
                shape.global_batch % tc.num_microbatches:
            tc.num_microbatches //= 2
        tc.num_microbatches = max(1, tc.num_microbatches)
    return tc


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active
    params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # one new token per row


def peaks(card: str = CARD) -> dict:
    """The card's data-sheet rates the roofline terms are reckoned
    against."""
    pf, bw, ici = DEVICE_PEAKS[card]
    return {"card": card, "peak_flops": pf, "hbm_bw": bw, "ici_bw": ici,
            "source": "NVIDIA H100 SXM data sheet (dense bf16, HBM3, "
                      "NVLink one direction)"}


def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def tp_compute(cfg, mesh) -> dict:
    """How a train cell's step computes under "model": ``tp_compute``
    (``"sharded"`` or ``"whole"``) and ``tp_whole_leaves``, the leaves
    stored split over "model" that every rank gathers and computes whole
    (see the module docstring)."""
    roles = tp_roles(cfg, TRAIN_RULES, mesh)
    specs = flatten(model_specs(cfg))
    return {"tp_compute": "sharded" if "split" in roles.values()
            else "whole",
            "tp_whole_leaves": sorted(
                k for k, r in roles.items()
                if r == "whole" and binds_model(specs[k], TRAIN_RULES,
                                                mesh))}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str = OUT,
             skip_existing: bool = False, cfg=None,
             overlap: bool = False) -> dict:
    """One cell's record, written to ``<out_dir>/<mesh>/<arch>__<shape>.
    json``.  ``cfg``: a config to use in place of ``get_config(arch)``
    (a smoke config, in tests).  ``overlap``: a train cell's step with its
    exchanges overlapped (the record says ``"overlap": true``).  Opens a
    fake world of the mesh's size unless one of that size is already
    open."""
    mesh_name = _mesh_name(multi_pod)
    os.makedirs(os.path.join(out_dir, mesh_name), exist_ok=True)
    path = os.path.join(out_dir, mesh_name, f"{arch}__{shape_name}.json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            return json.load(f)

    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "kind": shape.kind, "status": "ok", "time_s": None,
              "device": cost_analysis.DEVICE, "peaks": peaks()}

    if not supports_shape(cfg, shape):
        record["status"] = "skipped"
        record["reason"] = ("full-attention arch at 524288-token decode is "
                            "not deployable (O(S^2)); see DESIGN.md §5")
        _write(path, record)
        return record

    t0 = time.monotonic()
    try:
        with _world(math.prod(PRODUCTION_SHAPES[multi_pod][0])):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            chips = mesh.size()
            dp = chips // mesh.shape[-1]          # pod x data
            tcfg = default_train_cfg(cfg, shape, dp)
            bundle = build_bundle(cfg, shape, mesh, train_cfg=tcfg,
                                  overlap=overlap)
            if bundle.status != "ok":
                record["status"] = bundle.status
                record["reason"] = bundle.reason
            else:
                if shape.kind == "train":
                    record["train_cfg"] = {
                        "optimizer": tcfg.optimizer,
                        "num_microbatches": tcfg.num_microbatches,
                        "remat_policy": tcfg.remat_policy}
                    record["overlap"] = overlap
                    record.update(tp_compute(cfg, mesh))
                hlo = trace_bundle(bundle)
                _fill(record, hlo, cfg, shape, arch, shape_name, mesh_name,
                      chips)
                if bundle.serve is not None:
                    record["serve"] = {
                        **bundle.serve,
                        "params_bytes": hlo["memory"]["params_bytes"],
                        "cache_bytes": hlo["memory"]["cache_bytes"],
                        "collective_bytes_by_purpose":
                            hlo["per_device"]["by_purpose"]}
                if not record["fits_80gb"]:
                    record["fits_note"] = _fits_note(cfg, bundle)
    except Exception as e:                                # noqa: BLE001
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["time_s"] = round(time.monotonic() - t0, 1)
    _write(path, record)
    return record


def _fits_note(cfg, bundle) -> str:
    """Why a cell's count is over 80 GB a rank, as far as the layout says."""
    if bundle.kind == "train":
        return ("the count's peak: a rank's pieces of the params, optimizer "
                "state, gradient accumulator and a microbatch's gradients, "
                "one layer's leaves gathered at a time (a split leaf as its "
                "\"model\" piece; the leaves outside the checkpoints for "
                "the whole pass: the embedding, an enc-dec's cross K/V "
                "projections) and a microbatch's activations, split over "
                "\"model\" by heads, columns and experts (MLA's latent "
                "projections whole)")
    return ("the count's peak: a rank's pieces of the params with one "
            "layer's gathered at a time, its cache piece (its KV heads, or "
            "its slots: MLA's latent) and its activations")


@contextmanager
def _world(n: int):
    """fake_world(n) unless a world of n ranks is already open."""
    if dist.is_initialized() and dist.get_world_size() == n:
        yield
        return
    with fake_world(n):
        yield


def _fill(record, hlo, cfg, shape, arch, shape_name, mesh_name, chips):
    mem = hlo["memory"]
    record["memory_per_device"] = {
        k: mem[k] for k in ("argument_bytes", "output_bytes", "temp_bytes",
                            "alias_bytes", "peak_bytes", "held_bytes")}
    record["fits_80gb"] = mem["peak_bytes"] <= CARD_BYTES
    record["hlo_analysis"] = hlo
    model_flops = model_flops_for(cfg, shape)
    p = record["peaks"]
    roof = RooflineAnalyzer(p["peak_flops"], p["hbm_bw"], p["ici_bw"]
                            ).analyze(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=hlo["global"]["flops"],
        hbm_bytes=hlo["global"]["bytes_fused"],
        collective_bytes=hlo["global"]["collective_wire_bytes"],
        model_flops=model_flops)
    record["roofline"] = {
        "chips": chips,
        "compute_s": roof.compute_s,
        "memory_s": roof.memory_s,
        "collective_s": roof.collective_s,
        "dominant": roof.dominant,
        "bound_step_s": roof.bound_s,
        "model_flops": model_flops,
        "hlo_flops": roof.hlo_flops,
        "useful_flop_ratio": roof.useful_flop_ratio,
        "collective_operand_bytes_global":
            hlo["global"]["collective_operand_bytes"],
        "classification": roof.classify(),
    }


def _write(path: str, record: dict):
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)


def summary(r: dict) -> str:
    """One line of a record: status, dominant term, bound s, GB a rank,
    whether it fits, how "model" computes, the cache layout, the cell's
    seconds."""
    roof = r.get("roofline", {})
    mem = r.get("memory_per_device", {})
    serve = r.get("serve", {})
    gb = mem.get("peak_bytes", 0) / 1e9 if mem else float("nan")
    return (f"[{r['status']:8s}] {r['mesh']:10s} {r['arch']:24s} "
            f"{r['shape']:12s} dominant={roof.get('dominant', '-'):10s} "
            f"bound_s={roof.get('bound_step_s', float('nan')):.4g} "
            f"gb_per_rank={gb:.4g} fits_80gb={r.get('fits_80gb', '-')} "
            f"tp={r.get('tp_compute', serve.get('tp_compute', '-'))} "
            f"cache={serve.get('cache_layout', '-')} t={r.get('time_s')}s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro-torch-dryrun")
    ap.add_argument("--arch", action="append", default=None,
                    help="architecture id(s); default: all assigned")
    ap.add_argument("--shape", action="append", default=None,
                    help="shape name(s); default: all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--overlap", action="store_true",
                    help="train cells: the step with its exchanges "
                         "overlapped (the train CLI's --overlap-flags)")
    args = ap.parse_args(argv)

    archs = args.arch or ASSIGNED_ARCHS
    shapes = args.shape or list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = 0
    for multi in meshes:
        with _world(math.prod(PRODUCTION_SHAPES[multi][0])):
            for arch in archs:
                for shape in shapes:
                    r = run_cell(arch, shape, multi, args.out,
                                 args.skip_existing, overlap=args.overlap)
                    print(summary(r), flush=True)
                    if r["status"] == "error":
                        failures += 1
                        print(r["error"][:500], flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
