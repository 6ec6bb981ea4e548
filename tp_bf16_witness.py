"""Why phase 6 (e)'s bf16 qwen2-vl world misses its one-device step past
step 0: bf16's own spread, set beside the world's gap, at phase 6 (e)'s
shape (qwen2-vl-7b, 4 of 28 layers, full width, seq 2048 x batch 4,
AdamW, the loop's stub patches and positions, ``DIST_STEPS`` steps from
the seed's params).

Four runs on the same params and batches:

* ``fp32``: the one-device step in fp32 (the exact trajectory, as near as
  the card gets);
* ``bf16``: the one-device step in the config's bf16, through the kernels;
* ``bf16-plain``: the same with the plain versions swapped in (another
  rounding of the same function on one device);
* ``bf16-tp``: ``chip_smoke.py``'s ``qwen2-vl-bf16`` run, in a world of
  its own of two processes sharing the card over gloo with sequence
  parallelism (rank 0's row);
* ``bf16-split``: the one-device bf16 step with a perturbation of the
  world's kind (:class:`SplitRowParallel`): each row-parallel product
  (attention's ``wo``, the MLP's ``w_down``) computed as two half-K
  products, each rounded to bf16, then summed in bf16, as the world's two
  ranks' partial sums are (without remat: the split's extra products do
  not line up with the selective checkpoint's saved outputs).

``fp32``, ``bf16`` and ``bf16-split`` also run from a second seed
(``SEEDS``: params and batches), which shows how far bf16 alone spreads on
another trajectory.  If ``bf16-split`` stands as far from ``fp32`` as the
world does at step 1 (its grad norm 2.1e-2 from fp32 on an H100), the
world's miss is that rounding, by design; if not, it is the world's own.

For each pair, each step's relative gaps in loss, grad norm and param
norm, and step 0's gradient gap (the largest ||g - g_ref|| / ||g_ref||
over the leaves).  If the world's gap from ``bf16`` is of the size of
``bf16-plain``'s, and the world is no farther from ``fp32`` than ``bf16``
is, its miss is bf16's spread on a trajectory that amplifies it; if the
world stands clearly farther from ``fp32``, the miss is the world's own.

Run from the repository root on a machine with one H100:
``python3 tp_bf16_witness.py``; prints one ``witness:`` JSON line and
writes it to ``chiprun_out/tp_bf16_witness.json``.
"""

import dataclasses
import json
import os
import sys
import time
import weakref
from contextlib import nullcontext

import torch
from torch.overrides import TorchFunctionMode

import chip_smoke as cs

CASE = "qwen2-vl-bf16"
SEEDS = (0, 1)
ROW_PARALLEL = ("/attn/wo", "/mlp/w_down")
_MATMULS = (torch.Tensor.__matmul__, torch.matmul, torch.Tensor.matmul)


class SplitRowParallel(TorchFunctionMode):
    """Each product with a row-parallel weight (``ROW_PARALLEL``: a layer
    of a stacked leaf, or its cast or reshaped copy, on the right of a
    bf16 ``@``) computed as two half-K products, each rounded to bf16,
    summed in bf16: the two ranks' partial sums of the tensor-parallel
    world, on one device.  The leaves are found by their layers' storage
    addresses (the params live through the step); what is made from them
    by identity (weak references)."""

    def __init__(self, params: dict):
        super().__init__()
        self.layers = {leaf[i].data_ptr()
                       for k, leaf in cs.flatten(params).items()
                       if k.endswith(ROW_PARALLEL)
                       for i in range(leaf.shape[0])}
        self.made: dict = {}              # id -> weak reference
        self.split = 0

    def _row(self, t) -> bool:
        if not isinstance(t, torch.Tensor):
            return False
        ref = self.made.get(id(t))
        return (ref is not None and ref() is t) or (
            t.dim() >= 2 and t.data_ptr() in self.layers)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _MATMULS and len(args) == 2 and self._row(args[1]) \
                and args[0].dtype == torch.bfloat16:
            x, w = args
            k, n = w.shape[0] // 2, w.shape[1]
            self.split += 1
            # one batched product of the two halves (each rounded to bf16),
            # then their bf16 sum
            halves = torch.bmm(x.reshape(-1, 2, k).transpose(0, 1),
                               w.reshape(2, k, n))
            return halves.sum(0).reshape(*x.shape[:-1], n)
        out = func(*args, **kwargs)
        if args and self._row(args[0]) and isinstance(out, torch.Tensor) \
                and func not in _MATMULS:
            self.made[id(out)] = weakref.ref(out)   # a cast or view of it
        return out


def step_gaps(got: list, want: list) -> list:
    return [{k: abs(a[k] - b[k]) / abs(b[k]) for k in a}
            for a, b in zip(got, want)]


def grads_gap(got: dict, want: dict) -> float:
    def norm(t):
        return float(torch.linalg.vector_norm(t, dtype=torch.float64))
    return max(norm(got[k] - g) / norm(g) for k, g in want.items()
               if norm(g) > 0)


def split_steps(cfg, tcfg, batches, mode) -> dict:
    """``chip_smoke.dist_steps`` on one device with ``mode(params)`` (a
    context) around the whole run, step-0 gradients included: the params
    are made first, from the seed, so the mode can find its leaves."""
    params = cs.init_model_params(cfg, seed=cs.SEED, device="cuda")
    made = cs.init_model_params
    cs.init_model_params = lambda *a, **k: params
    try:
        with mode(params):
            return cs.dist_steps(cfg, tcfg, batches, None, "cuda",
                                 grads=True)
    finally:
        cs.init_model_params = made


def main() -> int:
    if not torch.cuda.is_available():
        print("tp_bf16_witness: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.monotonic()
    cs.kbuild.build()
    cs.kbuild.load_library()
    cs.log(f"gpu: {cs.gpu_line()}  build {time.monotonic() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    case = cs.TP_CASES[CASE]
    cfg = cs.tp_cfg(case)
    one_cfg = cs.tp_train_cfg(case)
    runs, split_calls = {}, {}
    plan = [(f"{name}@{seed}", seed, c, swap)
            for seed in SEEDS for name, c, swap in (
                ("fp32", dataclasses.replace(cfg, dtype="float32"), None),
                ("bf16", cfg, None), ("bf16-split", cfg, "split"))]
    plan.insert(2, ("bf16-plain@0", 0, cfg, "plain"))
    for name, seed, c, swap in plan:
        cs.SEED = seed
        batches = cs.dist_batches(c, cs.TP_SHAPE, cs.DIST_STEPS, "cuda")
        modes = []

        def mode(params):
            if swap == "split":
                modes.append(SplitRowParallel(params))
                return modes[-1]
            return cs.plain_kernels() if swap == "plain" else nullcontext()
        # the split's extra products do not line up with the selective
        # checkpoint's saved outputs on recompute: that run keeps every
        # activation instead (remat "none" computes the values "minimal"
        # recomputes)
        run = split_steps(c, dataclasses.replace(
            one_cfg, remat_policy="none") if swap == "split" else one_cfg,
            batches, mode)
        runs[name] = {"metrics": run["metrics"], "grads": run["grads"]}
        if modes:
            split_calls[name] = modes[0].split
        del run, batches
        torch.cuda.empty_cache()
    cs.SEED = SEEDS[0]
    t0 = time.monotonic()
    (ranks,) = cs.tp_world([(CASE, 0)], "cuda", grads={CASE: {
        k: runs[f"{k}@0"]["grads"] for k in ("bf16", "fp32")}})
    runs["bf16-tp@0"] = {"metrics": ranks[0]["metrics"]}
    pairs = {"bf16-tp vs bf16": ("bf16-tp@0", "bf16@0"),
             "bf16-plain vs bf16": ("bf16-plain@0", "bf16@0"),
             "bf16-plain vs fp32": ("bf16-plain@0", "fp32@0"),
             "bf16-tp vs fp32": ("bf16-tp@0", "fp32@0")}
    for seed in SEEDS:
        pairs.update({
            f"bf16 vs fp32 @{seed}": (f"bf16@{seed}", f"fp32@{seed}"),
            f"bf16-split vs fp32 @{seed}": (f"bf16-split@{seed}",
                                            f"fp32@{seed}"),
            f"bf16-split vs bf16 @{seed}": (f"bf16-split@{seed}",
                                            f"bf16@{seed}")})
    grads_pairs = {p: ab for p, ab in pairs.items()
                   if "bf16-tp" not in p}
    out = {"gpu": cs.gpu_line(), "seq_parallel": case.runs[0][1],
           "world_wall_s": time.monotonic() - t0,
           # the products split over the run: one gradient pass and
           # DIST_STEPS steps, two a layer each
           "split_products": split_calls,
           "metrics": {k: r["metrics"] for k, r in runs.items()},
           "step_gaps": {p: step_gaps(runs[a]["metrics"], runs[b]["metrics"])
                         for p, (a, b) in pairs.items()},
           "step0_grads_gap": {
               "bf16-tp vs bf16": ranks[0]["grads_gap"]["bf16"],
               "bf16-tp vs fp32": ranks[0]["grads_gap"]["fp32"],
               **{p: grads_gap(runs[a]["grads"], runs[b]["grads"])
                  for p, (a, b) in grads_pairs.items()}},
           "limits": cs.TRAIN_TOL}
    line = json.dumps(out)
    cs.log(f"witness: {line}")
    os.makedirs(os.path.join(cs.ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(cs.ROOT, "chiprun_out", "tp_bf16_witness.json"),
              "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
