#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card, ``nvcc`` and ``nvidia-smi``, and imports nothing of JAX or of the
JAX package.  Phases, each reported on its own lines:

1. build   -- compile the kernels from ``src/repro_torch/kernels/csrc``
              into ``build/repro_torch_kernels/`` and print the seconds;
              one ``ptxas:`` line per kernel instance (registers, spill
              bytes; a bf16 flash or SSD instance, the ``wgmma`` ones,
              that spills fails the run);
              print the card's name and power limit.
2. kernels -- every kernel against its plain PyTorch version on the card,
              in bf16 and fp32, at the main paths' shapes (granite-3-8b
              prefill and decode, lms-demo, zamba2-7b's flash at head dim
              112 and its SSD scan, phi3-medium-14b's GQA 40/10,
              nemotron-4-340b's head dim 192, mixtral-8x7b's windowed
              prefill over the long-context batch, deepseek-v2-236b's MLA
              prefill (q and k 192 wide, v 128, which the adapter pads
              to 192; the row also times the kernel alone on the padded V)
              and its latent norms, qwen2-vl-7b's prefill of 8 x 2048
              tokens, seamless-m4t-large-v2's decoder prefill at head dim
              64 and rwkv6-1.6b's final norm) plus a window, a ragged
              S or L, a non-causal and a strong-decay case: max abs error
              against the tolerance, kernel ms, plain ms, one library
              call's ms (none for the SSD scan; a windowed flash row's is
              ``scaled_dot_product_attention`` with the band as a boolean
              mask) and the bound in ms; flash and SSD rows also give
              bound / ms (``frac_of_bound``) and TFLOP/s, flash rows ms /
              library ms (``vs_library``); RMSNorm rows (decode rows of 1,
              8 and 33, and MLA's latent read in place as the first 512
              columns of 576-wide rows, among them) also give the kernels'
              own device time (``device_ms``, from ``torch.profiler``'s
              kernel events: ``device_ms()``) beside the back-to-back ms,
              the same two for ``F.rms_norm`` (``library_device_ms``) and
              the share of the bound on the device time; then the bf16
              rmsnorm kernel against ``F.rms_norm`` at the served and the
              narrow shapes, medians of interleaved timings
              (``rmsnorm-interleaved``); then the RMSNorm forward and
              backward at phase 6 (e)'s rows: a rank's whole batch (8192,
              4096) and its rows of the sequence under sequence
              parallelism (4096, 4096), bf16 (granite) and fp32
              (mixtral), and qwen2-vl's rows under sequence parallelism
              (4096, 3584), fp32; zamba2's world: the gated norm's
              statistic-from-outside kernels (a rank's 3584 of 7168
              columns, the other half's sums added through ``reduce``)
              forward and backward against the plain norm of whole rows,
              at (8192, 3584) fp32 and (16384, 3584) bf16, with
              ``F.rms_norm`` on the same rows beside them (no library
              call takes an outside statistic), and the SSD scan and its
              backward at 56 heads, fp32 (4, 2048) and bf16 (8, 2048);
              then flash (none for RWKV6), the SSD scan (zamba2, 56
              heads) and the RMSNorm forward at a rank's shapes of each
              phase 6 (f) world (its rows, its query heads and the KV
              heads they read; zamba2's statistic mode at its prefill
              rows and a decode batch), bf16.
3. serve   -- nine models at full width, random weights from a seed,
              bf16, one after the other (each freed before the next), seven
              served by ServingEngine(max_batch=8): granite-3-8b (40 layers),
              zamba2-7b (81 Mamba2 layers, 13 shared-attention
              applications), phi3-medium-14b (40 layers, d=5120) and
              nemotron-4-340b (4 of its 96 layers, d=18432, head dim 192,
              LayerNorm) with 8 requests of 256-1024 prompt tokens, 32 new
              tokens each and max_len 2048; then mixtral-8x7b (16 of its 32
              layers, 8 experts, top 2, sliding window 4096) with the
              long-context workload: 4 requests of 4200-6000 prompt tokens,
              16 new tokens, max_len 8192, so prefill runs the windowed
              flash kernel, the 4096-slot ring cache is filled from the
              prompts' tails and decode wraps it; deepseek-v2-236b (6 of
              its 60 layers: the dense layer 0 and 5 MoE layers of 160
              experts, top 6, 2 shared; MLA, whose prefill runs flash
              with a V narrower than Q and K and whose decode attends in
              the latent space; the short workload), rwkv6-1.6b (all 24
              layers; its WKV recurrence is plain PyTorch, as the
              reference's is jnp, so it launches only the RMSNorm of its
              final norm; the short workload, whose padded 910 tokens make
              the WKV chunk gcd(910, 32) = 2) (SERVED); then
              qwen2-vl-7b (all 28 layers) through ``make_serve_fns`` with
              its extras, since the engine passes none (as the
              reference's): 8 rows of BOS, a 32 x 32 image of patch
              embeddings and 1023 text tokens with Qwen2-VL's M-RoPE
              positions, 31 decode steps whose positions continue the
              text's; then seamless-m4t-large-v2 (24 encoder and 24
              decoder layers) the same way with its source frames (8 rows
              of 4096 frames from N(0, 0.02^2), the audio frontend being a
              stub): the short workload's prompts, 31 decode steps that
              read the bf16 cross K/V from the cache.  Each reports TTFT,
              prefill s, decode tokens/s and
              peak GB (deepseek also its cache bytes a token and layer).
              Launch counts
              are zeroed just before each run and read just after; they
              must be what the model's forwards launch (flash once per
              attention layer a prefill, ssd_scan once per Mamba2 layer a
              prefill, rmsnorm once per RMSNorm a forward, MLA's q_norm
              and kv_norm included; nemotron's LayerNorms launch none).  The logits must be finite and of
              the expected shape, and the kernel path (prefill, then 3
              decode steps through the caches) must agree with a plain full
              forward, the same model code with every kernel wrapper
              swapped for its plain version, on a 64-token input (granite,
              phi3 and nemotron in bf16, zamba2 in fp32); mixtral's input is
              the window + 64 tokens, its check in fp32 at 4 layers with the
              checked token routed alike in every layer, after the bf16
              routes of the two paths are compared at the served depth (a
              measurement: bf16 rounding may flip a near-tied expert; see
              serve()); deepseek's the same at 64 tokens and 2 layers (the
              dense one and a MoE one); qwen2-vl's in fp32 at 4 layers on an
              8 x 8 image and 63 text tokens, the same extras on both
              paths; rwkv6-1.6b's in fp32 at all 24 layers, after its
              chunked WKV is held to the sequential ``ref.wkv6_ref`` (fp32,
              2e-4) at the served shape (8, 910, chunk 2) and at 2048
              tokens (chunk 32), both timed (``wkv:`` lines); seamless's in
              fp32 at 4 encoder and 4 decoder layers over 512 source
              frames.  The MoE models' route lines give, at each (token,
              layer) routed otherwise, the k-th expert's logit margin
              beside one bf16 unit of those logits and the two paths'
              logit gap.
4. train   -- once the served weights are freed:
              (a) the RMSNorm backward kernel against ``ref.rmsnorm_bwd_ref``
              and against autograd through ``ref.rmsnorm_ref``, at
              granite's training shape (16384, 4096) in bf16 and fp32, at
              a ragged (4097, 1032), on strided rows (fp32, 512 of 576) and
              at deepseek's training widths (its kv_norm on the latent in
              place): max abs error against the tolerance (dscale, an fp32
              sum, at fp32's tolerance whatever x's dtype; the same bits on
              a second call), ms and device ms, plain ms, the library's ms
              and device ms (the backward of one ``F.rms_norm``, through
              ``torch.autograd.grad``) and the bound; with the forward at
              the same shape;
              (b) the SSD backward kernel against ``ref.ssd_bwd_ref``
              (autograd through the chunked plain form) at zamba2's
              training shape (B=8, L=2048, H=112, one group) and at a
              ragged one (L = 1000, 4 groups of 4 heads, an initial state
              and a final state's gradient), bf16 and fp32: each gradient's
              max error against the tolerance (dx, da, db, dc, d_init), ms,
              plain ms and the bound at the inputs' dtype (no library call
              computes SSD); in fp32 the same gradients rounded to bf16 must
              fail the fp32 limit (a control of lower precision); with
              zamba2's SSD forward and RMSNorm backward at its shape;
              (c) kernel-vs-plain training: lms-demo at full config
              (8 layers, d=512, bf16), and in fp32 a narrow hybrid with
              zamba2's layout and Mamba2 widths (d=1024, 2 groups of 2
              and 1 trailing layer, P = N = 64) and mixtral-8x7b at full
              width, 2 layers (where the two paths route alike): the
              first batch's
              gradients leaf by leaf, then three optimizer steps of
              ``make_train_step`` (AdamW; Adafactor for mixtral), through
              the kernels against the same code with the plain versions
              swapped in; the gradients, loss, grad norm and param norm
              must agree within TRAIN_TOL (limits set between the sound
              gaps and those of planted backward faults,
              ``train_faults.py``); then the narrow hybrid in bf16, the
              main path's dtype, whose gradients carry ~7% of rounding
              noise on either path: the kernel path's step-0 gradients
              against the fp32 plain path's, within HYBRID_BF16_TOL;
              (d) ``train()`` at full width, seq 2048, global batch
              8, remat "minimal", bf16 compute, TRAIN_STEPS steps with a
              recording stack, on granite-3-8b (8 of its 40 layers, AdamW;
              fp32 params, grads and AdamW moments take 16 bytes a
              parameter: all 40 layers need 131 GB), zamba2-7b (15 of its
              81 Mamba2 layers: 2 groups of 6 with both shared weight
              sets, and the 3 trailing ones; AdamW) and mixtral-8x7b (2 of
              its 32 layers, Adafactor; with the aux term and the dropped
              fraction a step), deepseek-v2-236b (its dense layer and one
              MoE layer, Adafactor, global batch 2: the masked
              attention's fp32 scores of 128 heads are 2.1 GB a row),
              qwen2-vl-7b (4 of its 28 layers, AdamW, with the loop's stub
              patches and positions), rwkv6-1.6b (all 24 layers, AdamW) and
              seamless-m4t-large-v2 (all 24 + 24 layers, AdamW, global
              batch 4, the loop's stub source frames): step time (median of steps 2-6),
              tokens/s, MFU against the card's bf16 peak (model flops 6 N
              T with N the active parameters, and the flops
              ``FlopCounterMode`` and the SSD cost model counted), peak
              GB, finite losses, and the launches of every step
              (``train_launches``: an RMSNorm a norm forward and again in
              each checkpointed block's re-run, a backward a norm; an SSD
              scan a Mamba2 layer and again in its re-run, a backward a
              layer; the loop counts flops on meta tensors, which launch
              nothing).
5. monitor -- the monitored job over HTTP, through the port's CLIs and
              its LMS client (``repro_torch.core``), against a small HTTP
              receiver in this script that answers as a stack does and
              decodes what it is sent with the port's ``decode_line``:
              (a) ``repro_torch.launch.train`` on lms-demo at full config,
              seq 256 x batch 8, MONITOR_STEPS steps with a checkpoint every
              MONITOR_CKPT steps and a failure injected at MONITOR_FAIL;
              the second call must resume from the last checkpoint and
              finish; (b) the client's cost: MONITOR_STEPS steps without
              checkpoints, monitored and with ``--no-monitor`` in turns
              (COST_RUNS), the cost being the difference of the two
              modes' mean step walls over the whole window (the steps
              that post included); (c) ``repro_torch.launch.serve`` on
              lms-demo for MONITOR_REQUESTS requests.  Checks: one
              ``train`` and one ``hpm`` point a monitored step, each
              ``mfu`` equal to
              6 N T / step time / 989e12, ``_calib`` points carrying the
              card's peaks, ``/job/start`` and ``/job/end`` in pairs, one
              ``serve_request`` point a request, no failed post, failed
              ``/alerts`` poll or dropped point, and the launches of each
              run (train: 17 RMSNorm forwards and 17 backwards a step;
              serve: 8 flash a prefill batch, 17 RMSNorm a forward).  Then
              (d) kernel marker regions at the serve CLI's shapes, through
              a marker session of the client: each ``kernel:*`` region's
              roofline fraction from the received sums and the card's
              calibrated peaks must lie in (0, 1.05].  One ``monitor:``
              JSON line sums it up.
6. dist    -- the data-parallel path (``train/step.py`` with a mesh,
              ``parallel/``, ``train/compression.py``) at world size 1:
              one NCCL rank through a file store under ``build/``:
              (a) granite-3-8b (8 of its 40 layers, full width, seq 2048 x
              batch 8) for DIST_STEPS AdamW steps through
              ``make_train_step(..., mesh=make_mesh_for(1))`` with params
              and AdamW state stored as the rank's pieces (on one rank the
              leaves themselves: a copy fails the run), against the
              one-device step from the same params and batches: loss, grad
              norm and param norm within TRAIN_TOL (``bit_equal`` says
              whether they are the same bits), step times and peak GB of
              both, launches of both exactly ``train_launches``; and the
              mesh step once more with its exchanges overlapped
              (``overlap=True``, the train CLI's ``--overlap-flags``):
              the one-device step's bits, and no worker thread, side
              stream or overlap group made (``dist: overlap at world size
              1``);
              (b) mixtral-8x7b (2 layers, full width, bf16) with
              ``impl="a2a"`` and capacity factor E / k (nothing drops) on
              the (1, 1) mesh: the a2a dispatch must have run in every MoE
              layer (``moe.dispatch_counts``), its logits within MODEL_TOL
              of the largest and its gradients within TRAIN_TOL["grads"]
              (relative L2) of the grouped dispatch's, both timed
              (forward and backward of the cross-entropy);
              (c) ``compressed_pmean`` (int8) over a one-rank group on one
              batch's gradients of (a)'s granite: every element within
              scale/2 of its row, timed;
              (d) ``pipeline_apply`` with one stage holding (a)'s 8 layers
              over PIPE_MICROBATCHES microbatches of the batch (flash
              prefill attention, no grad) against the layers on the whole
              batch: within the bf16 flash tolerance, and the stage's
              launches (flash and two RMSNorms a layer a microbatch); then
              forward and backward of the loss sum(y * r) (masked
              attention, remat "minimal", as phase 4's step): every layer
              leaf's gradient and the input's within TRAIN_TOL["grads"]
              (relative L2) of the whole batch's, launches exactly
              ``stage_launches`` (four RMSNorms forward and two backward
              a layer a microbatch);
              (e) tensor-parallel compute, the runs of TP_CASES (full
              width, seq 2048 x batch 4, DIST_STEPS steps): granite-3-8b
              (4 of its 40 layers, AdamW) without and with
              ``seq_parallel``; mixtral-8x7b (2 of 32 layers, fp32,
              Adafactor) with its experts split over "model", then with
              every expert's hidden columns split
              (``TRAIN_RULES.with_overrides(experts=None)``) and
              ``seq_parallel``; qwen2-vl-7b (4 of 28 layers, AdamW, the
              loop's stub patches and positions) with ``seq_parallel``,
              in fp32 and in bf16 (held at step 0 and on step 0's
              gradients, TRAIN_TOL["grads"]; steps 1-2 logged);
              deepseek-v2-236b (its dense layer and one MoE layer, fp32,
              Adafactor, at DEEPSEEK_TP_SHAPE) with ``seq_parallel``: MLA's
              heads, the experts, the dense and shared MLPs split;
              seamless-m4t-large-v2 (4 + 4 layers, fp32, AdamW, the stub
              frames) with ``seq_parallel`` over its tokens and frames;
              zamba2-7b (13 of 81 layers: 2 groups and a trailing layer,
              fp32, AdamW) with ``seq_parallel``: 56 SSM heads a rank
              from its ``[z_r | x_r | BC_r | dt_r]`` piece of in_proj, B
              and C gathered, the gated norm through the
              statistic-from-outside kernels, the shared blocks' heads
              and MLP columns split; rwkv6-1.6b (8 of 24 layers, fp32, AdamW)
              with ``seq_parallel``: 16 heads a rank, the channel mix's
              columns split; then FSDP:
              granite-3-8b (2 of its 40 layers, its own bf16, AdamW) on a
              (2, 1) mesh, 2 rows a rank in 2 microbatches, each layer
              gathered over "data" in its call and its gradient
              reduce-scattered in the backward (the matrices and the
              embedding gathered in bf16, the norms in fp32), its peak
              within FSDP_PEAK_TOL of its count; then the same step from
              the same seed with its exchanges overlapped with compute
              (``dist:fsdp-overlap``: each layer's gather issued while the
              layer before computes, each gradient's reduce-scatter in
              flight until the backward ends): held to the one-device step
              as every run, and to ``dist:fsdp`` at every step (``dist:
              fsdp-overlap``: the gaps, rank 0's step seconds of both,
              staged bytes by purpose, exchanges in flight by purpose,
              none of ``param_gather`` or ``grad_scatter`` failing the run,
              counted and measured peaks); after it, in the same world, a
              two-stage pipeline (PIPE_RUN): a ("pipe",) mesh of the two
              ranks, each stage 2 of granite-3-8b's layers (full width,
              bf16, a rank making its own only), seq 2048 x batch 4 in
              PIPE_MICROBATCHES microbatches, forward and backward against
              the 4 layers in sequence on one device: the output within
              MODEL_TOL of the largest element, every leaf's gradient and
              dx within TRAIN_TOL["grads"] (relative L2), a rank's bytes
              staged by purpose (``pipe_act``, ``pipe_grad``) exactly its
              hand-offs and broadcasts, its launches exactly
              ``stage_launches``, its peak GB logged (``dist: pipeline``).
              The runs of one (data, model) mesh run in turn in one world
              of two processes of this script sharing the card over gloo
              (NCCL refuses two ranks on one device, so every exchange is
              staged through the host), each against its case's one-device
              step run first here on the same params and batches: each
              rank's loss, grad norm and param norm within TRAIN_TOL, its
              launches exactly ``train_launches``, its
              ``max_memory_allocated`` within the
              case's tolerance (PEAK_TOL) of ``launch.cost_analysis``'s
              count of its step, a MoE run's ranks dispatching alike; the
              card's compute mode first, then per run each rank's step
              times (host-staged exchanges: not a speed of tensor
              parallelism or FSDP) and staged bytes (by purpose), and each
              world's wall seconds;
              (f) serving on a mesh, the worlds of SERVE_WORLDS: each
              model's batch through the one-device ``make_serve_fns``
              first (greedy, SERVE_NEW positions), then through
              ``make_serve_fns(cfg, pc=)`` on two processes sharing the
              card over gloo (one pair a mesh, serving its worlds in
              turn), each rank with its pieces of the params,
              rows and cache, fed the one-device greedy tokens: granite-3-8b
              (40 layers, KV heads split), granite (8 layers, the cache's
              slots split: ``kv_heads`` unbound), mixtral-8x7b (4 of 32
              layers, experts split, the long prompts and the ring cache),
              qwen2-vl-7b (8 of 28 layers, stub image, M-RoPE in decode),
              deepseek-v2-236b (4 of 60 layers, MLA's heads and the
              experts split, its latent cache split by slot, 920 of 1840
              a rank), seamless-m4t-large-v2 (8 + 8 of 24 + 24 layers,
              its self and cross caches split over the KV heads),
              zamba2-7b (13 of 81
              layers: 56 SSM heads a rank, its conv cache as its parts'
              chunks, its SSM state and its shared blocks' 16 KV heads a
              rank), rwkv6-1.6b (8 of 24 layers: 16 heads a rank, its WKV
              state split by heads, its token shifts whole) on (1, 2),
              granite (8 layers) on (2, 1) (rows only, the params whole
              on each rank).  Each rank makes its pieces one leaf at a time (two
              ranks share the card).  Every
              position's logits within MODEL_TOL of the one-device ones
              (relative to the largest), the greedy tokens that agree
              logged, launches a rank exactly ``expected_launches``, each
              rank's ``max_memory_allocated`` within PEAK_TOL of the count
              of its calls.  ``dist:`` JSON lines.
7. analysis -- the step counts of ``launch.cost_analysis`` against the
              card: (a) for each phase-4 cell, ``train()``'s own count of
              its step (flops, bytes, predicted peak GB) and bound s =
              max(flops / 989e12, bytes / 3.35e12) beside the measured step
              time and ``max_memory_allocated``; a count whose bytes or
              flops over the step time exceed RATE_LIMIT x the card's rate,
              or a predicted peak PEAK_TOL or more from the measured one,
              fails; (b) what phase 5's monitored train CLI posted: each
              hpm point's ``hbm_bw_util`` in (0, RATE_LIMIT], its
              ``mem_gb_per_s`` x step time equal to the ``train_step``
              region's ``bytes`` a call (``hlo_bytes``), the region's
              roofline fraction on the received calibration in (0,
              RATE_LIMIT]; (c) phase 6's granite mesh step at world size 1
              traced as the dry run traces a cell: 0 collective bytes;
              (d) the dry run (``repro_torch.launch.dryrun``) on this
              machine's CPU for DRY_CELLS: a line a cell (status, dominant
              term, bound s, GB a rank, whether it fits 80 GB, seconds),
              records under ``build/dryrun_torch/``.  ``analysis:`` lines.
8. the kernels line (JSON: every kernel with its launches summed over the
   paths driven -- the nine served models, train granite, zamba2,
   mixtral, deepseek, qwen2-vl, rwkv6 and seamless, the train CLI and the
   serve CLI on lms-demo, the dist phase's granite steps, pipeline stage
   (forward only, then forward and backward), mixtral a2a run, the eleven
   tensor-parallel and FSDP runs, the two-stage pipeline and the nine
   serving worlds (their ranks' launches summed) -- its numbers at
   one path's shapes (zamba2's prefill for flash, SSD and the forward
   RMSNorm; granite's training shape for the RMSNorm backward, zamba2's
   for the SSD backward; a rank's rows of zamba2's TP world for the
   statistic-from-outside mode), and per path its launches and the rows
   it was timed at), then the last line ``{"ok": true, "device":
   {...}}``.

Any failure raises, so the script exits non-zero and prints no last line.
"""

from __future__ import annotations

import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import contextmanager, nullcontext, redirect_stdout
from typing import NamedTuple, Optional
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# The allocator maps segments that grow in place: deepseek-v2-236b's
# training step frees 4.3 GB score tensors in its backward and then asks
# for its 5 GB expert stacks' optimizer temporaries, which fixed segments
# refuse for fragmentation (13.7 GiB reserved but unused at the refusal)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import (  # noqa: E402
    ShapeConfig, TrainConfig, get_config)
from repro_torch.core import RemoteStack, calibrate  # noqa: E402
from repro_torch.core.line_protocol import decode_line  # noqa: E402
from repro_torch.core.marker import CALIB_REGION  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokenSource  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.cost_analysis import analyze_step  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    build_train_bundle, trace_bundle)
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import (  # noqa: E402
    cross_entropy, embed_tokens, rope_table)
from repro_torch.models.params import (  # noqa: E402
    flatten, fp32_leaves, init_params, unflatten)
from repro_torch.models.ssm import wkv6_chunked  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    _layer_plan, _train_layers, forward, init_cache, init_model_params,
    loss_fn, model_specs)
from repro_torch.parallel import comm  # noqa: E402
from repro_torch.parallel.pipeline import pipeline_apply  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    TRAIN_RULES, PartitionConstraints, binds_model, recurrent_splits,
    shard_leaf, shard_tree, shardings_for_specs)
from repro_torch.serve.engine import (  # noqa: E402
    ServingEngine, make_serve_fns)
from repro_torch.train.compression import (  # noqa: E402
    compressed_pmean, quantize_int8)
from repro_torch.train.loop import (  # noqa: E402
    InjectedFailure, device_peaks, stub_extras, train)
from repro_torch.train.step import (  # noqa: E402
    batch_to_device, make_grads_fn, make_train_step, shard_batch)
from repro_torch.train.step import shardings as step_shardings  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

# H100 SXM published peaks (dense): HBM bytes/s, and FLOP/s by input type
# (bf16 on the tensor cores; fp32 on the CUDA cores, which the fp32 kernels
# use).
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {"flash_attention": {torch.bfloat16: 2e-2, torch.float32: 2e-5},
       "rmsnorm": {torch.bfloat16: 2e-2, torch.float32: 1e-5},
       # dx: the forward's tolerances (fp32 arithmetic in both, dx rounded
       # to x's dtype)
       "rmsnorm_backward": {torch.bfloat16: 2e-2, torch.float32: 1e-5},
       # dscale: an fp32 sum over the rows in the kernel and the plain
       # version alike, whatever x's dtype, so fp32's tolerance in both
       "rmsnorm_dscale": {torch.bfloat16: 1e-5, torch.float32: 1e-5},
       # the statistic from outside: the same fp32 arithmetic as the fused
       # kernels' (two partial sums added where theirs is one)
       "rmsnorm_split": {torch.bfloat16: 2e-2, torch.float32: 1e-5},
       "rmsnorm_split_backward": {torch.bfloat16: 2e-2,
                                  torch.float32: 1e-5},
       "ssd_scan": {torch.bfloat16: 2e-2, torch.float32: 2e-3},
       # dx, da, db, dc, d_init: fp32 sums in the kernel and the plain
       # version alike, from the same (bf16) inputs (the bf16 kernel's
       # products take fp32 operands as hi/lo bf16 pairs, ~2^-17 of each);
       # dx, db, dc rounded to x's dtype (bf16: one unit apart, 7.8e-3,
       # where the two values straddle a rounding point; the sound bf16
       # kernel lies <= 0.39 of the limit).  fp32, at the decay this
       # script runs (0.1): the sound kernel lies <= 7.6e-4 from the plain
       # version (da; the other gradients <= 2.8e-4), while the same
       # gradients rounded to bf16 lie 3.9e-3 from it; check_ssd_bwd
       # fails if that control passes.  (Under strong decay, decay 20, the fp32 chunked
       # algorithm itself drifts 1.5e-3 from the plain version; the card
       # tests hold that case to 1e-2.)  Both limits lie between the sound
       # gaps and the planted faults' (``train_faults.py``; PERF.md §6)
       "ssd_scan_backward": {torch.bfloat16: 2e-2, torch.float32: 2e-3},
       # not a kernel: RWKV6's chunked WKV recurrence (plain PyTorch)
       # against its sequential oracle, the reference's own tolerance
       "wkv6": {torch.float32: 2e-4}}
MODEL_TOL = 5e-2          # model logits (bf16 in tests/test_kernels.py)
# the plain attention runs batch row by batch row where the whole batch's
# (B, H, S, S) fp32 scores would pass this (the long-context shape: 18 GB)
PLAIN_SCORE_BYTES = 4e9
SOURCES = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:35"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:21"),
    # the gradient of the same Pallas kernel, which has none of its own
    "rmsnorm_backward": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                         "src/repro/kernels/rmsnorm.py:21"),
    # the same Pallas kernel on a row split over "model", its statistic
    # summed over the ranks (Mamba2's gated norm under tensor parallelism)
    "rmsnorm_split": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                      "src/repro/kernels/rmsnorm.py:21"),
    "rmsnorm_split_backward": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                               "src/repro/kernels/rmsnorm.py:21"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd.cu",
                 "src/repro/kernels/ssd.py:26"),
    # the gradient of the SSD Pallas kernel, which has none of its own
    "ssd_scan_backward": ("src/repro_torch/kernels/csrc/ssd_bwd.cu",
                          "src/repro/kernels/ssd.py:26"),
}
# kernel entry points in csrc/, as ptxas names their instances
KERNEL_NAMES = ("flash_wgmma_kernel", "flash_f32_kernel", "rmsnorm_kernel",
                "rmsnorm_bwd_kernel", "rmsnorm_dscale_kernel",
                "rmsnorm_rowsum_kernel", "rmsnorm_apply_kernel",
                "rmsnorm_apply_bwd_kernel",
                "ssd_wgmma_kernel", "ssd_f32_kernel", "ssd_bwd_states_kernel",
                "ssd_bwd_wgmma_kernel", "ssd_bwd_kernel",
                "ssd_bwd_group_sum_kernel")
# bf16 instances that issue wgmma: a spill or a missing instance fails
WGMMA_INSTANCES = tuple(f"flash_wgmma_kernel<{d}>" for d in fa.HEAD_DIMS) + \
    ("ssd_wgmma_kernel", "ssd_bwd_states_kernel", "ssd_bwd_wgmma_kernel")
# RMSNorm rows timed by ``profile_rmsnorm.py``, bf16: (rows, d) of the
# forward -- MLA's kv_norm at prefill and in training, the lms-demo CLIs
# (train, serve prefill and decode), decode rows, MLA's q_norm, rwkv6's
# final norm, the served
# prefills (zamba2, granite, phi3 / deepseek, zamba2's gated norm) and
# granite's training shape -- and of the backward (the lms-demo train CLI,
# deepseek's three training widths, a ragged row, rwkv6, zamba2 / qwen2-vl
# and granite in training)
RMSNORM_FWD_SHAPES = ((7280, 512), (4096, 512), (2048, 512), (64, 512),
                      (4, 512), (1, 4096), (8, 4096), (33, 4096), (8, 3584),
                      (7280, 1536), (7280, 2048), (7280, 3584), (7280, 4096),
                      (7280, 5120), (7280, 7168), (16384, 4096))
RMSNORM_BWD_SHAPES = ((2048, 512), (4096, 512), (4096, 1536), (4097, 1032),
                      (16384, 2048), (16384, 3584), (4096, 5120),
                      (16384, 4096))
SEED = 0
N_REQUESTS, MAX_NEW = 8, 32
MAX_BATCH, MAX_LEN = 8, 2048
# The long-context workload (mixtral): LONG_REQUESTS prompts drawn from
# LONG_PROMPT tokens, LONG_NEW new tokens, caches of LONG_MAX_LEN (the
# sliding window of 4096 keeps a ring of 4096 slots).
LONG_REQUESTS, LONG_PROMPT, LONG_NEW = 4, (4200, 6000), 16
LONG_MAX_LEN = 8192
# Served in this order, each at full width: the layers served (None = all)
# and the workload ("short": N_REQUESTS prompts of 256-1024 tokens, MAX_NEW
# new tokens, MAX_LEN; "long": the long-context one).  nemotron-4-340b's 96
# layers are 680 GB in bf16: 4 of them (46.5 GB with the 256000-token embed
# and unembed) fit beside the 3.7 GB of its full-sequence logits; mixtral's
# 32 layers are 93 GB: 16 fit (47 GB).
# deepseek-v2-236b's 60 layers are ~470 GB: layer 0 (dense FFN) and 5 MoE
# layers (160 experts, top 6, 2 shared) are 42.5 GB with the untied
# 102400-token embed and unembed.
# rwkv6-1.6b (all 24 layers) runs no flash or SSD kernel: its WKV
# recurrence is plain PyTorch (as the reference's is jnp), its block norms
# LayerNorms; its final norm is an RMSNorm (the config's norm type).
SERVED = {"granite-3-8b": (None, "short"), "zamba2-7b": (None, "short"),
          "phi3-medium-14b": (None, "short"),
          "nemotron-4-340b": (4, "short"), "mixtral-8x7b": (16, "long"),
          "deepseek-v2-236b": (6, "short"), "rwkv6-1.6b": (None, "short")}
MODELS = tuple(SERVED)
# the MoE models' check: a prompt of window + MIX_CHECK_TAIL tokens (the
# ring wraps in prefill and again in decode; deepseek has no window), in
# fp32 at MOE_CHECK_LAYERS layers (16 fp32 mixtral layers, 94 GB, do not
# fit; deepseek's 2 are its dense layer and one MoE layer)
MIX_CHECK_TAIL = 64
MOE_CHECK_LAYERS = {"mixtral-8x7b": 4, "deepseek-v2-236b": 2}
# The VLM (qwen2-vl-7b, all 28 layers), served through make_serve_fns with
# its extras (the engine passes none, as the reference's): VLM_ROWS rows of
# BOS, a VLM_GRID x VLM_GRID image of patch embeddings (N(0, 0.02^2) from
# SEED) and VLM_TEXT text tokens from default_rng(SEED), with Qwen2-VL's
# M-RoPE positions (vlm_inputs); then VLM_NEW - 1 decode steps in a cache
# of VLM_MAX_LEN.  Its model check: fp32, VLM_CHECK_LAYERS layers, an image
# of VLM_CHECK_GRID^2 patches and VLM_CHECK_TEXT text tokens.
VLM_MODEL = "qwen2-vl-7b"
VLM_ROWS, VLM_GRID, VLM_TEXT, VLM_NEW, VLM_MAX_LEN = 8, 32, 1023, 32, 2304
VLM_CHECK_LAYERS, VLM_CHECK_GRID, VLM_CHECK_TEXT = 4, 8, 63
# The encoder-decoder (seamless-m4t-large-v2, 24 encoder and 24 decoder
# layers), served through make_serve_fns with its source frames (the
# engine passes none, as the reference's): the short workload's prompts,
# right-aligned and BOS-padded as the engine pads them, and source frames
# of (N_REQUESTS, encdec_source_len, d) from N(0, 0.02^2) seeded by SEED
# (the audio frontend is a stub); then MAX_NEW - 1 decode steps.  Its model
# check: fp32, ENCDEC_CHECK_LAYERS encoder and decoder layers,
# ENCDEC_CHECK_FRAMES source frames, a 64-token prompt.
ENCDEC_MODEL = "seamless-m4t-large-v2"
ENCDEC_CHECK_LAYERS, ENCDEC_CHECK_FRAMES = 4, 512
# Training (phase 4): TRAIN_STEPS steps of TRAIN_SHAPE tokens, each model
# at full width with the layers and optimizer below: granite-3-8b (the
# RMSNorm backward's main path) 8 of its 40 layers; zamba2-7b 15 of its 81
# Mamba2 layers, 2 groups of 6 (both shared weight sets) and the 3 trailing
# layers, 1.51B parameters; mixtral-8x7b 2 of its 32 layers, 3.17B
# parameters, with Adafactor (AdamW's 16 bytes a parameter leave little
# room for the expert buffers).
# deepseek-v2-236b: its dense layer and one MoE layer, 5.36B parameters
# (2 of 60), Adafactor, batch 2: parameters, gradients and Adafactor state
# take ~54 GB, and one fp32 score tensor of its 128 heads at 2048^2 (the
# masked attention) is 2.1 GB a row.  qwen2-vl-7b: 4 of its 28 layers, AdamW,
# with the loop's stub extras (patches and positions, ``stub_extras``).
# rwkv6-1.6b: all 24 layers, AdamW (1.6B parameters, 26 GB of params,
# grads and moments).  seamless-m4t-large-v2: all 24 + 24 layers, AdamW,
# batch 4: its fp32 logits over the padded vocabulary of 258,048 are 16.9
# GB a copy at batch 8, and the cross-entropy keeps more than one.
TRAIN_MODEL, TRAIN_STEPS = "granite-3-8b", 6
TRAIN_LAYERS_OF = {TRAIN_MODEL: 8, "zamba2-7b": 15, "mixtral-8x7b": 2,
                   "deepseek-v2-236b": 2, VLM_MODEL: 4, "rwkv6-1.6b": 24,
                   ENCDEC_MODEL: 24}
TRAIN_OPTIMIZER = {TRAIN_MODEL: "adamw", "zamba2-7b": "adamw",
                   "mixtral-8x7b": "adafactor",
                   "deepseek-v2-236b": "adafactor", VLM_MODEL: "adamw",
                   "rwkv6-1.6b": "adamw", ENCDEC_MODEL: "adamw"}
TRAIN_SHAPE = ShapeConfig("train_2k", seq_len=2048, global_batch=8,
                          kind="train")
TRAIN_SHAPE_OF = {"deepseek-v2-236b": ShapeConfig(
    "train_2k_b2", seq_len=2048, global_batch=2, kind="train"),
    ENCDEC_MODEL: ShapeConfig("train_2k_b4", seq_len=2048, global_batch=4,
                              kind="train")}
PARITY_SHAPE = ShapeConfig("parity", seq_len=512, global_batch=8,
                           kind="train")
# Kernel path vs plain path (relative gaps): the step-0 gradients leaf by
# leaf (``grads``), then PARITY_STEPS AdamW steps' loss, grad norm and
# param norm.  The two paths differ only where an fp32 sum taken in another
# order rounds a norm's output or its dx to another bf16 value.  Each limit
# lies between the sound kernel's largest gap and the planted backward
# faults' (``train_faults.py`` on an H100): grads 3.7e-3 sound vs 0.13 and
# more; loss 1.1e-4 vs 3.6e-3 and more for the dx faults; grad norm 6.4e-4
# vs 9.0e-2 and more for the dx faults; param norm 3.2e-7 vs 7.8e-6 and
# more for all but dscale without r.  The dscale faults move loss and grad
# norm by 1.1e-4-1.7e-3, too close to the sound gaps to separate: the
# gradient gap catches them (0.95 and 1.0).
PARITY_STEPS = 3
TRAIN_TOL = {"loss": 1e-3, "grad_norm": 1e-2, "param_norm": 2e-6,
             "grads": 2e-2}
# The narrow hybrid in bf16: the kernel path's step-0 gradients against the
# fp32 plain path's (the largest relative L2 gap over the leaves).  bf16
# rounding alone puts either path ~7% away (kernels 0.068, plain 0.064 on
# an H100), above TRAIN_TOL's 2e-2; the planted SSD-backward faults lie at
# 0.20 (da without the cross-chunk term), 0.48 (decays one step late) and
# 0.56 (db of one head of a group) (``train_faults.py``'s ``bf16-parity``
# lines).
HYBRID_BF16_TOL = 0.1
# Monitor (phase 5): the CLIs on lms-demo at full config.
MONITOR_STEPS, MONITOR_CKPT, MONITOR_FAIL = 60, 20, 30
MONITOR_SEQ, MONITOR_BATCH = 256, 8
MONITOR_REQUESTS = 16
# the client's cost: MONITOR_STEPS steps without checkpoints (a background
# checkpoint write slows the steps it overlaps), monitored or not, in turns
COST_RUNS = ("on", "off", "off", "on")
# Analysis (phase 7): a count that puts a measured step above this times a
# peak rate (bytes over the memory rate, flops over the bf16 peak) is wrong
RATE_LIMIT = 1.05
# the predicted peak (arguments + what the traced step holds at once +
# kernel scratch) against phase 4's max_memory_allocated
PEAK_TOL = 0.10
# the dry run's cells on this machine: (arch, shape, multi-pod)
DRY_CELLS = (("granite-3-8b", "train_4k", False),
             ("granite-3-8b", "train_4k", True),
             ("deepseek-v2-236b", "train_4k", False))


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def smoke_prompts(cfg, workload: str = "short") -> list:
    """The served workload: N_REQUESTS prompts of 256-1024 tokens, or
    (``"long"``) LONG_REQUESTS of LONG_PROMPT tokens, drawn from SEED
    (``profile_serve.py`` traces the same batch)."""
    rng = np.random.default_rng(SEED)
    n, (lo, hi) = (N_REQUESTS, (256, 1024)) if workload == "short" else \
        (LONG_REQUESTS, LONG_PROMPT)
    lens = rng.integers(lo, hi + 1, size=n)
    return [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
            for n in lens]


def serve_plan(name: str) -> tuple:
    """(config cut to its served depth, prompts, max_len, new tokens) of a
    served model."""
    layers, workload = SERVED[name]
    cfg = get_config(name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if workload == "short":
        return cfg, smoke_prompts(cfg), MAX_LEN, MAX_NEW
    return cfg, smoke_prompts(cfg, workload), LONG_MAX_LEN, LONG_NEW


def serving_params(cfg) -> dict:
    """Random weights from SEED on the card, bf16 but for the fp32 norm
    scales."""
    return init_model_params(cfg, seed=SEED, compute_dtype=torch.bfloat16)


def vlm_seq_len(grid: int, text: int) -> int:
    """Tokens of a VLM row: BOS, grid x grid patches, ``text`` tokens."""
    return 1 + grid * grid + text


def vlm_positions(grid: int, text: int, device=None) -> torch.Tensor:
    """(S, 3) M-RoPE positions by Qwen2-VL's rule: BOS at (0, 0, 0), patch
    (r, c) of the image at (1, 1 + r, 1 + c), text token j at
    t = h = w = 1 + grid + j."""
    r, c = torch.meshgrid(torch.arange(grid), torch.arange(grid),
                          indexing="ij")
    img = torch.stack([torch.ones_like(r), 1 + r, 1 + c], -1).reshape(-1, 3)
    txt = (1 + grid + torch.arange(text))[:, None].expand(text, 3)
    return torch.cat([torch.zeros(1, 3, dtype=torch.long), img,
                      txt]).to(device)


def vlm_inputs(cfg, rows: int, grid: int, text: int, dtype, dev) -> tuple:
    """(tokens (rows, S), extras) of the VLM workload on ``dev``: BOS
    (token 0), the patch positions (token 0, replaced by the patches) and
    text tokens from default_rng(SEED); ``patches`` (rows, grid^2, d) from
    N(0, 0.02^2) seeded by SEED in ``dtype``; ``mrope_pos`` (rows, S, 3)."""
    rng = np.random.default_rng(SEED)
    toks = np.zeros((rows, vlm_seq_len(grid, text)), np.int64)
    toks[:, 1 + grid * grid:] = rng.integers(1, cfg.vocab_size,
                                             size=(rows, text))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    patches = (0.02 * torch.randn((rows, grid * grid, cfg.d_model),
                                  generator=gen, device=dev)).to(dtype)
    mpos = vlm_positions(grid, text, dev)[None].expand(rows, -1, 3)
    return torch.from_numpy(toks).to(dev), {"patches": patches,
                                            "mrope_pos": mpos.contiguous()}


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


PROFILE_TRIES = 3


def _kernel_events(fn, iters: int) -> dict:
    """{kernel name: [durations, µs]} of one profiler session over ``iters``
    calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    path = os.path.join(ROOT, "build", f"device_ms_{os.getpid()}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    by_kernel = {}
    for k in events:
        if k.get("cat") == "kernel":
            by_kernel.setdefault(k["name"], []).append(k["dur"])
    return by_kernel


def device_ms(fns: dict, iters: int = 50, warmup: int = 3) -> dict:
    """Device time of each callable in ``fns``: the durations of the
    kernels one call runs on the card, read from ``torch.profiler``'s kernel
    events over ``iters`` back-to-back calls, so free of the host's launch
    cost and of the gaps between launches.  Each callable has a profiler
    session of its own (late in a long process the trace's device clock
    strays from its host clock by more than a millisecond, so kernels
    cannot be told apart by host-side ranges), and each kernel name's mean
    duration counts as often as a call launches it (the profiler can drop a
    few events: a mean over those recorded is not biased by them).  A
    session that records no kernel at all (now and then a whole session's
    device activity goes missing on the H100 machines this script has run
    on: whole runs of it met that, the kernel checks alone did not) is run
    again, up to PROFILE_TRIES sessions, each retry logged; none recorded
    fails.  Returns
    {name: (ms a call, kernels recorded a call)}."""
    out = {}
    for name, fn in fns.items():
        for _ in range(warmup):
            fn()
        for attempt in range(PROFILE_TRIES):
            by_kernel = _kernel_events(fn, iters)
            if by_kernel:
                break
            log(f"device_ms: session {attempt + 1} recorded no kernel for "
                f"{name}")
        else:
            raise AssertionError(f"device_ms: no kernel recorded for {name} "
                                 f"in {PROFILE_TRIES} sessions")
        out[name] = (sum(statistics.fmean(v) * max(1, round(len(v) / iters))
                         for v in by_kernel.values()) / 1e3,
                     sum(len(v) for v in by_kernel.values()) / iters)
    return out


def _instance(mangled: str) -> str:
    """``flash_wgmma_kernel<128>``, ``rmsnorm_kernel<bf16, 4>``,
    ``ssd_wgmma_kernel``, ... from a mangled entry-point name (template
    arguments: a type, an int, or a type and an int)."""
    for k in KERNEL_NAMES:
        if k in mangled:
            arg = mangled.split(k, 1)[1]
            m = re.match(r"I(13__nv_bfloat16|f)?(?:Li(\d+)E)?(?:Lb([01])E)?E",
                         arg)
            if not m or not (m.group(1) or m.group(2)):
                return k
            args = []
            if m.group(1):
                args.append("f32" if m.group(1) == "f" else "bf16")
            if m.group(2):
                args.append(m.group(2))
            if m.group(3):
                args.append(("false", "true")[int(m.group(3))])
            return f"{k}<{', '.join(args)}>"
    return mangled


def ptxas_report() -> list:
    """Registers and spill bytes of every kernel instance, read from the
    ``ptxas -v`` report the build kept; raises if a ``wgmma`` instance
    (bf16 flash, bf16 SSD) spills or is missing."""
    path = kbuild.BUILD_ROOT / kbuild.source_hash() / kbuild.PTXAS_LOG
    rows, cur = [], None
    for line in path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": _instance(m.group(1))}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    by_name = {r["kernel"]: r for r in rows}
    for name in WGMMA_INSTANCES:
        r = by_name.get(name)
        if r is None or r.get("spill_stores", 1) or r.get("spill_loads", 1):
            raise AssertionError(f"{name}: missing or spills in the ptxas "
                                 f"report: {r}")
    return rows


def bound(costs: dict, dtype) -> tuple:
    """(least ms the card needs, "bytes" | "operations")."""
    t_bytes = costs["bytes"] / PEAK_BYTES * 1e3
    t_ops = costs["flops"] / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got, want, dtype, magnitude=None,
            what: str = "") -> float:
    """Max abs error; raises when |got - want| > tol * (1 + m), m = |want|
    or, for a sum whose terms cancel, the sum of their magnitudes."""
    tol = TOL[name][dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    label = f"{name} {what}".strip()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{label}: non-finite output")
    m = w.abs() if magnitude is None else magnitude
    worst = float((err - tol * (1.0 + m)).max())
    if worst > 0:
        raise AssertionError(f"{label}: error {float(err.max()):.3e} beyond "
                             f"tolerance {tol:g}")
    return float(err.max())


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_flash(gen, b, h, kv, s, d, dtype, *, causal=True, window=0,
                dv=None, tag=""):
    """Times the kernel as the served path calls it: (B, S, H, D)
    activations through ``ops.flash_attention_bshd``, which hands the kernel
    transposed views.  ``dv`` < D: V of that width (MLA), which the adapter
    pads to D; the plain version and SDPA take it as it is, and the row
    also times the kernel alone on the padded V (``kernel_padded_ms``), so
    the adapter's pad and slice are the difference."""
    dev = torch.device("cuda")
    dv = d if dv is None else dv
    q = torch.randn((b, s, h, d), generator=gen, device=dev, dtype=dtype)
    k = torch.randn((b, s, kv, d), generator=gen, device=dev, dtype=dtype)
    v = torch.randn((b, s, kv, dv), generator=gen, device=dev, dtype=dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def plain():
        if b * h * s * s * 4 <= PLAIN_SCORE_BYTES:
            return ref.attention_ref(qt, kt, vt, causal=causal,
                                     window=window)
        return torch.cat([ref.attention_ref(qt[i:i + 1], kt[i:i + 1],
                                            vt[i:i + 1], causal=causal,
                                            window=window)
                          for i in range(b)])
    got = ops.flash_attention_bshd(q, k, v, causal=causal, window=window)
    want = plain().transpose(1, 2)
    err = compare("flash_attention", got, want, dtype)
    del want
    ms = time_ms(lambda: ops.flash_attention_bshd(q, k, v, causal=causal,
                                                  window=window))
    plain_ms = time_ms(plain, iters=3)
    if window:
        qp = torch.arange(s, device=dev)[:, None]
        kp = torch.arange(s, device=dev)[None, :]
        mask = kp > qp - window
        if causal:
            mask &= kp <= qp

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
    else:
        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal,
                                                  enable_gqa=True)
    library_ms = time_ms(lib)
    costs = fa.cost_estimate(qt.shape, kv, q.element_size(), causal=causal,
                             window=window, dv=dv)
    bound_ms, bound_by = bound(costs, dtype)
    row = {"name": "flash_attention", "shape": [b, h, kv, s, d],
           "dtype": str(dtype).replace("torch.", ""), "causal": causal,
           "window": window, "max_abs_err": err,
           "tol": TOL["flash_attention"][dtype], "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "vs_library": ms / library_ms, "frac_of_bound": bound_ms / ms,
           "tflops": costs["flops"] / ms / 1e9}
    if dv != d:
        vp = F.pad(v, (0, d - dv)).transpose(1, 2)
        padded = fa.cost_estimate(qt.shape, kv, q.element_size(),
                                  causal=causal, window=window)
        row.update({"dv": dv, "kernel_padded_ms": time_ms(
            lambda: fa.flash_attention(qt, kt, vp, causal=causal,
                                       window=window)),
            "padded_bound_ms": bound(padded, dtype)[0],
            "padded_bytes": padded["bytes"], "bytes": costs["bytes"]})
        del vp
    log(f"kernel-check {tag}: {json.dumps(row)}")
    return row


def rows_of(gen, n, d, dtype, ld=None):
    """(n, d) random rows on the card; with ``ld`` > d, the first d
    columns of (n, ld) rows (MLA's latent is the first 512 of 576)."""
    full = torch.randn((n, ld or d), generator=gen, device="cuda",
                       dtype=dtype)
    return full[:, :d]


def rmsnorm_times(row: dict, fns: dict, costs: dict, iters: int) -> dict:
    """Adds to a kernel-check row the back-to-back ``ms`` of the kernel,
    the plain version and the library call, their device times
    (``device_ms``, ``library_device_ms``: the kernels' own durations) and
    the bound, with the share of it reckoned on the device time."""
    ms = {k: time_ms(fn, iters=iters if k != "plain" else 5)
          for k, fn in fns.items()}
    dev = device_ms({k: fns[k] for k in ("kernel", "library")})
    bound_ms, bound_by = bound(costs, torch.float32)
    row.update({
        "ms": ms["kernel"], "device_ms": dev["kernel"][0],
        "kernels_a_call": dev["kernel"][1], "plain_ms": ms["plain"],
        "library_ms": ms["library"], "library_device_ms": dev["library"][0],
        "library_kernels_a_call": dev["library"][1],
        "bound_ms": bound_ms, "bound_by": bound_by,
        "frac_of_bound": bound_ms / dev["kernel"][0],
        "vs_library_device": dev["kernel"][0] / dev["library"][0],
        "gbps": costs["bytes"] / dev["kernel"][0] / 1e6})
    return row


def check_rmsnorm(gen, n, d, dtype, *, tag="", ld=None):
    """The forward kernel against the plain version, then its times beside
    the plain version's and one ``F.rms_norm``'s (``rmsnorm_times``).
    ``ld``: rows read with that stride (a slice of wider rows)."""
    x = rows_of(gen, n, d, dtype, ld)
    scale = 1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
    eps = 1e-5
    got = rms.rmsnorm(x, scale, eps=eps)
    want = ref.rmsnorm_ref(x, scale, eps=eps)
    err = compare("rmsnorm", got, want, dtype)
    # the library fuses only when the weight has x's dtype, so its weight is
    # the scale rounded to x's dtype (an fp32 weight on bf16 x runs unfused)
    scale_x = scale.to(dtype)
    fns = {"kernel": lambda: rms.rmsnorm(x, scale, eps=eps),
           "plain": lambda: ref.rmsnorm_ref(x, scale, eps=eps),
           "library": lambda: F.rms_norm(x, (d,), scale_x, eps)}
    row = {"name": "rmsnorm", "shape": [n, d],
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "tol": TOL["rmsnorm"][dtype]}
    if ld:
        row["row_stride"] = ld
    # the arithmetic is fp32 on the CUDA cores whatever x's dtype
    rmsnorm_times(row, fns, rms.cost_estimate(x.shape, x.element_size()),
                  iters=50)
    log(f"kernel-check {tag}: {json.dumps(row)}")
    return row


def dscale_magnitude(x, dy, eps: float = 1e-5):
    """Sum over the rows of |dy x r|: the magnitude term of dscale's
    tolerance."""
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (dy.float().abs() * xf.abs() * r).reshape(-1, x.shape[-1]).sum(
        dim=0)


def check_rmsnorm_bwd(gen, n, d, dtype, *, tag="", ld=None):
    """The backward kernel against the plain closed form and against
    autograd through the plain forward, with dscale the same bits on a
    second call; times it beside the plain version and the backward of one
    ``F.rms_norm`` (weight in x's dtype).  ``ld``: x and dy read with that
    row stride."""
    x = rows_of(gen, n, d, dtype, ld)
    dy = rows_of(gen, n, d, dtype, ld)
    scale = 1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
    eps = 1e-5
    dx, dscale = rms.rmsnorm_bwd(x, scale, dy, eps=eps)
    want_dx, want_ds = ref.rmsnorm_bwd_ref(x, scale, dy, eps=eps)
    xr = x.detach().clone().requires_grad_()
    sr = scale.detach().clone().requires_grad_()
    ag_dx, ag_ds = torch.autograd.grad(ref.rmsnorm_ref(xr, sr, eps=eps),
                                       (xr, sr), dy)
    # dscale sums n products dy x r: its rounding grows with the sum of
    # their magnitudes, which a small dscale (terms that cancel) hides
    ds_mag = dscale_magnitude(x, dy, eps)
    dx_err = max(compare("rmsnorm_backward", dx, want_dx, dtype),
                 compare("rmsnorm_backward", dx, ag_dx, dtype))
    ds_err = max(compare("rmsnorm_dscale", dscale, want_ds, dtype, ds_mag),
                 compare("rmsnorm_dscale", dscale, ag_ds, dtype, ds_mag))
    # the error as a share of its limit's magnitude term, for the record
    ds_rel = float(((dscale - want_ds).abs() / (1.0 + ds_mag)).max())
    if not torch.equal(rms.rmsnorm_bwd(x, scale, dy, eps=eps)[1], dscale):
        raise AssertionError(f"rmsnorm_backward {tag}: dscale differs "
                             f"between two calls")
    del want_dx, want_ds, ag_dx, ag_ds, xr, sr, ds_mag
    xl = x.detach().clone().requires_grad_()
    wl = scale.to(dtype).requires_grad_()
    yl = F.rms_norm(xl, (d,), wl, eps)
    fns = {"kernel": lambda: rms.rmsnorm_bwd(x, scale, dy, eps=eps),
           "plain": lambda: ref.rmsnorm_bwd_ref(x, scale, dy, eps=eps),
           "library": lambda: torch.autograd.grad(yl, (xl, wl), dy,
                                                  retain_graph=True)}
    row = {"name": "rmsnorm_backward", "shape": [n, d],
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": max(dx_err, ds_err), "dx_err": dx_err,
           "tol": TOL["rmsnorm_backward"][dtype], "dscale_err": ds_err,
           "dscale_err_rel": ds_rel,
           "dscale_tol": TOL["rmsnorm_dscale"][dtype],
           "dscale_same_bits": True}
    if ld:
        row["row_stride"] = ld
    rmsnorm_times(row, fns, rms.bwd_cost_estimate(x.shape, x.element_size()),
                  iters=20)
    row["vs_library"] = row["ms"] / row["library_ms"]
    log(f"kernel-check {tag}: {json.dumps(row)}")
    return row


def check_rmsnorm_split(gen, n, d, dtype, *, tag=""):
    """The statistic-from-outside kernels, forward and backward, on rank
    0's ``d`` columns of rows of ``2 * d`` (two "model" ranks): x read as
    the first half of each row (a row stride of 2d), ``reduce`` adding the
    other half's fp32 partial sums (the plain version's), against the
    plain norm of the whole rows cut to those columns (forward: y; backward:
    dx and dscale, dscale held as ``check_rmsnorm_bwd`` holds it).  Times
    each with an identity ``reduce`` (the kernels alone) beside the plain
    version's, with ``F.rms_norm`` on the same (n, d) rows as a yardstick
    (no library call normalises by an outside statistic: ``library_ms``
    null).  Returns the forward's and the backward's rows."""
    full = torch.randn((n, 2 * d), generator=gen, device="cuda", dtype=dtype)
    dy_full = torch.randn((n, 2 * d), generator=gen, device="cuda",
                          dtype=dtype)
    scale_full = 1.0 + 0.1 * torch.randn((2 * d,), generator=gen,
                                         device="cuda")
    eps = 1e-5
    x, dy, scale = full[:, :d], dy_full[:, :d], scale_full[:d]
    other = full[:, d:].float()
    other_ss = other.square().sum(-1)
    other_dot = (other * dy_full[:, d:].float() * scale_full[d:]).sum(-1)
    y, ss = rms.rmsnorm_split(x, scale, width=2 * d,
                              reduce=lambda t: t + other_ss, eps=eps)
    want_y = ref.rmsnorm_ref(full, scale_full, eps=eps)[:, :d]
    y_err = compare("rmsnorm_split", y, want_y, dtype)
    dx, dscale = rms.rmsnorm_split_bwd(x, scale, dy, ss, width=2 * d,
                                       reduce=lambda t: t + other_dot,
                                       eps=eps)
    want_dx, want_ds = ref.rmsnorm_bwd_ref(full, scale_full, dy_full,
                                           eps=eps)
    dx_err = compare("rmsnorm_split_backward", dx, want_dx[:, :d], dtype)
    ds_mag = dscale_magnitude(full, dy_full, eps)[:d]
    ds_err = compare("rmsnorm_dscale", dscale, want_ds[:d], dtype, ds_mag)
    del want_y, want_dx, want_ds, other, ds_mag
    same = ss.clone()

    def ident(t):
        return t
    scale_x = scale.to(dtype)
    xc = x.contiguous()
    rows = []
    for name, err, fns, costs, iters in (
            ("rmsnorm_split", y_err, {
                "kernel": lambda: rms.rmsnorm_split(
                    x, scale, width=2 * d, reduce=ident, eps=eps),
                "plain": lambda: ref.rmsnorm_split_ref(
                    x, scale, width=2 * d, reduce=ident, eps=eps),
                "yardstick": lambda: F.rms_norm(xc, (d,), scale_x, eps)},
             rms.split_cost_estimate(x.shape, x.element_size()), 50),
            ("rmsnorm_split_backward", max(dx_err, ds_err), {
                "kernel": lambda: rms.rmsnorm_split_bwd(
                    x, scale, dy, same, width=2 * d, reduce=ident, eps=eps),
                "plain": lambda: ref.rmsnorm_split_bwd_ref(
                    x, scale, dy, same, width=2 * d, reduce=ident,
                    eps=eps)},
             rms.split_bwd_cost_estimate(x.shape, x.element_size()), 20)):
        ms = {k: time_ms(fn, iters=iters if k != "plain" else 5)
              for k, fn in fns.items()}
        dev = device_ms({"kernel": fns["kernel"]})
        bound_ms, bound_by = bound(costs, torch.float32)
        row = {"name": name, "shape": [n, d], "width": 2 * d,
               "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err, "tol": TOL[name][dtype],
               "ms": ms["kernel"], "device_ms": dev["kernel"][0],
               "kernels_a_call": dev["kernel"][1], "plain_ms": ms["plain"],
               "library_ms": None, "bound_ms": bound_ms,
               "bound_by": bound_by,
               "frac_of_bound": bound_ms / dev["kernel"][0],
               "gbps": costs["bytes"] / dev["kernel"][0] / 1e6}
        if "yardstick" in ms:
            row["f_rms_norm_ms"] = ms["yardstick"]
        if name == "rmsnorm_split_backward":
            row.update({"dx_err": dx_err, "dscale_err": ds_err,
                        "dscale_tol": TOL["rmsnorm_dscale"][dtype]})
        log(f"kernel-check {tag}: {json.dumps(row)}")
        rows.append(row)
    return rows


def rmsnorm_vs_library(gen, plen: int, rounds: int = 11) -> list:
    """The bf16 rmsnorm kernel against ``F.rms_norm`` (weight in x's dtype)
    at the served shapes: prefill (granite, zamba2, zamba2's gated norm),
    decode, and the narrow rows (MLA's ``kv_norm`` at prefill and in
    training, the lms-demo train CLI).  Each value is the median over
    ``rounds`` timings taken in turns (kernel, library, then library,
    kernel, ...), so drift on the card falls on both alike."""
    rows = []
    for n, d in ((8 * plen, 4096), (8 * plen, 3584), (8 * plen, 7168),
                 (8, 4096), (8, 3584), (8 * plen, 512), (4096, 512),
                 (2048, 512)):
        x = torch.randn((n, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        scale = 1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
        scale_x = scale.to(x.dtype)
        fns = {"kernel": lambda: rms.rmsnorm(x, scale),
               "library": lambda: F.rms_norm(x, (d,), scale_x, 1e-5)}
        times = {"kernel": [], "library": []}
        for i in range(rounds):
            for name in (("kernel", "library") if i % 2 == 0
                         else ("library", "kernel")):
                times[name].append(time_ms(fns[name], iters=50))
        k = statistics.median(times["kernel"])
        lib = statistics.median(times["library"])
        row = {"shape": [n, d], "kernel_ms": k, "library_ms": lib,
               "kernel_over_library": k / lib, "rounds": rounds}
        log(f"rmsnorm-interleaved: {json.dumps(row)}")
        rows.append(row)
    return rows


def check_ssd(gen, b, l, h, g, dtype, *, decay=0.1, init=True, tag=""):
    """Times the kernel as the served path calls it: model-layout (B, L, H,
    P) x through ``ops.ssd_chunked_kernel``, with b/c strided slices of one
    (B, L, 2*G*N) activation (G groups shared by the H heads, read through
    strides) and an initial state.  Checks y and the final state."""
    dev = torch.device("cuda")
    p = n = 64
    x = torch.randn((b, l, h, p), generator=gen, device=dev, dtype=dtype)
    a = -decay * torch.randn((b, l, h), generator=gen, device=dev).abs()
    bc = torch.randn((b, l, 2 * g * n), generator=gen, device=dev,
                     dtype=dtype)
    bm = bc[..., :g * n].view(b, l, g, n)
    cm = bc[..., g * n:].view(b, l, g, n)
    s0 = torch.randn((b, h, p, n), generator=gen, device=dev) if init \
        else None
    y, state = ops.ssd_chunked_kernel(x, a, bm, cm, s0)
    args = (x.transpose(1, 2), a.transpose(1, 2), bm.transpose(1, 2),
            cm.transpose(1, 2), s0)
    want_y, want_state = ref.ssd_ref(*args)
    err = max(compare("ssd_scan", y.transpose(1, 2), want_y, dtype),
              compare("ssd_scan", state, want_state, dtype))
    del want_y, want_state
    ms = time_ms(lambda: ops.ssd_chunked_kernel(x, a, bm, cm, s0))
    plain_ms = time_ms(lambda: ref.ssd_ref(*args), iters=3, warmup=1)
    costs = ssd.cost_estimate(args[0].shape, g, n, x.element_size(),
                              init_state=init)
    # the bound is at the input dtype's peak: bf16 on the tensor cores,
    # where the bf16 kernel runs; fp32 on the CUDA cores, where the fp32
    # kernel runs
    bound_ms, bound_by = bound(costs, dtype)
    row = {"name": "ssd_scan", "shape": [b, l, h, g, p, n],
           "dtype": str(dtype).replace("torch.", ""), "decay": decay,
           "init_state": init, "max_abs_err": err,
           "tol": TOL["ssd_scan"][dtype], "ms": ms, "plain_ms": plain_ms,
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
           "frac_of_bound": bound_ms / ms,
           "tflops": costs["flops"] / ms / 1e9}
    log(f"kernel-check {tag}: {json.dumps(row)}")
    return row


SSD_GRADS = ("dx", "da", "db", "dc", "d_init")


def ssd_bwd_inputs(gen, b, l, h, g, dtype, *, decay=0.1, init=False):
    """Kernel-layout SSD backward inputs as the model hands them over:
    transposed views of model-layout x, a and dy, b/c strided slices of one
    (B, L, 2*G*N) activation; with ``init`` an initial state and a final
    state's gradient."""
    dev = torch.device("cuda")
    p = n = 64
    x = torch.randn((b, l, h, p), generator=gen, device=dev, dtype=dtype)
    a = -decay * torch.randn((b, l, h), generator=gen, device=dev).abs()
    bc = torch.randn((b, l, 2 * g * n), generator=gen, device=dev,
                     dtype=dtype)
    dy = torch.randn((b, l, h, p), generator=gen, device=dev, dtype=dtype)
    s0 = torch.randn((b, h, p, n), generator=gen, device=dev) if init \
        else None
    ds = torch.randn((b, h, p, n), generator=gen, device=dev) if init \
        else None
    return (x.transpose(1, 2), a.transpose(1, 2),
            bc[..., :g * n].view(b, l, g, n).transpose(1, 2),
            bc[..., g * n:].view(b, l, g, n).transpose(1, 2),
            dy.transpose(1, 2), s0, ds)


def ssd_bwd_gaps(got, want) -> dict:
    """Per gradient, the largest of |got - want| / (1 + |want|), the
    quantity ``compare`` holds to the tolerance."""
    return {k: float(((g.float() - w.float()).abs()
                      / (1.0 + w.float().abs())).max())
            for k, g, w in zip(SSD_GRADS, got, want) if w is not None}


def check_ssd_bwd(gen, b, l, h, g, dtype, *, decay=0.1, init=False,
                  tag=""):
    """The SSD backward kernel against ``ref.ssd_bwd_ref`` (autograd
    through the chunked plain form) on the same inputs, called as the
    autograd Function calls it; every gradient within the tolerance, the
    relative gaps logged beside it."""
    args = ssd_bwd_inputs(gen, b, l, h, g, dtype, decay=decay, init=init)
    got = ssd.ssd_scan_bwd(*args)
    want = ref.ssd_bwd_ref(*args)
    errs = {k: compare("ssd_scan_backward", gt, w, dtype, what=k)
            for k, gt, w in zip(SSD_GRADS, got, want) if w is not None}
    gaps = ssd_bwd_gaps(got, want)
    control = None
    if dtype == torch.float32:
        # the fp32 limit must reject fp32 gradients rounded to bf16
        control = max(ssd_bwd_gaps([None if t is None else t.bfloat16()
                                    for t in got], want).values())
        if not control > TOL["ssd_scan_backward"][dtype]:
            raise AssertionError(
                f"ssd_scan_backward: gradients rounded to bf16 pass the fp32 "
                f"limit (gap {control:.3e}); the check cannot tell fp32 "
                f"from bf16")
    del got, want
    ms = time_ms(lambda: ssd.ssd_scan_bwd(*args))
    plain_ms = time_ms(lambda: ref.ssd_bwd_ref(*args), iters=2, warmup=1)
    x, bm = args[0], args[2]
    costs = ssd.bwd_cost_estimate(x.shape, g, bm.shape[-1], x.element_size(),
                                  init_state=init)
    # the bound is at the input dtype's peak, as the forward's.  Beside it:
    # the fp32 kernel's own floor (its operations on the CUDA cores at
    # fp32's peak), and the kernels' scratch traffic (the chunk-start
    # states and the db/dc partials, each written and read once) at the
    # memory rate, which the function's bound does not count
    bound_ms, bound_by = bound(costs, dtype)
    scratch = ssd.bwd_scratch(x.shape, ssd.bwd_partials(dtype, h, g))[
        "bytes"]
    row = {"name": "ssd_scan_backward", "shape": [b, l, h, g, 64, 64],
           "dtype": str(dtype).replace("torch.", ""), "decay": decay,
           "init_state": init, "max_abs_err": max(errs.values()),
           **{f"{k}_err": v for k, v in errs.items()},
           "rel_gaps": gaps, "bf16_control_gap": control,
           "fp32_cores_ops_ms": costs["flops"] / PEAK_FLOPS[torch.float32]
           * 1e3 if dtype == torch.float32 else None,
           "scratch_bytes": scratch,
           "scratch_ms": scratch / PEAK_BYTES * 1e3,
           "tol": TOL["ssd_scan_backward"][dtype],
           "ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "frac_of_bound": bound_ms / ms,
           "tflops": costs["flops"] / ms / 1e9}
    log(f"kernel-check {tag}: {json.dumps(row)}")
    return row


def kernel_checks(plen: int, lplen: int) -> dict:
    """All kernel checks; returns, per served model, the rows at that
    path's own prefill shapes (S = the served batch's padded prompt
    length: ``plen``, or ``lplen`` for the long-context workload):
    {model: {kernel: row}}, with zamba2's gated norm (d=7168) under
    "rmsnorm_gated"."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    for dt in (bf16, f32):
        check_flash(gen, 8, 32, 8, 1024, 128, dt, tag="granite-prefill")
        check_flash(gen, 8, 8, 4, 1024, 64, dt, tag="lms-demo-prefill")
        check_flash(gen, 8, 32, 8, 1024, 128, dt, window=256, tag="window")
        check_flash(gen, 8, 32, 8, 37, 128, dt, tag="ragged")
        check_flash(gen, 2, 8, 4, 200, 64, dt, causal=False,
                    tag="non-causal")
        check_flash(gen, 2, 32, 32, 300, 112, dt, tag="zamba2-ragged")
        check_flash(gen, 2, 8, 1, 700, 192, dt, window=300, tag="window-192")
        check_rmsnorm(gen, 8 * 1024, 4096, dt, tag="granite-prefill")
        check_rmsnorm(gen, 8, 4096, dt, tag="granite-decode")
        check_rmsnorm(gen, 8 * 1024, 512, dt, tag="lms-demo-prefill")
        check_rmsnorm(gen, 8, 3584, dt, tag="zamba2-decode")
        check_rmsnorm(gen, 1, 4096, dt, tag="decode-1")
        check_rmsnorm(gen, 33, 4096, dt, tag="decode-33")
        check_rmsnorm(gen, 8 * 1024, 512, dt, ld=576, tag="strided")
        check_ssd(gen, 8, plen, 112, 1, dt, tag="zamba2-prefill")
        check_ssd(gen, 2, 37, 16, 2, dt, init=False, tag="ragged")
        check_ssd(gen, 2, 200, 8, 1, dt, decay=20.0, tag="strong-decay")
    check_flash(gen, 8, 32, 32, plen, 112, f32, tag="zamba2-prefill")
    check_flash(gen, 8, 96, 8, plen, 192, f32, tag="nemotron-prefill")
    mla = get_config("deepseek-v2-236b").mla
    qk, dv = mla.qk_nope_head_dim + mla.qk_rope_head_dim, mla.v_head_dim
    dcfg = get_config("deepseek-v2-236b")
    mla, dh = dcfg.mla, dcfg.num_heads
    qk, dv = mla.qk_nope_head_dim + mla.qk_rope_head_dim, mla.v_head_dim
    check_flash(gen, 8, dh, dh, plen, qk, f32, dv=dv,
                tag="deepseek-mla-prefill")
    check_flash(gen, 2, 8, 8, 300, qk, bf16, dv=dv, tag="mla-ragged")
    rmsnorm_vs_library(gen, plen)
    # phase 6 (e)'s rows, a run's own: a rank's whole batch, or its rows of
    # the sequence under sequence parallelism, in the run's dtype
    # (MLA's latent norms on every row of the entered sequence; an
    # encoder-decoder's LayerNorms launch no kernel)
    tp = {}
    for case in TP_CASES.values():
        ccfg = get_config(case.model)
        dt = getattr(torch, case.dtype) if case.dtype else bf16
        for path, sp, *_ in case.runs:
            tag = path.replace(":", "-")
            tp[path] = {}
            for key, n, width, ld in norm_rows(ccfg, tp_rows(case, sp),
                                               tp_rows(case, False),
                                               case.mesh[1]):
                if key == "rmsnorm_split":
                    tp[path][key], tp[path][f"{key}_backward"] = \
                        check_rmsnorm_split(gen, n, width, dt, tag=tag)
                    continue
                tp[path][key] = check_rmsnorm(gen, n, width, dt, ld=ld,
                                              tag=tag)
                tp[path][f"{key}_backward"] = check_rmsnorm_bwd(
                    gen, n, width, dt, ld=ld, tag=tag)
            if ccfg.family == "hybrid":
                # the SSD kernels at a rank's heads: the world's own fp32
                # rows, and bf16 at phase 4's training shape; the statistic
                # from outside at phase 4's rows in bf16
                heads = ccfg.ssm.num_heads(ccfg.d_model) // case.mesh[1]
                b, l = case.shape.global_batch, case.shape.seq_len
                tp[path]["ssd_scan"] = check_ssd(gen, b, l, heads, 1, dt,
                                                 init=False, tag=tag)
                tp[path]["ssd_scan_backward"] = check_ssd_bwd(
                    gen, b, l, heads, 1, dt, tag=tag)
                b, l = TRAIN_SHAPE.global_batch, TRAIN_SHAPE.seq_len
                tp[path]["ssd_scan_bf16"] = check_ssd(
                    gen, b, l, heads, 1, bf16, init=False, tag=tag)
                tp[path]["ssd_scan_backward_bf16"] = check_ssd_bwd(
                    gen, b, l, heads, 1, bf16, tag=tag)
                (tp[path]["rmsnorm_split_bf16"],
                 tp[path]["rmsnorm_split_backward_bf16"]) = \
                    check_rmsnorm_split(
                        gen, b * l, ccfg.ssm.d_inner(ccfg.d_model)
                        // case.mesh[1], bf16, tag=tag)
    # phase 6 (f)'s rows: a rank's rows of the batch and its query heads
    for name, world in SERVE_WORLDS.items():
        (b, h, kv, s, d, dv), norms = serve_rank_rows(world)
        tag = f"dist-serve-{name}"
        wcfg = serve_world_cfg(world)
        dt = getattr(torch, wcfg.dtype)
        path = f"dist:serve-{name}"
        tp[path] = {}
        # the world's own dtype, and for an fp32 hybrid world its rank
        # shapes in bf16 too (a bf16 deployment's)
        for sfx, kdt in (("", dt), ("_bf16", bf16)):
            if sfx and (dt == bf16 or wcfg.family != "hybrid"):
                continue
            if wcfg.family != "ssm":          # RWKV6 runs no attention
                tp[path]["flash_attention" + sfx] = check_flash(
                    gen, b, h, kv, s, d, kdt, dv=dv, tag=tag,
                    window=wcfg.sliding_window)
            if wcfg.family == "hybrid":
                tp[path]["ssd_scan" + sfx] = check_ssd(
                    gen, b, s,
                    wcfg.ssm.num_heads(wcfg.d_model) // world.mesh[1], 1,
                    kdt, tag=tag)
            for key, n, width, ld in norms:
                if key != "rmsnorm_split":
                    tp[path][key + sfx] = check_rmsnorm(gen, n, width, kdt,
                                                        ld=ld, tag=tag)
                    continue
                tp[path][key + sfx] = check_rmsnorm_split(
                    gen, n, width, kdt, tag=tag)[0]
                # decode: one row a sequence
                tp[path][f"{key}_decode{sfx}"] = check_rmsnorm_split(
                    gen, b, width, kdt, tag=f"{tag}-decode")[0]
    vcfg = get_config(VLM_MODEL)
    vlen = vlm_seq_len(VLM_GRID, VLM_TEXT)
    scfg = get_config(ENCDEC_MODEL)
    return {
        **tp,
        ENCDEC_MODEL: {
            "flash_attention": check_flash(
                gen, N_REQUESTS, scfg.num_heads, scfg.num_kv_heads, plen,
                scfg.head_dim, bf16, tag="seamless-main-path-prefill")},
        "rwkv6-1.6b": {
            "rmsnorm": check_rmsnorm(gen, 8 * plen,
                                     get_config("rwkv6-1.6b").d_model, bf16,
                                     tag="rwkv6-main-path-prefill")},
        "deepseek-v2-236b": {
            "flash_attention": check_flash(
                gen, 8, dh, dh, plen, qk, bf16, dv=dv,
                tag="deepseek-main-path-prefill"),
            "rmsnorm": check_rmsnorm(gen, 8 * plen, dcfg.d_model, bf16,
                                     tag="deepseek-main-path-prefill"),
            "rmsnorm_q_norm": check_rmsnorm(
                gen, 8 * plen, mla.q_lora_rank, bf16,
                tag="deepseek-main-path-prefill-q-norm"),
            # the latent's rows, read in place from the wkv_a output
            "rmsnorm_kv_norm": check_rmsnorm(
                gen, 8 * plen, mla.kv_lora_rank, bf16,
                ld=mla.kv_lora_rank + mla.qk_rope_head_dim,
                tag="deepseek-main-path-prefill-kv-norm")},
        VLM_MODEL: {
            "flash_attention": check_flash(
                gen, VLM_ROWS, vcfg.num_heads, vcfg.num_kv_heads, vlen,
                vcfg.head_dim, bf16, tag="qwen2-vl-main-path-prefill"),
            "rmsnorm": check_rmsnorm(gen, VLM_ROWS * vlen, vcfg.d_model,
                                     bf16, tag="qwen2-vl-main-path-prefill")},
        "phi3-medium-14b": {
            "flash_attention": check_flash(gen, 8, 40, 10, plen, 128, bf16,
                                           tag="phi3-main-path-prefill"),
            "rmsnorm": check_rmsnorm(gen, 8 * plen, 5120, bf16,
                                     tag="phi3-main-path-prefill")},
        "nemotron-4-340b": {
            "flash_attention": check_flash(gen, 8, 96, 8, plen, 192, bf16,
                                           tag="nemotron-main-path-prefill")},
        "mixtral-8x7b": {
            "flash_attention": check_flash(
                gen, LONG_REQUESTS, 32, 8, lplen, 128, bf16, window=4096,
                tag="mixtral-main-path-prefill"),
            "rmsnorm": check_rmsnorm(gen, LONG_REQUESTS * lplen, 4096, bf16,
                                     tag="mixtral-main-path-prefill")},
        "granite-3-8b": {
            "flash_attention": check_flash(gen, 8, 32, 8, plen, 128, bf16,
                                           tag="main-path-prefill"),
            "rmsnorm": check_rmsnorm(gen, 8 * plen, 4096, bf16,
                                     tag="main-path-prefill")},
        "zamba2-7b": {
            "flash_attention": check_flash(gen, 8, 32, 32, plen, 112, bf16,
                                           tag="zamba2-main-path-prefill"),
            "rmsnorm": check_rmsnorm(gen, 8 * plen, 3584, bf16,
                                     tag="zamba2-main-path-prefill"),
            "rmsnorm_gated": check_rmsnorm(
                gen, 8 * plen, 7168, bf16,
                tag="zamba2-main-path-prefill-gated"),
            "ssd_scan": check_ssd(gen, 8, plen, 112, 1, bf16, init=True,
                                  tag="zamba2-main-path-prefill")},
    }


# ---------------------------------------------------------------------------
# Phase 3: serve granite-3-8b
# ---------------------------------------------------------------------------


class Recorder:
    """Minimal usermetric/markers hooks: keeps what the engine and the
    training loop report."""

    def __init__(self):
        self.metrics = []
        self.events = []
        self.regions = {}

    @property
    def markers(self):
        return self

    def metric(self, name, fields, tags=None, ts=None):
        self.metrics.append((name, dict(fields), tags))

    def event(self, name, text):
        self.events.append((name, text))

    def flush(self):
        pass

    def region(self, name, counters=None):
        return _Region(self, name, counters)

    def record(self, name, seconds, counters=None):
        r = self.regions.setdefault(name, {"calls": 0, "seconds": 0.0})
        r["calls"] += 1
        r["seconds"] += seconds
        for k, v in (counters or {}).items():
            r[k] = r.get(k, 0.0) + v


class _Region:
    """A timed region: a context manager whose ``add`` sums counters."""

    def __init__(self, rec, name, counters):
        self.rec, self.name = rec, name
        self.counters = dict(counters or {})

    def add(self, **c):
        for k, v in c.items():
            self.counters[k] = self.counters.get(k, 0.0) + v

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.rec.record(self.name, time.monotonic() - self.t0,
                        counters=self.counters)
        return False


class RecorderAgent:
    """Host-agent hooks: keeps the step constants and the per-step times."""

    def __init__(self):
        self.constants = {}
        self.steps = []

    def set_step_constants(self, **kwargs):
        self.constants.update(kwargs)

    def collect_step(self, *, step, step_time_s, extra_events=None):
        self.steps.append({"step": step, "step_time_s": step_time_s,
                           **(extra_events or {})})


class RecorderStack:
    """The monitoring-stack hooks ``train()`` calls, recording what the
    loop reports (the port's loop takes any such object)."""

    def __init__(self):
        self.um = Recorder()
        self.agent = RecorderAgent()
        self.jobs = []

    @contextmanager
    def job(self, job_id, user=None, hosts=None, tags=None):
        self.jobs.append(job_id)
        yield

    def host_agent(self, host):
        return self.agent

    def usermetric(self, host=None):
        return self.um

    def on_finding(self, fn):
        return fn

    def findings(self):
        return []


@contextmanager
def plain_kernels():
    """Within the block every kernel wrapper computes its plain version,
    on the card too (and counts no launch): the same model code then gives
    the plain forward the kernel path is held to."""
    saved = (fa.flash_attention, rms.rmsnorm, rms.rmsnorm_bwd, ssd.ssd_scan,
             ssd.ssd_scan_bwd)

    def attention(q, k, v, *, causal=True, window=0, softcap=0.0):
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    (fa.flash_attention, rms.rmsnorm, rms.rmsnorm_bwd, ssd.ssd_scan,
     ssd.ssd_scan_bwd) = (attention, ref.rmsnorm_ref, ref.rmsnorm_bwd_ref,
                          ref.ssd_ref, ref.ssd_bwd_ref)
    try:
        yield
    finally:
        (fa.flash_attention, rms.rmsnorm, rms.rmsnorm_bwd, ssd.ssd_scan,
         ssd.ssd_scan_bwd) = saved


def block_norms(cfg) -> int:
    """RMSNorms of one attention block: ln1 and ln2, and MLA's q_norm and
    kv_norm; none where the norms are LayerNorms (no kernel), as an RWKV6
    block's are."""
    if cfg.norm_type == "layernorm" or cfg.family == "ssm":
        return 0
    return 4 if cfg.attention_type == "mla" else 2


def no_launches() -> dict:
    """Every kernel's count at 0 (``ops.launch_counts``' keys)."""
    return dict.fromkeys(ops.launch_counts(), 0)


def split_gated_norms(cfg, model: int) -> bool:
    """Whether a hybrid's Mamba2 layers run on a rank's heads on a
    "model" axis of ``model`` ranks, so their gated norms take the
    statistic from outside (``rmsnorm_split``) instead of ``rmsnorm``."""
    if cfg.family != "hybrid" or model == 1:
        return False
    sizes = {"data": 1, "model": model}
    return recurrent_splits(cfg, lambda s: binds_model(
        s, TRAIN_RULES, sizes))["mamba2"]


def expected_launches(cfg, n_batches: int, n_forwards: int,
                      model: int = 1) -> dict:
    """Kernel launches of serving: each prefill batch runs flash once per
    attention layer and the SSD scan once per Mamba2 layer; every forward
    (prefill or decode step) runs rmsnorm once per norm (none where the
    norms are LayerNorms, which have no kernel; MLA's latent norms
    included).  RWKV6 runs neither flash nor SSD, and its one RMSNorm is
    the final norm; an encoder-decoder's flash calls are its decoder's
    self-attention (the encoder and the cross-attention run the plain
    masked attention, as the reference).  ``model``: the "model" ranks
    a serving world splits over (a hybrid's gated norms then run split:
    :func:`split_gated_norms`)."""
    out = no_launches()
    if cfg.family == "hybrid":
        groups = cfg.num_layers // cfg.hybrid.attn_every
        norms = 2 * cfg.num_layers + 2 * groups + 1
        gated = cfg.num_layers if split_gated_norms(cfg, model) else 0
        out.update({"flash_attention": groups * n_batches,
                    "rmsnorm": (norms - gated) * n_forwards,
                    "rmsnorm_split": gated * n_forwards,
                    "ssd_scan": cfg.num_layers * n_batches})
        return out
    norms = block_norms(cfg) * cfg.num_layers + (
        cfg.norm_type != "layernorm")
    attention_layers = 0 if cfg.family == "ssm" else cfg.num_layers
    out.update({"flash_attention": attention_layers * n_batches,
                "rmsnorm": norms * n_forwards})
    return out


def serve(name: str) -> dict:
    """Serve ``name``'s workload at full width (depth as SERVED says),
    check its launches, logits and a short kernel-vs-plain run; the weights
    and caches are freed on return."""
    cfg, prompts, max_len, max_new = serve_plan(name)
    t0 = time.monotonic()
    params = serving_params(cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in flatten(params).values())
    log(f"serve: {name} init {time.monotonic() - t0:.2f} s, "
        f"{n_params} params, layers={cfg.num_layers} d={cfg.d_model}, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")

    rec = Recorder()
    eng = ServingEngine(cfg, params, max_batch=MAX_BATCH, max_len=max_len,
                        usermetric=rec, markers=rec)
    finite = []

    def checked(fn):
        def run(*args):
            logits, cache = fn(*args)
            if logits.shape != (len(prompts), cfg.vocab_padded):
                raise AssertionError(f"logits shape {tuple(logits.shape)}")
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        return run
    eng.prefill, eng.decode = checked(eng.prefill), checked(eng.decode)
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    done = eng.run_until_empty()
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del eng

    if len(done) != len(prompts) or any(len(r.output) != max_new
                                        for r in done):
        raise AssertionError("not every request got its tokens")
    if not all(bool(f) for f in finite):
        raise AssertionError("non-finite logits")
    n_batches = math.ceil(len(prompts) / MAX_BATCH)
    want = expected_launches(cfg, n_batches,
                             n_batches * max_new)  # 1 prefill + decode
    if counts != want:
        raise AssertionError(f"{name}: launch counts {counts}, expected "
                             f"{want}")

    pre = [f for n, f, _ in rec.metrics if n == "serve_prefill"]
    dec = [f for n, f, _ in rec.metrics if n == "serve_decode"]
    reqs = [f for n, f, _ in rec.metrics if n == "serve_request"]
    out = {"model": name, "layers": cfg.num_layers, "params": n_params,
           "requests": len(prompts), "max_new": max_new, "max_len": max_len,
           "wall_s": wall_s,
           "prefill_s": sum(f["prefill_time_s"] for f in pre),
           "prompt_len": max(f["prompt_len"] for f in pre),
           "ttft_s_max": max(f["ttft_s"] for f in reqs),
           "ttft_s_mean": sum(f["ttft_s"] for f in reqs) / len(reqs),
           # the engine's rate counts each request's first token, which
           # prefill made; the step rate counts only what decode made
           "decode_tokens_per_s": dec[0]["tokens_per_s"],
           "decode_step_tokens_per_s": sum(
               f["new_tokens"] - f["batch"] for f in dec) / sum(
               f["decode_time_s"] for f in dec),
           "decode_s": sum(f["decode_time_s"] for f in dec),
           "peak_memory_gb": peak_gb, "launches": counts,
           "regions": sorted(rec.regions)}
    if cfg.attention_type == "mla":
        # a token's cache a layer: the latent and the shared rope key,
        # against the per-head K (nope + rope) and V it stands for
        a = cfg.mla
        out["cache_bytes_per_token_layer"] = 2 * (a.kv_lora_rank
                                                  + a.qk_rope_head_dim)
        out["decompressed_kv_bytes_per_token_layer"] = 2 * cfg.num_heads * (
            a.qk_nope_head_dim + a.qk_rope_head_dim + a.v_head_dim)
    log(f"serve: {json.dumps(out)}")

    if cfg.family == "hybrid":
        # In bf16 the hybrid's prefill rounds x * dt to bf16 before the scan
        # where decode keeps it in fp32 (as the reference does), and each
        # rounding difference grows through the 81 random-weight layers to a
        # few percent of the largest logit, the size of MODEL_TOL, with the
        # plain versions on both sides.  In fp32 (weights cast once, fp32
        # KV cache) prefill and decode compute the same function, so the
        # check there is sharp.
        params32 = unflatten({k: v.float()
                              for k, v in flatten(params).items()})
        model_check(params32, dataclasses.replace(cfg, dtype="float32"),
                    prompts[0][:64], cache_dtype=torch.float32)
        del params32
    elif cfg.family == "ssm":
        rwkv_checks(params, cfg, prompts[0][:64], out["prompt_len"])
    elif cfg.moe is not None:
        # A prompt past the window, so that prefill fills the ring from its
        # tail and decode wraps it.  In bf16 the kernel and plain paths
        # round each layer's activations differently, which can flip a
        # near-tied second expert (measured here at the served depth, not
        # a check); in fp32 the two paths compute one function and must
        # route the checked token alike in every layer.  The served layers
        # do not fit in fp32 beside anything: MOE_CHECK_LAYERS of them,
        # made from the served weights as the bf16 ones are dropped.
        prompt = prompts[0][:cfg.sliding_window + MIX_CHECK_TAIL]
        route_agreement(params, cfg, prompt)
        flat = flatten(params)
        del params
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    num_layers=MOE_CHECK_LAYERS[name])
        params32 = unflatten(fp32_prefix(flat, cfg32))
        torch.cuda.empty_cache()
        model_check(params32, cfg32, prompt, cache_dtype=torch.float32)
        del params32
    else:
        model_check(params, cfg, prompts[0][:64])
    return out


def run_serve_fns(cfg, params, toks, extras, max_len: int, new: int, *,
                  decode_extras=None, markers=None) -> dict:
    """Serve one batch through ``make_serve_fns``, as the engine would with
    the extras it does not pass: one prefill of ``toks`` (B, S) with
    ``extras`` into a cache of ``max_len``, then ``new - 1`` greedy decode
    steps (``decode_extras(k)``: step k's extras, e.g. a VLM's M-RoPE
    positions), under ``markers``' ``serve:prefill`` / ``serve:decode``
    regions when given.  Each step's logits must be finite and
    (B, vocab_padded).  Returns the seconds of each phase and the greedy
    tokens (B, new); the cache is freed on return."""
    rows, s = toks.shape
    prefill, decode = make_serve_fns(cfg)
    region = markers.region if markers is not None else \
        (lambda name, counters=None: nullcontext())
    out = []

    def take(logits):
        if logits.shape != (rows, cfg.vocab_padded):
            raise AssertionError(f"logits shape {tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite logits")
        nxt = torch.argmax(logits, dim=-1)
        out.append(nxt.cpu())
        return nxt

    with torch.inference_mode():
        t0 = time.monotonic()
        with region("serve:prefill"):
            cache = init_cache(cfg, rows, max_len, device=toks.device)
            logits, cache = prefill(params, toks, cache, extras)
            nxt = take(logits)                # sync: real prefill time
        prefill_s = time.monotonic() - t0
        t0 = time.monotonic()
        with region("serve:decode"):
            for k in range(new - 1):
                logits, cache = decode(
                    params, cache, nxt[:, None], s + k,
                    None if decode_extras is None else decode_extras(k))
                nxt = take(logits)
        decode_s = time.monotonic() - t0
    return {"prefill_s": prefill_s, "decode_s": decode_s,
            "tokens": torch.stack(out, dim=1)}


def served_by_fns(name, cfg, params, toks, extras, max_len, new,
                  decode_extras=None) -> dict:
    """``run_serve_fns`` on the served weights with the launches zeroed
    just before and read just after, checked against
    ``expected_launches``; returns the run's numbers."""
    rows, s = toks.shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = run_serve_fns(cfg, params, toks, extras, max_len, new,
                        decode_extras=decode_extras)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = expected_launches(cfg, 1, new)
    if counts != want:
        raise AssertionError(f"{name}: launch counts {counts}, expected "
                             f"{want}")
    steps = new - 1
    n_params = sum(t.numel() for t in flatten(params).values())
    return {"model": name, "layers": cfg.num_layers, "params": n_params,
            "rows": rows, "prompt_len": s, "max_new": new,
            "max_len": max_len, "served_by": "make_serve_fns",
            "prefill_s": res["prefill_s"], "ttft_s": res["prefill_s"],
            "decode_s": res["decode_s"],
            "decode_step_tokens_per_s": rows * steps / res["decode_s"],
            "decode_tokens_per_s": rows * new / res["decode_s"],
            "peak_memory_gb": peak_gb, "launches": counts,
            "first_row_tokens": res["tokens"][0, :8].tolist()}


def serve_vlm(name: str = VLM_MODEL) -> dict:
    """Serve the VLM at full width and depth through ``make_serve_fns``
    with its extras (the engine passes none, as the reference's does, so
    an M-RoPE model cannot go through it): one prefill of VLM_ROWS rows of
    an image and text, then VLM_NEW - 1 greedy decode steps whose M-RoPE
    positions continue the text's (they differ from the cache slot).
    Checks shapes, finite logits and launches, then an fp32 model check at
    VLM_CHECK_LAYERS layers on an input of the same kind; the weights are
    freed on return."""
    cfg = get_config(name)
    t0 = time.monotonic()
    params = serving_params(cfg)
    torch.cuda.synchronize()
    log(f"serve: {name} init {time.monotonic() - t0:.2f} s, "
        f"layers={cfg.num_layers} d={cfg.d_model}, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    dev = params["final_norm"]["scale"].device
    toks, extras = vlm_inputs(cfg, VLM_ROWS, VLM_GRID, VLM_TEXT,
                              torch.bfloat16, dev)
    text_pos = int(extras["mrope_pos"].max()) + 1
    out = served_by_fns(
        name, cfg, params, toks, extras, VLM_MAX_LEN, VLM_NEW,
        decode_extras=lambda k: {"mrope_pos": torch.full(
            (VLM_ROWS, 1, 3), text_pos + k, dtype=torch.long, device=dev)})
    out.update({"patches": VLM_GRID * VLM_GRID, "text_tokens": VLM_TEXT})
    log(f"serve: {json.dumps(out)}")

    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=VLM_CHECK_LAYERS)
    flat = flatten(params)
    del params
    params32 = unflatten(fp32_prefix(flat, cfg32))
    torch.cuda.empty_cache()
    ctoks, cextras = vlm_inputs(cfg32, 1, VLM_CHECK_GRID, VLM_CHECK_TEXT,
                                torch.float32, dev)
    model_check(params32, cfg32, ctoks[0].tolist(), cache_dtype=torch.float32,
                extras=cextras)
    del params32
    return out


def right_aligned(prompts, dev) -> torch.Tensor:
    """(B, S) tokens on ``dev``: the prompts right-aligned and BOS-padded
    to the longest, as the engine aligns them."""
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    return torch.from_numpy(toks).to(dev)


def encdec_inputs(cfg, prompts, frames: int, dtype, dev) -> tuple:
    """(tokens (B, S), extras) of the encoder-decoder workload on ``dev``:
    the prompts right-aligned (:func:`right_aligned`) and ``src_frames``
    (B, frames, d) from N(0, 0.02^2) seeded by SEED, in ``dtype``."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    src = 0.02 * torch.randn((len(prompts), frames, cfg.d_model),
                             generator=gen, device=dev)
    return right_aligned(prompts, dev), {"src_frames": src.to(dtype)}


def serve_encdec(name: str = ENCDEC_MODEL) -> dict:
    """Serve the encoder-decoder at full width and depth through
    ``make_serve_fns`` with its source frames (the engine passes none, as
    the reference's): the short workload's prompts over N_REQUESTS rows of
    encdec_source_len frames, then MAX_NEW - 1 decode steps that read the
    cross K/V (bf16) from the cache.  Checks shapes, finite logits and
    launches (flash once per decoder layer a prefill, no RMSNorm: its norms
    are LayerNorms), then an fp32 model check at ENCDEC_CHECK_LAYERS
    encoder and decoder layers; the weights are freed on return."""
    cfg = get_config(name)
    t0 = time.monotonic()
    params = serving_params(cfg)
    torch.cuda.synchronize()
    log(f"serve: {name} init {time.monotonic() - t0:.2f} s, "
        f"layers={cfg.num_encoder_layers}+{cfg.num_layers} "
        f"d={cfg.d_model}, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    dev = params["final_norm"]["scale"].device
    prompts = smoke_prompts(cfg)
    toks, extras = encdec_inputs(cfg, prompts, cfg.encdec_source_len,
                                 torch.bfloat16, dev)
    out = served_by_fns(name, cfg, params, toks, extras, MAX_LEN, MAX_NEW)
    out.update({"encoder_layers": cfg.num_encoder_layers,
                "source_frames": cfg.encdec_source_len})
    log(f"serve: {json.dumps(out)}")

    cfg32 = dataclasses.replace(
        cfg, dtype="float32", num_layers=ENCDEC_CHECK_LAYERS,
        num_encoder_layers=ENCDEC_CHECK_LAYERS,
        encdec_source_len=ENCDEC_CHECK_FRAMES)
    flat = flatten(params)
    del params
    params32 = unflatten(fp32_prefix(flat, cfg32))
    torch.cuda.empty_cache()
    ctoks, cextras = encdec_inputs(cfg32, [prompts[0][:64]],
                                   ENCDEC_CHECK_FRAMES, torch.float32, dev)
    model_check(params32, cfg32, ctoks[0].tolist(), cache_dtype=torch.float32,
                extras=cextras)
    del params32
    return out


def check_wkv(gen, b, l, cfg) -> dict:
    """RWKV6's chunked WKV recurrence (plain PyTorch, not a kernel) against
    its sequential oracle ``ref.wkv6_ref`` in fp32 at (b, l) and the
    model's heads, with an initial state: output and final state within
    TOL["wkv6"], the chunk that ``wkv6_chunked``'s gcd rule takes at l, and
    both timed."""
    dev = gen.device
    h, d = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    r, k, v = (torch.randn((b, l, h, d), generator=gen, device=dev)
               for _ in range(3))
    logw = -0.5 * torch.randn((b, l, h, d), generator=gen, device=dev).abs()
    u = 0.5 * torch.randn((h, d), generator=gen, device=dev)
    s0 = torch.randn((b, h, d, d), generator=gen, device=dev)
    y, state = wkv6_chunked(r, k, v, logw, u, chunk=32, init_state=s0)
    want_y, want_state = ref.wkv6_ref(r, k, v, logw, u, init_state=s0)
    err = max(compare("wkv6", y, want_y, torch.float32),
              compare("wkv6", state, want_state, torch.float32))
    del want_y, want_state
    row = {"name": "wkv6_chunked", "shape": [b, l, h, d],
           "chunk": 32 if l % 32 == 0 else math.gcd(l, 32),
           "max_abs_err": err, "tol": TOL["wkv6"][torch.float32],
           "ms": time_ms(lambda: wkv6_chunked(r, k, v, logw, u, chunk=32,
                                              init_state=s0),
                         iters=3, warmup=1),
           "plain_ms": time_ms(lambda: ref.wkv6_ref(r, k, v, logw, u,
                                                    init_state=s0),
                               iters=1, warmup=1)}
    log(f"wkv: {json.dumps(row)}")
    return row


def rwkv_checks(params, cfg, prompt, plen: int) -> None:
    """RWKV6 in fp32 (all its layers fit): the chunked WKV against its
    sequential oracle at the served prefill shape (N_REQUESTS x ``plen``,
    whose chunk the gcd rule shrinks) and the training length; then the
    model's prefill and decode steps through the caches against plain full
    forwards (``model_check``)."""
    gen = torch.Generator(device=params["final_norm"]["scale"].device)
    gen.manual_seed(SEED)
    for l in (plen, TRAIN_SHAPE.seq_len):
        check_wkv(gen, N_REQUESTS, l, cfg)
    params32 = unflatten({k: v.float() for k, v in flatten(params).items()})
    model_check(params32, dataclasses.replace(cfg, dtype="float32"), prompt,
                cache_dtype=torch.float32)
    del params32


def fp32_prefix(flat: dict, cfg) -> dict:
    """An fp32 copy of the layers of ``cfg`` (a cut of the served config:
    the first of its dense and of its MoE layers, as its layer plan says;
    an encoder-decoder's first encoder and decoder layers) and of the rest
    (embed, norms), from a flat bf16 tree, popping each source leaf as it
    is copied so that the two never sit whole on the card together."""
    if cfg.family == "encdec":
        cut = {"encoder/layers": cfg.num_encoder_layers,
               "dec_layers": cfg.num_layers}
    else:
        plan = _layer_plan(cfg)
        cut = {"dense_layers": plan.get("dense", 0),
               "moe_layers": plan.get("moe", 0)}
    out = {}
    for k in list(flat):
        v = flat.pop(k)
        n = next((c for g, c in cut.items() if k.startswith(g + "/")), None)
        if n is None:
            out[k] = v.float()
        elif n:
            out[k] = v[:n].float()
        del v
    return out


@contextmanager
def recorded_routes(logits=None):
    """Within the block every MoE layer's routing is kept: the experts of
    each token, one (T, k) tensor a layer in call order; and, into the
    list ``logits`` when given, each layer's router logits (T, E) fp32."""
    routes, route_topk = [], moe.route_topk

    def record(router_logits, top_k):
        gates, experts, probs = route_topk(router_logits, top_k)
        routes.append(experts)
        if logits is not None:
            logits.append(router_logits.float())
        return gates, experts, probs
    moe.route_topk = record
    try:
        yield routes
    finally:
        moe.route_topk = route_topk


def routes_differ(got: list, want: list) -> list:
    """Per layer, the tokens of ``got`` routed otherwise than the last
    tokens of ``want`` (a full forward that may see more tokens)."""
    return [int((g != w[-g.shape[0]:]).any(dim=-1).sum())
            for g, w in zip(got, want)]


def bf16_unit(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30)))
                      - 7)


def route_margins(got_logits, want_logits, got, want, top_k: int) -> list:
    """At each (token, layer) pair the two paths route otherwise: whether
    their top-k sets differ ("set") or only the order within them ("rank":
    the same experts and gates, so the same output), and the plain path's
    logit margin that decides it -- between its k-th and (k+1)-th expert
    for a set flip, the smallest between adjacent experts of its top k for
    a rank swap -- in logits and router probabilities, beside one bf16
    unit of those logits and the largest gap between the two paths' logits
    of that token.  Two experts swap only if their margin is at most twice
    that gap (each logit moves by at most the gap); a margin beyond it
    would be a routing fault."""
    rows = []
    for layer, (gz, wz, ge, we) in enumerate(zip(got_logits, want_logits,
                                                 got, want)):
        for t in (ge != we).any(dim=-1).nonzero().flatten().tolist():
            ws = wz[t].sort(descending=True).values[:top_k + 1]
            wp = torch.softmax(wz[t], dim=-1).sort(descending=True).values
            rank = bool((ge[t].sort().values == we[t].sort().values).all())
            j = int((ws[:top_k - 1] - ws[1:top_k]).argmin()) if rank \
                else top_k - 1
            rows.append({
                "layer": layer, "token": t, "kind": "rank" if rank else "set",
                "logit_margin": float(ws[j] - ws[j + 1]),
                "prob_margin": float(wp[j] - wp[j + 1]),
                "bf16_unit": float(bf16_unit(ws[j:j + 2]).max()),
                "paths_logit_gap": float((gz[t] - wz[t]).abs().max())})
    return rows


def route_agreement(params, cfg, prompt) -> dict:
    """The prefill routes of the kernel path against the plain path's at
    the served depth and dtype (a measurement: in bf16 the two paths may
    flip a near-tied expert), with the last logit's relative gap and, at
    each pair routed otherwise, the k-th expert's margin beside one bf16
    unit of the logits and the paths' logit gap (``route_margins``)."""
    dev = params["final_norm"]["scale"].device
    toks = torch.tensor([[int(t) for t in prompt]], device=dev)
    got_z, want_z = [], []
    with torch.inference_mode():
        with recorded_routes(got_z) as got:
            gl, _ = forward(params, cfg, tokens=toks, mode="prefill")
        with plain_kernels(), recorded_routes(want_z) as want:
            wl, _ = forward(params, cfg, tokens=toks, mode="prefill")
    flips = routes_differ(got, want)
    margins = route_margins(got_z, want_z, got, want, cfg.moe.top_k)
    g, w = gl[:, -1].float(), wl[:, -1].float()
    out = {"model": cfg.name, "dtype": cfg.dtype, "layers": cfg.num_layers,
           "tokens": toks.shape[1], "token_layers_routed_otherwise":
           sum(flips), "by_layer": flips,
           "last_token_routed_otherwise": any(
               bool((a[-1] != b[-1]).any()) for a, b in zip(got, want)),
           "last_logit_rel_err": float((g - w).abs().max() / w.abs().max()),
           "argmax_equal": int(g.argmax()) == int(w.argmax()),
           "set_flips": sum(m["kind"] == "set" for m in margins),
           "rank_swaps": sum(m["kind"] == "rank" for m in margins),
           "set_flips_within_one_bf16_unit": sum(
               m["kind"] == "set" and m["logit_margin"] <= m["bf16_unit"]
               for m in margins),
           "flips_within_twice_paths_gap": sum(
               m["logit_margin"] <= 2 * m["paths_logit_gap"]
               for m in margins),
           "largest_margin_over_unit": max(
               (m["logit_margin"] / m["bf16_unit"] for m in margins),
               default=None),
           "largest_margin_over_twice_paths_gap": max(
               (m["logit_margin"] / max(2 * m["paths_logit_gap"], 1e-30)
                for m in margins), default=None),
           "margins": margins}
    log(f"serve: routes {json.dumps(out)}")
    return out


def model_check(params, cfg, prompt, steps: int = 3,
                cache_dtype=torch.bfloat16, extras=None) -> None:
    """A short input through the kernel path -- prefill, then decode steps
    through the caches -- against a plain full forward over the same
    sequence at each step, same weights.  Error relative to the largest
    logit, limit MODEL_TOL; argmax equal at every step; with MoE layers the
    checked (last) token routed alike in every layer.  ``extras``: the
    prompt's modality inputs (a VLM's ``patches`` and ``mrope_pos``, batch
    1); each decoded token takes the next M-RoPE position, the largest so
    far + 1 (t = h = w), in both paths."""
    dev = params["final_norm"]["scale"].device
    seq = [int(t) for t in prompt]
    extras = dict(extras or {})
    routes = recorded_routes if cfg.moe is not None else nullcontext
    cache = init_cache(cfg, 1, len(seq) + steps, dtype=cache_dtype,
                       device=dev)
    with torch.inference_mode():
        toks = torch.tensor([seq], device=dev)
        with routes() as got_routes:
            got, cache = forward(params, cfg, tokens=toks, mode="prefill",
                                 cache=cache, extras=extras)
        for step in range(steps + 1):
            with plain_kernels(), routes() as want_routes:
                want, _ = forward(params, cfg,
                                  tokens=torch.tensor([seq], device=dev),
                                  mode="prefill", extras=extras)
            g, w = got[:, -1].float(), want[:, -1].float()
            err = float((g - w).abs().max())
            rel = err / float(w.abs().max())
            same = int(g.argmax()) == int(w.argmax())
            routed = ""
            last_alike = True
            if cfg.moe is not None:
                flips = routes_differ(got_routes, want_routes)
                last_alike = all(bool((a[-1] == b[-1]).all())
                                 for a, b in zip(got_routes, want_routes))
                routed = (f", tokens routed otherwise by layer {flips}, "
                          f"checked token routed "
                          f"{'alike' if last_alike else 'otherwise'}")
            log(f"serve: model check {cfg.name} {cfg.dtype} "
                f"{'prefill' if step == 0 else 'decode'} at position "
                f"{len(seq) - 1}: max abs logit err {err:.4e}, relative "
                f"{rel:.4e} (limit {MODEL_TOL}), argmax "
                f"{'equal' if same else 'differs'}{routed}")
            if not bool(torch.isfinite(g).all()) or rel > MODEL_TOL \
                    or not same or not last_alike:
                raise AssertionError("kernel-path logits disagree with the "
                                     "plain forward")
            if step == steps:
                break
            seq.append(int(w.argmax()))
            step_extras = {}
            if "mrope_pos" in extras:
                mpos = extras["mrope_pos"]
                nxt = torch.full((1, 1, 3), int(mpos.max()) + 1,
                                 dtype=mpos.dtype, device=dev)
                extras["mrope_pos"] = torch.cat([mpos, nxt], dim=1)
                step_extras = {"mrope_pos": nxt}
            with routes() as got_routes:
                got, cache = forward(params, cfg,
                                     tokens=torch.tensor([[seq[-1]]],
                                                         device=dev),
                                     mode="decode", cache=cache,
                                     pos=len(seq) - 1, extras=step_extras)


# ---------------------------------------------------------------------------
# Phase 4: train
# ---------------------------------------------------------------------------


def train_kernel_checks() -> dict:
    """The backward kernels (and forwards) at the training paths' shapes:
    the RMSNorm backward at granite's (16384, 4096) in bf16 and fp32 and at
    a ragged (4097, 1032); the SSD backward at zamba2's training shape (B=8,
    L=2048, H=112, one group) and at a ragged one (L = 1000, 4 groups of 4
    heads, with an initial state and a final state's gradient), each in
    bf16 and fp32, with zamba2's SSD forward and RMSNorm backward at its
    training shape.  Returns each training path's main rows."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    n = TRAIN_SHAPE.global_batch * TRAIN_SHAPE.seq_len
    b, l = TRAIN_SHAPE.global_batch, TRAIN_SHAPE.seq_len
    d = get_config(TRAIN_MODEL).d_model
    granite = {"rmsnorm_backward": check_rmsnorm_bwd(
        gen, n, d, bf16, tag="train-main-path")}
    check_rmsnorm_bwd(gen, n, d, f32, tag="train")
    check_rmsnorm_bwd(gen, 4097, 1032, bf16, tag="ragged")
    check_rmsnorm_bwd(gen, 1000, 512, f32, ld=576, tag="strided")
    granite["rmsnorm"] = check_rmsnorm(gen, n, d, bf16,
                                       tag="train-main-path")
    zcfg = get_config("zamba2-7b")
    heads = zcfg.ssm.num_heads(zcfg.d_model)
    zamba = {"ssd_scan_backward": check_ssd_bwd(
        gen, b, l, heads, 1, bf16, tag="zamba2-train-main-path")}
    check_ssd_bwd(gen, b, l, heads, 1, f32, tag="zamba2-train")
    for dt in (bf16, f32):
        check_ssd_bwd(gen, 2, 1000, 16, 4, dt, init=True, tag="ragged")
    zamba["ssd_scan"] = check_ssd(gen, b, l, heads, 1, bf16, init=False,
                                  tag="zamba2-train-main-path")
    zamba["rmsnorm_backward"] = check_rmsnorm_bwd(
        gen, n, zcfg.d_model, bf16, tag="zamba2-train-main-path")
    dcfg = get_config("deepseek-v2-236b")
    dshape = TRAIN_SHAPE_OF["deepseek-v2-236b"]
    dn = dshape.global_batch * dshape.seq_len
    deepseek = {}
    latent = dcfg.mla.kv_lora_rank + dcfg.mla.qk_rope_head_dim
    for key, width, ld in (("", dcfg.d_model, None),
                           ("_q_norm", dcfg.mla.q_lora_rank, None),
                           ("_kv_norm", dcfg.mla.kv_lora_rank, latent)):
        tag = f"deepseek-train-main-path{key.replace('_', '-')}"
        deepseek["rmsnorm_backward" + key] = check_rmsnorm_bwd(
            gen, dn, width, bf16, tag=tag, ld=ld)
        deepseek["rmsnorm" + key] = check_rmsnorm(gen, dn, width, bf16,
                                                  tag=tag, ld=ld)
    vd = get_config(VLM_MODEL).d_model
    vlm = {"rmsnorm_backward": check_rmsnorm_bwd(
        gen, n, vd, bf16, tag="qwen2-vl-train-main-path"),
        "rmsnorm": check_rmsnorm(gen, n, vd, bf16,
                                 tag="qwen2-vl-train-main-path")}
    rd = get_config("rwkv6-1.6b").d_model
    rwkv = {"rmsnorm_backward": check_rmsnorm_bwd(
        gen, n, rd, bf16, tag="rwkv6-train-main-path"),
        "rmsnorm": check_rmsnorm(gen, n, rd, bf16,
                                 tag="rwkv6-train-main-path")}
    return {"train:granite-3-8b": granite, "train:zamba2-7b": zamba,
            "train:mixtral-8x7b": {"rmsnorm_backward":
                                   granite["rmsnorm_backward"]},
            "train:deepseek-v2-236b": deepseek, f"train:{VLM_MODEL}": vlm,
            "train:rwkv6-1.6b": rwkv}


def narrow_hybrid(dtype: str = "float32"):
    """zamba2-7b's layout and Mamba2 widths (P = N = 64, so the SSD kernels
    take it) at d_model 1024: 2 groups of 2 Mamba2 layers, each followed
    by one of the 2 shared attention blocks (8 heads of 128), and 1
    trailing layer.  fp32 by default, for the kernel-vs-plain parity: in
    bf16 the kernel path's and the plain path's step-0 gradients each lie
    6.4-6.8% from the fp32 ones (``train_faults.py``'s ``bf16-noise``
    line), above TRAIN_TOL; the bf16 model is held to the fp32 plain path
    at HYBRID_BF16_TOL (``hybrid_bf16_check``)."""
    cfg = get_config("zamba2-7b")
    return dataclasses.replace(
        cfg, name="zamba2-narrow", num_layers=5, d_model=1024, num_heads=8,
        num_kv_heads=8, head_dim=128, d_ff=2048, dtype=dtype,
        hybrid=dataclasses.replace(cfg.hybrid, attn_every=2))


def parity_models() -> dict:
    """The kernel-vs-plain training checks: (config, optimizer) each.  The
    hybrid and the MoE run in fp32, where the two paths compute one
    function (the hybrid's bf16 rounding noise: ``narrow_hybrid``; bf16
    rounding flips near-tied experts: ``route_agreement``)."""
    return {"lms-demo": (get_config("lms-demo"), "adamw"),
            "zamba2-narrow-fp32": (narrow_hybrid(), "adamw"),
            "mixtral-8x7b-fp32": (dataclasses.replace(
                get_config("mixtral-8x7b"), num_layers=TRAIN_LAYERS_OF[
                    "mixtral-8x7b"], dtype="float32"), "adafactor")}


def train_launches(cfg, passes: int, model: int = 1) -> dict:
    """Kernel launches of ``passes`` train passes under remat "minimal"
    (forward, the re-run of each checkpointed block, backward; the step's
    flop count runs on meta tensors and launches nothing): an RMSNorm a
    norm forward, again for the norms inside checkpointed blocks (every
    block but the hybrid's shared attention), and a backward a norm; an SSD
    scan a Mamba2 layer, again in its re-run, and a backward; no flash
    (train attention is the masked one).  RWKV6's one RMSNorm, the final
    norm, sits outside the checkpointed blocks; an encoder-decoder's norms
    are LayerNorms.  ``model``: the "model" ranks of a tensor-parallel
    world (a hybrid's gated norms then run split, forward and re-run,
    with their own backward: :func:`split_gated_norms`)."""
    n = cfg.num_layers
    out = no_launches()
    if cfg.family == "hybrid":
        groups = n // cfg.hybrid.attn_every
        norms = 2 * n + 2 * groups + 1     # ln and gated norm a Mamba2 block
        gated = n if split_gated_norms(cfg, model) else 0
        out.update({"rmsnorm": passes * (norms + 2 * n - 2 * gated),
                    "rmsnorm_backward": passes * (norms - gated),
                    "rmsnorm_split": passes * 2 * gated,
                    "rmsnorm_split_backward": passes * gated,
                    "ssd_scan": passes * 2 * n,
                    "ssd_scan_backward": passes * n})
        return out
    per_block = block_norms(cfg)            # ln1, ln2 (+ MLA's 2)
    norms = per_block * n + (cfg.norm_type != "layernorm")   # + the final
    out.update({"rmsnorm": passes * (norms + per_block * n),
                "rmsnorm_backward": passes * norms})
    return out


def parity_run(swap=nullcontext, steps: int = PARITY_STEPS, cfg=None,
               optimizer: str = "adamw") -> dict:
    """One run of ``cfg`` (default lms-demo at full config) from the seed's
    params: the gradients of the first batch by leaf, then ``steps`` (0
    or more) optimizer steps of make_train_step, all within ``swap()``
    (``plain_kernels`` for the plain path).  Returns the per-step metrics,
    the gradients (on the host) and the launches."""
    cfg = cfg or get_config("lms-demo")
    tcfg = TrainConfig(warmup_steps=0, total_steps=max(steps, 1),
                       learning_rate=1e-3, remat_policy="minimal",
                       optimizer=optimizer)
    step_fn, opt = make_train_step(cfg, tcfg)
    params = init_model_params(cfg, seed=SEED, device="cuda")
    state = opt.init(params)
    source = SyntheticTokenSource(cfg.vocab_size, seed=SEED)
    batches = []
    for step in range(max(steps, 1)):
        t = source.batch(step, PARITY_SHAPE.global_batch,
                         PARITY_SHAPE.seq_len)
        batches.append(batch_to_device(
            {"tokens": t[:, :-1], "labels": t[:, 1:]}, "cuda"))
    ops.reset_launch_counts()
    metrics = []
    with swap():
        flat = {k: v.detach().requires_grad_()
                for k, v in flatten(params).items()}
        loss, _ = loss_fn(unflatten(flat), cfg, batches[0],
                          attn_impl=tcfg.attn_impl, remat=tcfg.remat_policy)
        # kept on the host: mixtral's fp32 gradients (12.7 GB) would sit
        # on the card through this run's steps and the other path's run
        grads = {k: g.cpu() for k, g in zip(flat, torch.autograd.grad(
            loss, list(flat.values())))}
        del flat, loss
        for step, batch in enumerate(batches[:steps]):
            params, state, m = step_fn(params, state, batch, step)
            metrics.append({k: float(m[k]) for k in TRAIN_TOL
                            if k != "grads"})
    counts = ops.launch_counts()
    del params, state
    return {"metrics": metrics, "grads": grads, "launches": counts}


def parity_gaps(got: dict, want: dict) -> list:
    """Relative gaps of ``got`` from ``want`` (two parity_run results): per
    step the loss, grad norm and param norm, and at step 0 ``grads``, the
    largest ||g - g_want|| / ||g_want|| over the leaves."""
    grads = max(float((got["grads"][k] - g).norm() / g.norm())
                for k, g in want["grads"].items())
    return [{**{k: abs(a[k] - b[k]) / abs(b[k]) for k in a},
             **({"grads": grads} if step == 0 else {})}
            for step, (a, b) in enumerate(zip(got["metrics"],
                                              want["metrics"]))]


def train_parity(name: str) -> list:
    """A parity model's kernel path (gradients and optimizer steps) against
    the same code with the plain versions swapped in; returns the gaps."""
    cfg, optimizer = parity_models()[name]
    runs = {"kernels": parity_run(cfg=cfg, optimizer=optimizer),
            "plain": parity_run(plain_kernels, cfg=cfg,
                                optimizer=optimizer)}
    passes = PARITY_STEPS + 1                   # + the step-0 gradients
    want = {"kernels": train_launches(cfg, passes),
            "plain": train_launches(cfg, 0)}
    for path, run in runs.items():
        if run["launches"] != want[path]:
            raise AssertionError(f"train parity {name} {path}: launches "
                                 f"{run['launches']}, expected {want[path]}")
    gaps = parity_gaps(runs["kernels"], runs["plain"])
    for step, (a, b, rel) in enumerate(zip(runs["kernels"]["metrics"],
                                           runs["plain"]["metrics"], gaps)):
        log(f"train: parity {name} step {step}: kernels {json.dumps(a)} "
            f"plain {json.dumps(b)} relative {json.dumps(rel)} "
            f"(limits {json.dumps(TRAIN_TOL)})")
        # "not <=" so that a NaN gap fails too
        if not all(math.isfinite(v) for v in a.values()) or \
                not all(v <= TRAIN_TOL[k] for k, v in rel.items()):
            raise AssertionError(f"kernel-path training of {name} disagrees "
                                 f"with the plain path")
    if cfg.family == "hybrid":
        hybrid_bf16_check(runs["plain"]["grads"])
    del runs
    torch.cuda.empty_cache()
    return gaps


def hybrid_bf16_check(fp32_grads: dict) -> float:
    """The narrow hybrid in bf16 through the kernels (``ssd_wgmma_kernel``
    and ``ssd_bwd_wgmma_kernel``, as zamba2's training runs them): its
    step-0 gradients against ``fp32_grads``, the fp32 plain path's, leaf by
    leaf; the largest relative gap must be within HYBRID_BF16_TOL."""
    cfg = narrow_hybrid("bfloat16")
    run = parity_run(cfg=cfg, steps=0)
    if run["launches"] != train_launches(cfg, 1):
        raise AssertionError(f"bf16 hybrid check: launches {run['launches']}"
                             f", expected {train_launches(cfg, 1)}")
    gap = max(float((run["grads"][k].float() - g).norm() / g.norm())
              for k, g in fp32_grads.items())
    log(f"train: bf16 {cfg.name} step-0 gradients vs the fp32 plain path: "
        f"{json.dumps({'grads': gap, 'limit': HYBRID_BF16_TOL})}")
    # "not <=" so that a NaN gap fails too
    if not gap <= HYBRID_BF16_TOL:
        raise AssertionError(f"bf16 kernel-path gradients of {cfg.name} lie "
                             f"{gap:.3e} from the fp32 plain path's")
    return gap


def train_run(model: str) -> dict:
    """``train()`` on ``model`` at full width and TRAIN_LAYERS_OF[model]
    layers; checks steps, finite losses and launch counts; returns the
    numbers (with MoE layers, the aux term and dropped fraction a step)."""
    cfg = dataclasses.replace(get_config(model),
                              num_layers=TRAIN_LAYERS_OF[model])
    shape = TRAIN_SHAPE_OF.get(model, TRAIN_SHAPE)
    # the reference's schedule (100 warmup steps): these are a run's first
    tcfg = TrainConfig(total_steps=TRAIN_STEPS,
                       optimizer=TRAIN_OPTIMIZER[model],
                       remat_policy="minimal", seed=SEED)
    st = RecorderStack()
    metrics = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    result = train(cfg, tcfg, shape, stack=st,
                   job_id=f"chip-smoke-{model}",
                   step_callback=lambda s, m: metrics.append(
                       {k: float(v) for k, v in m.items()}))
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()

    want = train_launches(cfg, TRAIN_STEPS)
    if counts != want:
        raise AssertionError(f"train {model}: launch counts {counts}, "
                             f"expected {want}")
    losses = [m["loss"] for m in metrics]
    if result.steps_run != TRAIN_STEPS or len(losses) != TRAIN_STEPS or \
            not all(math.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"train {model}: {result}, metrics {metrics}")
    times = [s["step_time_s"] for s in st.agent.steps]
    step_s = statistics.median(times[1:])
    c = st.agent.constants
    peak = PEAK_FLOPS[torch.bfloat16]
    if c["PEAK_FLOPS"] != peak:
        raise AssertionError(f"train: step constants carry peak "
                             f"{c['PEAK_FLOPS']}, expected {peak}")
    tokens = shape.global_batch * shape.seq_len
    if c["model_flops"] != 6 * cfg.active_param_count() * tokens:
        raise AssertionError(f"train {model}: model flops "
                             f"{c['model_flops']} are not 6 N T of the "
                             f"active parameters")
    out = {"model": model, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "params": cfg.param_count(),
           # the leaves themselves (RWKV6's count, the reference's, is
           # 6.6% more)
           "leaf_params": sum(math.prod(sp.shape) for sp in flatten(
               model_specs(cfg)).values()),
           "active_params": cfg.active_param_count(),
           "seq_len": shape.seq_len, "global_batch": shape.global_batch,
           "optimizer": tcfg.optimizer, "remat": tcfg.remat_policy,
           "steps": result.steps_run, "wall_s": wall_s,
           "step_times_s": times, "step_s_median_2_6": step_s,
           "tokens_per_s": c["tokens_per_step"] / step_s,
           "mfu_model_flops": c["model_flops"] / step_s / peak,
           "mfu_counted_flops": c["hlo_flops"] / step_s / peak,
           "model_flops": c["model_flops"], "counted_flops": c["hlo_flops"],
           "peak_flops": peak, "peak_memory_gb": peak_gb, "losses": losses,
           **({k: [m[k] for m in metrics] for k in
               ("moe_aux_loss", "moe_dropped_frac", "moe_max_load")}
              if cfg.moe is not None else {}),
           "launches": counts, "regions": sorted(st.um.regions)}
    log(f"train: {json.dumps(out)}")
    out["step_analysis"] = result.step_analysis
    return out


# ---------------------------------------------------------------------------
# Phase 5: monitor -- the CLIs against an HTTP receiver
# ---------------------------------------------------------------------------


class Receiver:
    """A stand-in for a stack's HTTP face (``/ping``, ``/write``,
    ``/job/start``, ``/job/end``, ``/alerts`` with no alerts), on
    ``127.0.0.1`` and a free port: keeps every line it is sent, decoded with
    the port's ``decode_line``, and the job signals in order."""

    def __init__(self):
        self.points = []                # (Point, bytes of its line)
        self.signals = []               # ("start" | "end", jobid)
        self.bad_lines = []
        lock = threading.Lock()
        rec = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code, payload=None):
                body = b"" if code == 204 else json.dumps(
                    payload or {}).encode()
                self.send_response(code)
                if code != 204:
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/ping":
                    self._reply(204)
                elif path == "/alerts":
                    self._reply(200, {"alerts": []})
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                body = self.rfile.read(int(self.headers["Content-Length"]))
                if path == "/write":
                    n = 0
                    with lock:
                        for line in body.decode().split("\n"):
                            if not line.strip():
                                continue
                            try:
                                rec.points.append(
                                    (decode_line(line), len(line) + 1))
                                n += 1
                            except ValueError as e:
                                rec.bad_lines.append(f"{line!r}: {e}")
                    self._reply(200, {"written": n, "errors": []})
                elif path in ("/job/start", "/job/end"):
                    with lock:
                        rec.signals.append((path.rsplit("/", 1)[1],
                                            json.loads(body)["jobid"]))
                    self._reply(200, {"ok": True})
                else:
                    self._reply(404, {"error": "not found"})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        h, p = self.httpd.server_address[:2]
        return f"http://{h}:{p}"

    def measurement(self, name, region=None) -> list:
        return [p for p, _ in self.points if p.measurement == name and (
            region is None or p.tags.get("region") == region)]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=10)


class _Tee(io.TextIOBase):
    """stdout that also keeps what was written."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def run_cli(main_fn, argv, **kw) -> tuple:
    """(printed text, ``client:`` stats) of one CLI call, its output
    printed as it goes."""
    tee = _Tee(sys.stdout)
    with redirect_stdout(tee):
        main_fn(argv, **kw)
    text = tee.buf.getvalue()
    client = [json.loads(line.split(" ", 1)[1]) for line in
              text.splitlines() if line.startswith("client: ")]
    return text, client[-1]


def step_walls(marks, ckpt_interval: int = 0) -> list:
    """Wall seconds of each step from the callbacks' (step, time) marks of
    one run: a step's time is since the previous step's callback; the
    first step of a run and each step after a checkpoint save are left
    out."""
    return [t - t_prev for (s_prev, t_prev), (s, t) in zip(marks, marks[1:])
            if s == s_prev + 1 and not (ckpt_interval and
                                        s_prev % ckpt_interval == 0)]


def monitor_kernel_rows() -> dict:
    """Kernel-vs-plain rows at the two CLI paths' shapes: serve (4 prompts
    of up to 16 tokens a prefill batch; 4 rows a decode step) and train
    (2048 rows of d=512)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16 = torch.bfloat16
    return {
        "serve-cli:lms-demo": {
            "flash_attention": check_flash(gen, 4, 8, 4, 16, 64, bf16,
                                           tag="serve-cli-prefill"),
            "rmsnorm": check_rmsnorm(gen, 4 * 16, 512, bf16,
                                     tag="serve-cli-prefill"),
            "rmsnorm_decode": check_rmsnorm(gen, 4, 512, bf16,
                                            tag="serve-cli-decode")},
        "train-cli:lms-demo": {
            "rmsnorm": check_rmsnorm(gen, 2048, 512, bf16,
                                     tag="train-cli"),
            "rmsnorm_backward": check_rmsnorm_bwd(gen, 2048, 512, bf16,
                                                  tag="train-cli")},
    }


def roofline_frac(tot: dict, peak_flops: float, peak_bw: float) -> float:
    """A marker region's roofline fraction from its summed counters, as
    the stack's ROOFLINE group derives it: achieved FLOP/s over
    min(peak FLOP/s, memory rate x intensity)."""
    return tot["flops"] / tot["time_s"] / min(
        peak_flops, peak_bw * tot["flops"] / tot["bytes"])


def roofline_check(url: str, rec: Receiver, peaks: tuple,
                   dev="cuda") -> dict:
    """``kernel:*`` marker regions at the serve CLI's shapes through a
    marker session of the port's client, under a job on the receiver that
    records ``peaks``; each region's roofline fraction from the received
    sums and the received ``_calib`` peaks."""
    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn((4, 16, 8, 64), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    kv = torch.randn((4, 16, 4, 64), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    x = torch.randn((4 * 16, 512), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    scale = torch.ones(512, device=dev)
    stack = RemoteStack(url)
    job = "chip-smoke-roofline"
    with stack.job(job, user="chip-smoke", hosts=["host0"]):
        um = stack.usermetric(host="host0")
        calibrate(um, *peaks)
        prev = ops.set_kernel_markers(um.markers)
        try:
            for _ in range(20):
                ops.flash_attention_bshd(q, kv, kv, causal=True)
                ops.fused_rmsnorm(x, scale)
        finally:
            ops.set_kernel_markers(prev)
    stack.close()
    calib = rec.measurement("marker", CALIB_REGION)[-1].fields
    pf, bw = calib["peak_flops"], calib["peak_bw"]
    out = {}
    for region in ("kernel:flash_attention", "kernel:rmsnorm"):
        pts = rec.measurement("marker", region)
        tot = {k: sum(p.fields[k] for p in pts)
               for k in ("flops", "bytes", "time_s", "calls")}
        frac = roofline_frac(tot, pf, bw)
        if tot["calls"] != 20 or not 0 < frac <= 1.05:
            raise AssertionError(f"monitor: {region} {tot}, roofline "
                                 f"fraction {frac}")
        out[region] = {"calls": tot["calls"], "roofline_frac": frac}
    return out


def monitor_phase() -> tuple:
    """Drive both CLIs against a receiver and check what arrives; returns
    (the summary, launches by path, the train CLI's hpm, train_step and
    calibration points' fields)."""
    cfg = get_config("lms-demo")
    rec = Receiver()
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                            dir=str(kbuild.BUILD_ROOT.parent))
    base = ["--arch", "lms-demo", "--steps", str(MONITOR_STEPS),
            "--seq-len", str(MONITOR_SEQ), "--global-batch",
            str(MONITOR_BATCH), "--lms-url", rec.url]
    launches, marks, clients = {}, {}, {}
    try:
        # (a) train with a failure at MONITOR_FAIL, then resume
        ops.reset_launch_counts()
        marks["fail"], marks["resume"] = [], []
        argv = base + ["--ckpt-dir", ckpt,
                       "--ckpt-interval", str(MONITOR_CKPT)]
        try:
            run_cli(train_cli.main, argv + ["--fail-at-step",
                                            str(MONITOR_FAIL)],
                    step_callback=lambda s, m: marks["fail"].append(
                        (s, time.monotonic())))
            raise AssertionError("monitor: no injected failure")
        except InjectedFailure:
            pass
        text, clients["train"] = run_cli(
            train_cli.main, argv, step_callback=lambda s, m: marks[
                "resume"].append((s, time.monotonic())))
        torch.cuda.synchronize()
        launches["train-cli:lms-demo"] = ops.launch_counts()
        resumed = MONITOR_FAIL // MONITOR_CKPT * MONITOR_CKPT
        steps = [s for s, _ in marks["fail"] + marks["resume"]]
        if steps != list(range(1, MONITOR_FAIL + 1)) + list(
                range(resumed + 1, MONITOR_STEPS + 1)) or \
                f"resumed_from={resumed}" not in text:
            raise AssertionError(f"monitor: steps run {steps}")
        # (b) the client's cost
        cost = []
        for i, mode in enumerate(COST_RUNS):
            run_marks = []
            ops.reset_launch_counts()
            _, clients[f"cost{i}_{mode}"] = run_cli(
                train_cli.main, base + (["--no-monitor"] if mode == "off"
                                        else []),
                step_callback=lambda s, m: run_marks.append(
                    (s, time.monotonic())))
            cost.append((mode, step_walls(run_marks), ops.launch_counts()))
        # (c) serve
        ops.reset_launch_counts()
        _, clients["serve"] = run_cli(
            serve_cli.main, ["--arch", "lms-demo", "--requests",
                             str(MONITOR_REQUESTS), "--lms-url", rec.url])
        torch.cuda.synchronize()
        launches["serve-cli:lms-demo"] = ops.launch_counts()
        # (d) kernel regions on the card's roofline
        roofline = roofline_check(rec.url, rec,
                                  device_peaks(torch.device("cuda"))[:2])
        # what the monitored train CLI posted, for the analysis phase
        posted = {"hpm": [p.fields for p in rec.measurement("hpm")],
                  "train_step": [p.fields for p in rec.measurement(
                      "marker", "train_step")],
                  "calib": [p.fields for p in rec.measurement(
                      "marker", CALIB_REGION)]}
    finally:
        rec.close()
        shutil.rmtree(ckpt, ignore_errors=True)

    # -- checks --------------------------------------------------------------
    n_monitored = len(steps)
    norms = 2 * cfg.num_layers + 1
    want = {"train-cli:lms-demo": {
        **no_launches(), "rmsnorm": norms * n_monitored,
        "rmsnorm_backward": norms * n_monitored}}
    batches = math.ceil(MONITOR_REQUESTS / 4)       # the CLI's --max-batch
    want["serve-cli:lms-demo"] = expected_launches(cfg, batches,
                                                   batches * 16)
    for path, w in want.items():
        if launches[path] != w:
            raise AssertionError(f"monitor: {path} launches "
                                 f"{launches[path]}, expected {w}")
    for mode, _, counts in cost:
        if counts != {k: v * MONITOR_STEPS // n_monitored
                      for k, v in want["train-cli:lms-demo"].items()}:
            raise AssertionError(f"monitor: cost run ({mode}) launches "
                                 f"{counts}")
    n_hpm = n_monitored + MONITOR_STEPS * COST_RUNS.count("on")
    if rec.bad_lines:
        raise AssertionError(f"monitor: undecodable lines {rec.bad_lines[:3]}")
    train_pts = rec.measurement("train")
    hpm = rec.measurement("hpm")
    if len(train_pts) != n_hpm or len(hpm) != n_hpm:
        raise AssertionError(f"monitor: {len(train_pts)} train and "
                             f"{len(hpm)} hpm points for {n_hpm} "
                             f"monitored steps")
    peak = PEAK_FLOPS[torch.bfloat16]
    tokens = MONITOR_SEQ * MONITOR_BATCH
    model_flops = 6 * cfg.param_count() * tokens
    for p in hpm:
        want_mfu = model_flops / p.fields["step_time_s"] / peak
        if not math.isclose(p.fields["mfu"], want_mfu, rel_tol=1e-9):
            raise AssertionError(f"monitor: mfu {p.fields['mfu']} != "
                                 f"{want_mfu}")
    calib = rec.measurement("marker", CALIB_REGION)
    n_jobs = 2 + len(COST_RUNS) + 2         # + serve, the roofline job
    if len(calib) != n_jobs or any(
            (c.fields["peak_flops"], c.fields["peak_bw"]) !=
            (peak, PEAK_BYTES) for c in calib):
        raise AssertionError(f"monitor: calibration points "
                             f"{[c.fields for c in calib]}")
    starts = [j for kind, j in rec.signals if kind == "start"]
    ends = [j for kind, j in rec.signals if kind == "end"]
    if starts != ends or len(starts) != n_jobs or \
            len(set(starts)) != n_jobs:
        raise AssertionError(f"monitor: job signals {rec.signals}")
    reqs = rec.measurement("serve_request")
    if len(reqs) != MONITOR_REQUESTS:
        raise AssertionError(f"monitor: {len(reqs)} serve_request points")
    if any(c[k] for c in clients.values() for k in (
            "failed_flushes", "failed", "poll_failures", "dropped_points")):
        raise AssertionError(f"monitor: failed posts or polls {clients}")

    walls = {m: [w for mode, ws, _ in cost if mode == m for w in ws]
             for m in ("on", "off")}
    # the whole window (first step's callback to the last's, over the
    # steps) keeps the few steps that post; the medians leave them out
    step_on, step_off = (statistics.fmean(walls["on"]),
                         statistics.fmean(walls["off"]))
    med_on, med_off = (statistics.median(walls["on"]),
                       statistics.median(walls["off"]))
    with_ckpt = statistics.median(
        step_walls(marks["fail"], MONITOR_CKPT) +
        step_walls(marks["resume"], MONITOR_CKPT))
    timed = statistics.median(p.fields["step_time_s"] for p in hpm)
    by_meas: dict = {}
    for p, nbytes in rec.points:
        m = by_meas.setdefault(p.measurement, {"points": 0, "bytes": 0})
        m["points"] += 1
        m["bytes"] += nbytes
    ttft = [p.fields["ttft_s"] for p in reqs]
    lat = [p.fields["latency_s"] for p in reqs]
    out = {"model": cfg.name, "params": cfg.param_count(),
           "seq_len": MONITOR_SEQ, "global_batch": MONITOR_BATCH,
           "steps_monitored": n_monitored, "resumed_from": resumed,
           "step_wall_s_window": step_on,
           "step_wall_s_window_no_monitor": step_off,
           "monitor_cost_s_per_step": step_on - step_off,
           "step_wall_s_median": med_on,
           "step_wall_s_median_no_monitor": med_off,
           "monitor_cost_s_per_step_median": med_on - med_off,
           "step_wall_s_by_cost_run": [
               [mode, statistics.fmean(ws), statistics.median(ws)]
               for mode, ws, _ in cost],
           "step_wall_s_median_with_checkpoints": with_ckpt,
           "step_time_s_median_timed": timed,
           "tokens_per_s": tokens / step_on,
           "mfu_wall": model_flops / step_on / peak,
           "mfu_timed": model_flops / timed / peak,
           "posted_by_measurement": by_meas, "client": clients,
           "client_post_s_per_step": clients["train"]["seconds"] / (
               MONITOR_STEPS - resumed),
           "ttft_s_p50": float(np.percentile(ttft, 50)),
           "latency_s_p50": float(np.percentile(lat, 50)),
           "latency_s_p99": float(np.percentile(lat, 99)),
           "roofline": roofline, "launches": launches}
    log(f"monitor: {json.dumps(out)}")
    return out, launches, posted


# ---------------------------------------------------------------------------
# Phase 6: dist -- the data-parallel training path at world size 1 (NCCL)
# ---------------------------------------------------------------------------

# (a) granite-3-8b at TRAIN_LAYERS_OF's 8 layers, TRAIN_SHAPE, DIST_STEPS
# AdamW steps through make_train_step(mesh=make_mesh_for(1)) against the
# one-device step from the same params and batches (parity_run's settings)
# (2, not 3: a host-staged step of (e)'s worlds costs 9-110 s on an H100,
# and the script has to finish well inside its time limit)
DIST_STEPS = 2
# (b) mixtral-8x7b at 2 layers, bf16, impl="a2a" on the (1, 1) mesh against
# the grouped dispatch: rows x tokens, and a capacity factor of E / k, so
# every expert can take every token (nothing drops on either path)
A2A_ROWS, A2A_SEQ = 2, 2048
# (c) int8 rows: |x - q * scale| <= scale / 2 in exact arithmetic; in fp32
# the quotient x / scale and the product q * scale each round by up to one
# unit in 2^24 of at most 127 scales, 254 such units of scale / 2 in all
INT8_BOUND = 1.0 + 2 * 254 * 2.0 ** -24
# (d) granite's 8 layers as one pipeline stage over the train batch:
# forward only with flash prefill attention, then forward and backward
# (masked attention, remat "minimal", as phase 4's step)
PIPE_MICROBATCHES = 4
# (e) tensor-parallel compute and FSDP: each model of TP_CASES at full
# width and the layers given there, on its (data, model) mesh of that many
# processes sharing the one card over gloo (NCCL refuses two ranks on one
# device), so every exchange is staged through the host; the global batch is
# cut from phase 4's 8 rows to 4 for it.  The runs that share a mesh run
# in one world, one after the other; a run whose rows are not all written
# TP_DEADLINE_S after the previous run's (or the world's start) fails it.
TP_MODEL_AXIS, TP_DEADLINE_S = 2, 300
TP_SHAPE = ShapeConfig("tp_2k_b4", seq_len=2048, global_batch=4,
                       kind="train")
# a rank's counted peak against its max_memory_allocated: the FSDP world's
# limit (the tensor-parallel worlds keep PEAK_TOL)
FSDP_PEAK_TOL = 0.02
# deepseek's world in fp32: one masked score tensor of its 128 heads is
# 2.1 GB a row at 2048 tokens (its 64 heads a rank half that), and its two
# layers' params, gradients and Adafactor state ~43 GB on one device; the
# largest of (2048 x 4), (2048 x 2) and (1024 x 4) whose one-device step
# ``world_count.py`` counts within 75 GB, the two ranks' together too
DEEPSEEK_TP_SHAPE = ShapeConfig("tp_2k_b2", seq_len=2048, global_batch=2,
                                kind="train")


class TpCase(NamedTuple):
    """A model of phase 6 (e): its config cut to ``layers`` (an
    encoder-decoder's encoder and decoder both; in ``dtype``; None: the
    config's), trained by ``optimizer`` for DIST_STEPS steps of
    ``shape`` in ``microbatches`` each under remat "minimal", on a (data,
    model) ``mesh``; ``runs`` are (path, seq_parallel, overrides of
    TRAIN_RULES
    the step stores and computes with[, overlap: the step's exchanges
    overlapped with compute, held to the run before it too]), each against
    the case's one-device step.  Each step's loss, grad norm and param norm are
    held at TRAIN_TOL; with ``step0``, only step 0's (the later ones
    logged), and step 0's gradients too (the largest relative L2 gap over
    the leaves, TRAIN_TOL["grads"]).  A rank's counted peak is held within
    ``peak_tol`` of its ``max_memory_allocated``."""
    model: str
    layers: int
    dtype: Optional[str]
    optimizer: str
    runs: tuple
    step0: bool = False
    mesh: tuple = (1, TP_MODEL_AXIS)
    microbatches: int = 1
    peak_tol: float = PEAK_TOL
    shape: ShapeConfig = TP_SHAPE


# granite-3-8b: 4 of 40 layers, without and with sequence parallelism
# (at 2 layers in bf16 it missed TRAIN_TOL's loss at step 1 on an H100,
# 1.93e-3 of 1e-3, after the one-device loss jumped 11.2 -> 17.9: bf16
# rounding of TP's kind).
# mixtral-8x7b: 2 of 32 layers in fp32 (in bf16 the top-k flips near-tied
# experts, so MoE parity is held in fp32), Adafactor; its 8 experts split 4
# a rank (TRAIN_RULES), then every expert's hidden columns split (the
# binding of the reference's pod16x16, where 8 experts do not divide 16)
# with sequence parallelism.  qwen2-vl-7b: 4 of 28 layers with the loop's
# stub patches and positions, sequence parallelism (28 heads on 2 split),
# in fp32, and in its own bf16, held at step 0 and on step 0's gradients:
# past step 0 the bf16 world has missed TRAIN_TOL (grad norm 1.7e-2 and
# 6.9e-2 at steps 1 and 2 on an H100, where the one-device grad norm jumps
# 79 -> 1094), a gap ``tp_bf16_witness.py`` sets beside bf16's own.
# granite-fsdp: 2 of 40 layers in its own bf16 on (data 2, model 1), 2 rows
# a rank in 2 microbatches: every leaf but the norms split over "data",
# gathered layer by layer in the pass (the matrices and the embedding in
# bf16), its gradient reduce-scattered in the backward; then the same step
# with those exchanges overlapped with compute.  deepseek-v2-236b: its
# dense layer 0 and one MoE layer (2 of 60) in fp32 (MoE parity is held in
# fp32), Adafactor, sequence
# parallelism: MLA's 128 heads 64 a rank, its latent projections and norms
# whole on each rank, 80 experts a rank, the dense layer's columns and the
# shared experts' split; at DEEPSEEK_TP_SHAPE (see there).
# seamless-m4t-large-v2: 4 encoder and 4 decoder layers in fp32, AdamW,
# the loop's stub frames (4096 a row), sequence parallelism over the
# tokens and the frames (both divide 2): 8 heads and 8 KV heads a rank in
# the encoder, the decoder and the cross-attention, the MLP's columns.
# zamba2-7b: 13 of its 81 Mamba2 layers (2 groups of 6, so both shared
# weight sets, and 1 trailing layer) in fp32, AdamW, sequence parallelism:
# 56 SSM heads a rank ([z_r | x_r | BC_r | dt_r] of in_proj, B and C
# gathered), the gated norm's statistic summed over "model", the shared
# blocks' 16 heads and 16 KV heads a rank and their MLP columns.
# rwkv6-1.6b: 8 of 24 layers in fp32, AdamW, sequence parallelism: 16
# heads a rank in the time mix, the channel mix's 3584 hidden and 1024
# output columns a rank (at 2 rows of 2048, not 4, its step-2 grad norm
# missed TRAIN_TOL, 2.7e-2, after the one-device loss jumped 11.6 -> 22.9
# at step 1: fp32 rounding amplified, as ``rwkv6_witness.py`` shows on one
# device; an H100).  zamba2's depth is the most whose one-device step
# ``world_count.py`` counts within 75 GB (PERF.md section 4); rwkv6 ran
# all 24 until its host-staged steps (~36 s each) were cut for time.
ZAMBA2_TP_LAYERS, RWKV6_TP_LAYERS = 13, 8
TP_CASES = {
    "granite": TpCase(TRAIN_MODEL, 4, None, "adamw", (
        ("dist:tp", False, {}), ("dist:tp-sp", True, {}))),
    "mixtral": TpCase("mixtral-8x7b", 2, "float32", "adafactor", (
        ("dist:tp-mixtral-experts", False, {}),
        ("dist:tp-mixtral-hidden-sp", True, {"experts": None}))),
    "qwen2-vl": TpCase(VLM_MODEL, 4, "float32", "adamw", (
        ("dist:tp-qwen2-vl-sp", True, {}),)),
    "qwen2-vl-bf16": TpCase(VLM_MODEL, 4, None, "adamw", (
        ("dist:tp-qwen2-vl-bf16-sp", True, {}),), step0=True),
    "granite-fsdp": TpCase(TRAIN_MODEL, 2, None, "adamw", (
        ("dist:fsdp", False, {}), ("dist:fsdp-overlap", False, {}, True)),
        mesh=(2, 1), microbatches=2, peak_tol=FSDP_PEAK_TOL),
    "deepseek": TpCase("deepseek-v2-236b", 2, "float32", "adafactor", (
        ("dist:tp-deepseek-sp", True, {}),), shape=DEEPSEEK_TP_SHAPE),
    "seamless": TpCase(ENCDEC_MODEL, 4, "float32", "adamw", (
        ("dist:tp-seamless-sp", True, {}),)),
    "zamba2": TpCase("zamba2-7b", ZAMBA2_TP_LAYERS, "float32", "adamw", (
        ("dist:tp-zamba2-sp", True, {}),)),
    "rwkv6": TpCase("rwkv6-1.6b", RWKV6_TP_LAYERS, "float32", "adamw", (
        ("dist:tp-rwkv6-sp", True, {}),)),
}

# After its step, the FSDP world's two processes run a two-stage pipeline
# (PIPE_RUN): a ("pipe",) mesh of the two ranks, each stage
# PIPE_STAGE_LAYERS of granite-3-8b's layers at full width in its bf16 (a
# rank makes its own layers only), the seed's x of TP_SHAPE (seq 2048 x
# batch 4) in PIPE_MICROBATCHES microbatches, forward and backward of the
# loss sum(y * r) (masked attention, remat "minimal") against the
# sequential layers on one device
PIPE_RUN, PIPE_STAGES, PIPE_STAGE_LAYERS = "pipeline", 2, 2


# (f) serving on a mesh: each world of SERVE_WORLDS serves one batch
# through make_serve_fns(cfg, pc=) on a (data, model) mesh of that many
# processes sharing the card over gloo, as (e)'s do: prefill, then
# SERVE_NEW - 1 decode steps teacher-forced with the one-device run's
# greedy tokens (a near tie cannot make the runs part); every step's last
# logits (gathered over "model") within MODEL_TOL of the one-device
# make_serve_fns' on the same params, relative to the largest logit.  The
# worlds that share a mesh run in one world of processes, one after the
# other, each given SERVE_DEADLINE_S as (e)'s runs are given theirs.
SERVE_NEW, SERVE_DEADLINE_S = 32, 300


class ServeWorld(NamedTuple):
    """A world of phase 6 (f): ``model`` cut to ``layers`` (None: all; an
    encoder-decoder's encoder and decoder both), served on a (data, model)
    ``mesh`` under ``SERVE_RULES`` with ``rules`` overridden, on
    ``workload``'s batch ("short": phase 3's 8 prompts, right-aligned to
    910 tokens; "long": mixtral's 4 of 4685-5731 tokens; "vlm": qwen2-vl's
    8 rows of an image and text; "encdec": the short prompts over phase
    3's source frames) in a cache of ``max_len`` (None: the
    workload's), in ``dtype`` (None: the config's)."""
    model: str
    layers: Optional[int]
    mesh: tuple
    rules: dict
    workload: str
    max_len: Optional[int] = None
    dtype: Optional[str] = None


# granite-3-8b at full width and depth: its 8 KV heads split 4 a rank
# (layout "heads", the reference's "dus"); granite at 8 layers with the KV
# heads unbound (layout "seq", as on pod16x16, where 8 KV heads do not
# divide 16): a cache of 1840 slots, 920 a rank, so the prompt's 910
# tokens and the first decode steps land on rank 0 and the later ones on
# rank 1; mixtral-8x7b at 4 of 32 layers, its experts split 4 a rank,
# the long prompts past the 4096-token window (the ring cache);
# qwen2-vl-7b at 28 layers with the stub image and M-RoPE positions
# continued in decode; granite at 8 layers on (2, 1): the rows split 4 a
# rank, nothing over "model", the params whole on each rank (``embed``
# unbound: gathered over "data" in each call and staged through the host,
# even 1 layer's 1.2 GB a call made the decode 45 s on an H100; the CPU
# tests hold the gathers).
# deepseek-v2-236b at 4 of 60 layers (its dense layer and 3 MoE layers):
# 64 heads and 80 experts a rank, its latent cache (no head dimension)
# split by slot, 1840 slots, 920 a rank, as granite-seq's, so decode
# crosses from rank 0's slots to rank 1's; seamless-m4t-large-v2 at full
# depth (24 + 24): 8 heads and 8 KV heads a rank, its self and cross
# caches split over the KV heads.  zamba2-7b at 13 of 81 layers: 56 SSM
# heads a rank (its conv cache as its parts' chunks, its SSM state by
# heads), the shared blocks' 16 KV heads a rank (layout "heads");
# rwkv6-1.6b at 8 of 24 layers: 16 heads a rank (the WKV state by heads,
# the token shifts whole), the channel mix's columns split.  Both in fp32,
# as phase 3 checks these models: in bf16 their random-weight models' own
# rounding reaches MODEL_TOL (zamba2 at 13 layers, one device in bf16
# against fp32: 5.5e-2 of its largest prefill logit), and the ranks' other
# summation order in bf16 lay 9.5e-2 (zamba2, 13 layers), 7.5e-2 (7) and
# 8.4e-2 (rwkv6, 8) from the one-device bf16 run, 2.0e-5 in fp32 (an
# H100, PERF.md section 6).
SERVE_WORLDS = {
    "granite": ServeWorld(TRAIN_MODEL, None, (1, 2), {}, "short"),
    "granite-seq": ServeWorld(TRAIN_MODEL, 8, (1, 2), {"kv_heads": None},
                              "short", 1840),
    "mixtral": ServeWorld("mixtral-8x7b", 4, (1, 2), {}, "long"),
    "qwen2-vl": ServeWorld(VLM_MODEL, 8, (1, 2), {}, "vlm"),
    "granite-rows": ServeWorld(TRAIN_MODEL, 8, (2, 1), {"embed": None},
                               "short"),
    "deepseek-seq": ServeWorld("deepseek-v2-236b", 4, (1, 2), {}, "short",
                               1840),
    "seamless": ServeWorld(ENCDEC_MODEL, 8, (1, 2), {}, "encdec"),
    "zamba2": ServeWorld("zamba2-7b", 13, (1, 2), {}, "short",
                         dtype="float32"),
    "rwkv6": ServeWorld("rwkv6-1.6b", 8, (1, 2), {}, "short",
                        dtype="float32"),
}


@contextmanager
def one_rank_world(backend: str = "nccl"):
    """A one-rank process group through a file store under build/ (no
    network: the store is a file the one rank creates and reads)."""
    import torch.distributed as dist
    store_dir = os.path.join(ROOT, "build", "dist_store")
    shutil.rmtree(store_dir, ignore_errors=True)
    os.makedirs(store_dir)
    store = dist.FileStore(os.path.join(store_dir, "store"), 1)
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(0)
        kw = {"device_id": torch.device("cuda", 0)}
    dist.init_process_group(backend, store=store, rank=0, world_size=1,
                            **kw)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)


def _sync(dev):
    """A wait for the device's queued work (nothing to wait for on the
    CPU, where the phase is rehearsed)."""
    return torch.cuda.synchronize if dev == "cuda" else (lambda: None)


def dist_batches(cfg, shape, steps: int, dev) -> list:
    """The seed's batches, with the loop's stub extras where the model
    takes some (a VLM's patches and positions)."""
    source = SyntheticTokenSource(cfg.vocab_size, seed=SEED)
    extras = stub_extras(cfg, shape)
    out = []
    for step in range(steps):
        t = source.batch(step, shape.global_batch, shape.seq_len)
        batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        if extras is not None:
            batch.update(extras(step, shape.global_batch))
        out.append(batch_to_device(batch, dev))
    return out


def dist_steps(cfg, tcfg, batches, mesh, dev, count: bool = False,
               rules=TRAIN_RULES, grads: bool = False,
               overlap: bool = False) -> dict:
    """A step a batch from the seed's params: one-device (``mesh`` None)
    or through the mesh with the params and optimizer state stored as
    this rank's pieces under ``rules``, which the step also computes
    with.  Returns metrics, step times, peak GB, launches and the final
    params; with ``count``, also ``launch.cost_analysis``'s predicted peak
    GB of this rank's step (``counted_peak_gb``); with ``grads``, also the
    first batch's gradients before the steps, on the host (``grads``: this
    rank's pieces on a mesh), which the peak and launches leave out;
    ``overlap``: the mesh step's exchanges overlapped with compute."""
    sync = _sync(dev)
    pc = None if mesh is None else PartitionConstraints(
        rules, mesh, seq_parallel=tcfg.seq_parallel)
    step_fn, opt = make_train_step(cfg, tcfg, mesh=mesh, pc=pc,
                                   overlap=overlap)
    psh = None
    if mesh is not None:
        psh, _ = step_shardings(cfg, tcfg, mesh, pc)
    if mesh is not None and mesh.size() > 1:
        params = init_pieces(cfg, psh, mesh, dev)
    else:
        params = init_model_params(cfg, seed=SEED, device=dev)
    if mesh is not None and mesh.size() == 1:
        pieces = shard_tree(params, psh, mesh)
        # one rank holds every leaf whole: its pieces are the leaves
        if any(a is not b for a, b in zip(flatten(pieces).values(),
                                          flatten(params).values())):
            raise AssertionError("dist: a one-rank mesh copied a leaf")
        params = pieces
    if mesh is not None:
        # this rank's rows of each global batch
        batches = [shard_batch(b, mesh) for b in batches]
    state = opt.init(params, psh)
    grads0 = None
    if grads:
        g, _ = make_grads_fn(cfg, tcfg, pc=pc, mesh=mesh)(params, batches[0])
        grads0 = {k: v.cpu() for k, v in flatten(g).items()}
        del g
    counted = analyze_step(step_fn, (params, state, batches[0], 0))[
        "memory"]["peak_bytes"] / 1e9 if count else None
    if dev == "cuda":
        sync()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    metrics, times = [], []
    for i, batch in enumerate(batches):
        t0 = time.monotonic()
        params, state, m = step_fn(params, state, batch, i)
        sync()
        times.append(time.monotonic() - t0)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                                 "param_norm")})
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" \
        else None
    del state
    return {"metrics": metrics, "step_s": times, "peak_memory_gb": peak,
            "launches": launches, "params": params,
            "counted_peak_gb": counted, "grads": grads0}


def dist_train_cfg() -> TrainConfig:
    return TrainConfig(warmup_steps=0, total_steps=DIST_STEPS,
                       learning_rate=1e-3, remat_policy="minimal",
                       optimizer="adamw")


def dist_train(dev="cuda", cfg=None, shape=None, phase4=None) -> tuple:
    """(a): the data-parallel step at world size 1 against the one-device
    step; returns (row, the mesh run's params, the mesh, the batches)."""
    cfg = cfg or dataclasses.replace(get_config(TRAIN_MODEL),
                                     num_layers=TRAIN_LAYERS_OF[TRAIN_MODEL])
    shape = shape or TRAIN_SHAPE
    tcfg = dist_train_cfg()
    batches = dist_batches(cfg, shape, DIST_STEPS, dev)
    one = dist_steps(cfg, tcfg, batches, None, dev)
    del one["params"]
    if dev == "cuda":
        torch.cuda.empty_cache()
    mesh = make_mesh_for(1, device_type=dev)
    # the mesh step with overlap on first: a one-rank mesh exchanges
    # nothing, so it makes no worker thread, side stream or group
    threads = threading.active_count()
    overlapped = dist_steps(cfg, tcfg, batches, mesh, dev, overlap=True)
    del overlapped["params"]
    started = {"threads": threading.active_count() - threads,
               "overlap_started": comm.overlap_started()}
    meshed = dist_steps(cfg, tcfg, batches, mesh, dev)
    want = train_launches(cfg, DIST_STEPS)
    for name, run in (("one-device", one), ("mesh", meshed),
                      ("mesh with overlap", overlapped)):
        if run["launches"] != want:
            raise AssertionError(f"dist {name}: launches {run['launches']}, "
                                 f"expected {want}")
    log(f"dist: overlap at world size 1 " + json.dumps({
        "bit_equal": overlapped["metrics"] == one["metrics"],
        "step_s": overlapped["step_s"], **started}))
    if overlapped["metrics"] != one["metrics"] or started["threads"] or \
            started["overlap_started"]:
        raise AssertionError("dist: the one-rank mesh step with overlap on "
                             "is not the one-device step, or started a "
                             "thread, stream or group")
    gaps = [{k: abs(a[k] - b[k]) / abs(b[k]) for k in a}
            for a, b in zip(meshed["metrics"], one["metrics"])]
    row = {"model": TRAIN_MODEL, "layers": cfg.num_layers,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "seq_len": shape.seq_len, "global_batch": shape.global_batch,
           "mesh_metrics": meshed["metrics"],
           "one_device_metrics": one["metrics"], "relative_gaps": gaps,
           "bit_equal": meshed["metrics"] == one["metrics"],
           "mesh_step_s": meshed["step_s"], "one_device_step_s": one["step_s"],
           "mesh_step_s_after_1": statistics.median(meshed["step_s"][1:]),
           "one_device_step_s_after_1": statistics.median(
               one["step_s"][1:]),
           "mesh_peak_gb": meshed["peak_memory_gb"],
           "one_device_peak_gb": one["peak_memory_gb"],
           "param_count": cfg.param_count(),
           **({"phase4_train_step_s_median_2_6": phase4["step_s_median_2_6"],
               "phase4_train_peak_gb": phase4["peak_memory_gb"]}
              if phase4 else {}),
           "launches": meshed["launches"]}
    log(f"dist: train {json.dumps(row)} (limits {json.dumps(TRAIN_TOL)})")
    if not all(math.isfinite(v) for m in meshed["metrics"]
               for v in m.values()) or \
            not all(v <= TRAIN_TOL[k] for g in gaps for k, v in g.items()):
        raise AssertionError("dist: the mesh step disagrees with the "
                             "one-device step")
    return row, meshed["params"], mesh, batches


def dist_compress(params, cfg, batch, dev="cuda") -> dict:
    """(c): ``compressed_pmean`` over a one-rank group on granite's
    gradient leaves (one batch's fp32 gradients): the int8 exchange runs,
    and every element lies within scale/2 of its row of the gradient (times
    INT8_BOUND, fp32's rounding)."""
    import torch.distributed as dist
    flat = {k: v.detach().requires_grad_() for k, v in flatten(params).items()}
    loss, _ = loss_fn(unflatten(flat), cfg, batch, remat="minimal")
    grads = unflatten(dict(zip(flat, torch.autograd.grad(
        loss, list(flat.values())))))
    del flat, loss
    group = dist.new_group([0])
    sync = _sync(dev)
    sync()
    t0 = time.monotonic()
    mean = compressed_pmean(grads, group, "int8")
    sync()
    secs = time.monotonic() - t0
    worst, n = 0.0, 0
    for k, g in flatten(grads).items():
        got = flatten(mean)[k]
        rows = g.reshape(-1, g.shape[-1]) if g.ndim > 1 else g.reshape(1, -1)
        _, scale = quantize_int8(rows)
        err = (got.reshape(rows.shape) - rows).abs() / (scale / 2)
        worst = max(worst, float(err.max()))
        n += g.numel()
    row = {"leaves": len(flatten(grads)), "elements": n,
           "bytes_int8": n, "bytes_fp32": 4 * n, "s": secs,
           "worst_error_over_half_scale": worst}
    log(f"dist: compress {json.dumps(row)}")
    if not worst <= INT8_BOUND:
        raise AssertionError("dist: compressed_pmean outside its bound")
    return row


def stage_launches(cfg, layers: int, microbatches: int) -> dict:
    """Launches of a pipeline stage of ``layers`` dense blocks over
    ``microbatches``, forward and backward under remat "minimal": an
    RMSNorm a block norm forward, again in the block's re-run, and a
    backward a norm (:func:`train_launches` without the final norm)."""
    n = block_norms(cfg) * layers * microbatches
    out = no_launches()
    out.update({"rmsnorm": 2 * n, "rmsnorm_backward": n})
    return out


def stage_fn_of(cfg, rope, attn_impl: str, remat: str):
    """A pipeline stage's compute: its stacked dense layers (a flat tree)
    over one microbatch, train mode."""
    def stage_fn(p, xb):
        return _train_layers(unflatten(p), xb, cfg, prefix="dense_layers",
                             rope=rope, attn_impl=attn_impl, remat=remat)
    return stage_fn


def loss_weights(x):
    """r of the loss sum(y * r): fp32 normals of x's shape from the
    seed."""
    g = torch.Generator(device=x.device).manual_seed(SEED + 1)
    return torch.randn(x.shape, generator=g, device=x.device)


def grads_through(run, leaves: dict, x, r) -> tuple:
    """(y, {name: gradient}, dx) of the loss sum(y * r), y = run(leaves,
    x), from detached copies of ``leaves`` and ``x``."""
    flat = {k: v.detach().requires_grad_() for k, v in leaves.items()}
    xg = x.detach().requires_grad_()
    y = run(flat, xg)
    (y.float() * r).sum().backward()
    return y.detach(), {k: v.grad for k, v in flat.items()}, xg.grad


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| (fp64 sums)."""
    num = torch.linalg.vector_norm(got.float() - want.float(),
                                   dtype=torch.float64)
    den = torch.linalg.vector_norm(want, dtype=torch.float64)
    if not float(den):
        return 0.0 if not float(num) else math.inf
    return float(num / den)


def dist_pipeline(params, cfg, batch, dev="cuda") -> tuple:
    """(d): ``pipeline_apply`` with one stage holding granite's layers over
    PIPE_MICROBATCHES microbatches of the train batch against the same
    layers run on the whole batch: forward only (flash prefill attention,
    no grad) within the bf16 flash tolerance, with the stage's launches
    (flash and two RMSNorms a layer a microbatch); then forward and
    backward of the loss sum(y * r) (masked attention, remat "minimal",
    as phase 4's step): every layer leaf's gradient and the input's
    within TRAIN_TOL["grads"] (relative L2) of the whole batch's, with
    launches exactly ``stage_launches``.  Returns (row, the pipelined
    runs' launches)."""
    layers = flatten(params["dense_layers"])
    mesh = init_device_mesh(dev, (1,), mesh_dim_names=("pipe",))
    n = cfg.num_layers * PIPE_MICROBATCHES
    with torch.no_grad():
        x = embed_tokens(params["embed"], batch["tokens"], cfg)
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        rope = rope_table(pos, cfg.head_dim, cfg.rope_theta)
        stage_fn = stage_fn_of(cfg, rope, "flash", "none")
        want = stage_fn(layers, x)
        ops.reset_launch_counts()
        got = pipeline_apply(stage_fn, {k: v[None] for k, v in
                                        layers.items()}, x, mesh=mesh,
                             num_microbatches=PIPE_MICROBATCHES)
        launches = ops.launch_counts()
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    row = {"stages": 1, "microbatches": PIPE_MICROBATCHES,
           "shape": list(x.shape), "max_abs_err": err, "max_abs": scale,
           "bit_equal": bool(torch.equal(got, want)), "launches": launches}
    del got, want
    fwd_ok = launches["flash_attention"] == n and \
        launches["rmsnorm"] == 2 * n and \
        err <= TOL["flash_attention"][x.dtype] * max(scale, 1.0)

    # forward and backward
    sync = _sync(dev)
    train_fn = stage_fn_of(cfg, rope, "masked", "minimal")
    r = loss_weights(x)
    t0 = time.monotonic()
    want_y, want, want_dx = grads_through(train_fn, layers, x, r)
    sync()
    whole_s = time.monotonic() - t0
    ops.reset_launch_counts()
    t0 = time.monotonic()
    y, got, dx = grads_through(
        lambda p, xg: pipeline_apply(train_fn, {k: v[None] for k, v in
                                                p.items()}, xg, mesh=mesh,
                                     num_microbatches=PIPE_MICROBATCHES),
        layers, x, r)
    sync()
    pipe_s = time.monotonic() - t0
    back = ops.launch_counts()
    gaps = {k: rel_l2(got[k], want[k]) for k in want}
    gaps["dx"] = rel_l2(dx, want_dx)
    y_gap = rel_l2(y, want_y)
    del got, want, dx, want_dx, y, want_y
    row["backward"] = {
        "attn_impl": "masked", "remat": "minimal", "loss": "sum(y * r)",
        "output_relative_l2": y_gap, "grads_relative_l2": gaps,
        "largest": max(gaps.values()), "whole_batch_s": whole_s,
        "pipelined_s": pipe_s, "launches": back}
    log(f"dist: pipeline {json.dumps(row)} (limits: forward "
        f"{TOL['flash_attention'][x.dtype]} of the largest, gradients "
        f"{TRAIN_TOL['grads']} relative L2)")
    if not fwd_ok:
        raise AssertionError("dist: the one-stage pipeline disagrees with "
                             "the sequential layers")
    if back != stage_launches(cfg, cfg.num_layers, PIPE_MICROBATCHES) or \
            not all(v <= TRAIN_TOL["grads"] for v in gaps.values()):
        raise AssertionError("dist: the one-stage pipeline's gradients "
                             "disagree with the whole batch's")
    return row, {k: launches[k] + back[k] for k in launches}


def a2a_run(cfg, params, batch, pc, dev="cuda", reps: int = 3) -> dict:
    """Forward and backward of the cross-entropy (no aux term: the two
    dispatches' aux statistics are defined apart, as the reference's)
    through ``pc``'s dispatch; the logits, gradients, mean time and
    launches."""
    sync = _sync(dev)
    flat = {k: v.detach().requires_grad_() for k, v in flatten(params).items()}

    def once():
        logits, _ = forward(unflatten(flat), cfg, tokens=batch["tokens"],
                            mode="train", pc=pc)
        labels = batch["labels"]
        loss = cross_entropy(logits, labels, cfg)
        return logits, torch.autograd.grad(loss, list(flat.values()))
    moe.reset_dispatch_counts()
    ops.reset_launch_counts()
    logits, grads = once()
    launches, dispatches = ops.launch_counts(), moe.dispatch_counts()
    sync()
    t0 = time.monotonic()
    for _ in range(reps):
        once()
    sync()
    return {"logits": logits.detach(), "grads": dict(zip(flat, grads)),
            "s": (time.monotonic() - t0) / reps, "launches": launches,
            "dispatches": dispatches}


def dist_a2a(dev="cuda", cfg=None, rows=A2A_ROWS, seq=A2A_SEQ) -> tuple:
    """(b): mixtral through ``impl="a2a"`` on the (1, 1) mesh against the
    grouped dispatch: the a2a path must have run, its logits within
    MODEL_TOL of the largest, its gradients within TRAIN_TOL["grads"]
    (relative L2, leaf by leaf); returns (row, the a2a run's launches)."""
    cfg = cfg or dataclasses.replace(
        get_config("mixtral-8x7b"), num_layers=TRAIN_LAYERS_OF[
            "mixtral-8x7b"])
    m = cfg.moe
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, impl="a2a", capacity_factor=m.num_experts / m.top_k))
    params = init_model_params(cfg, seed=SEED, device=dev,
                               compute_dtype=getattr(torch, cfg.dtype))
    t = SyntheticTokenSource(cfg.vocab_size, seed=SEED).batch(0, rows, seq)
    batch = batch_to_device({"tokens": t[:, :-1], "labels": t[:, 1:]}, dev)
    mesh = make_mesh_for(1, device_type=dev)
    grouped = a2a_run(cfg, params, batch, None, dev)
    a2a = a2a_run(cfg, params, batch,
                  PartitionConstraints(TRAIN_RULES, mesh), dev)
    n_moe = cfg.num_layers
    if a2a["dispatches"] != {"grouped": 0, "a2a": n_moe} or \
            grouped["dispatches"] != {"grouped": n_moe, "a2a": 0}:
        raise AssertionError(f"dist: dispatches {a2a['dispatches']} / "
                             f"{grouped['dispatches']}")
    # one forward and backward, no remat: two norms a layer and the final
    norms = 2 * cfg.num_layers + 1
    want = {**no_launches(), "rmsnorm": norms, "rmsnorm_backward": norms}
    if a2a["launches"] != want:
        raise AssertionError(f"dist: a2a launches {a2a['launches']}, "
                             f"expected {want}")
    lerr = float((a2a["logits"].float() - grouped["logits"].float()).abs()
                 .max())
    lmax = float(grouped["logits"].float().abs().max())
    gerr = max(float((a2a["grads"][k].float() - g.float()).norm()
                     / g.float().norm().clamp_min(1e-30))
               for k, g in grouped["grads"].items())
    row = {"model": "mixtral-8x7b", "layers": cfg.num_layers,
           "rows": rows, "seq_len": seq, "dtype": cfg.dtype,
           "capacity_factor": cfg.moe.capacity_factor,
           "dispatches": a2a["dispatches"],
           "logits_max_abs_err": lerr, "logits_max_abs": lmax,
           "grads_max_rel_l2": gerr,
           "bit_equal": bool(torch.equal(a2a["logits"], grouped["logits"]))
           and all(torch.equal(a2a["grads"][k], g)
                   for k, g in grouped["grads"].items()),
           "a2a_fwd_bwd_s": a2a["s"], "grouped_fwd_bwd_s": grouped["s"],
           "launches": a2a["launches"]}
    log(f"dist: a2a {json.dumps(row)}")
    if not lerr <= MODEL_TOL * max(lmax, 1.0) or \
            not gerr <= TRAIN_TOL["grads"]:
        raise AssertionError("dist: the a2a dispatch disagrees with the "
                             "grouped one")
    launches = a2a["launches"]
    del params, grouped, a2a
    return row, launches


def run_overlaps(case: TpCase, i: int) -> bool:
    """Whether run ``i`` of ``case`` overlaps its exchanges with compute."""
    return len(case.runs[i]) > 3 and case.runs[i][3]


def tp_cfg(case: TpCase):
    cfg = dataclasses.replace(get_config(case.model), num_layers=case.layers)
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, num_encoder_layers=case.layers)
    return dataclasses.replace(cfg, dtype=case.dtype) if case.dtype else cfg


def init_pieces(cfg, shardings, mesh, dev, compute_dtype=None):
    """The seed's params (``init_model_params``' leaves) made one leaf at a
    time and cut to this rank's pieces under ``shardings`` at once, so a
    rank never holds the model whole (two ranks share the one card)."""
    specs, sh = flatten(model_specs(cfg)), flatten(shardings)
    return unflatten({k: shard_leaf(flatten(init_params(
        unflatten({k: s}), SEED, device=dev, compute_dtype=compute_dtype,
        keep=fp32_leaves(cfg)))[k], sh[k], mesh) for k, s in specs.items()})


def tp_train_cfg(case: TpCase, sp: bool = False) -> TrainConfig:
    return dataclasses.replace(dist_train_cfg(), optimizer=case.optimizer,
                               seq_parallel=sp,
                               num_microbatches=case.microbatches)


def compute_mode() -> str:
    """The card's compute mode, as ``nvidia-smi`` gives it (two processes
    share the card only in the Default mode)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def join_world(kind: str, args: dict, model: int, dev: str):
    """A rank of a phase-6 world joins it: its device and the parent's
    kernels, then a gloo process group through the file store in its work
    directory and the (data, model) mesh of ``model`` ranks over
    "model"; returns (rank, mesh)."""
    import torch.distributed as dist
    rank, n = int(args[f"--{kind}-rank"]), int(args[f"--{kind}-world"])
    if dev == "cuda":
        torch.cuda.set_device(0)
        kbuild.load_library()              # built by the parent
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(args[f"--{kind}-dir"], "store"), n), rank=rank,
        world_size=n)
    return rank, make_mesh_for(n, model=model, device_type="cpu")


def free_device(dev: str) -> None:
    """What a finished run of a world left behind goes before the next
    (the next one's peak is held to its own count)."""
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()


def tp_rank_run(name: str, i: int, mesh, rank: int, workdir: str, k: int,
                dev: str) -> dict:
    """Run ``i`` of ``TP_CASES[name]``, the ``k``-th of its world, on this
    rank: ``dist_steps`` with the seed's params and batches under the run's
    rules (each exchange staged through the host: gloo over CUDA tensors);
    for a ``step0`` case its pieces of step 0's gradients go to
    ``DIR/grads<R>_<K>.pt``.  Returns its row."""
    case = TP_CASES[name]
    _, sp, overrides = case.runs[i][:3]
    cfg = tp_cfg(case)
    batches = dist_batches(cfg, case.shape, DIST_STEPS, dev)
    comm.reset_staged()
    moe.reset_dispatch_counts()
    run = dist_steps(cfg, tp_train_cfg(case, sp), batches, mesh, dev,
                     count=True, rules=TRAIN_RULES.with_overrides(**overrides),
                     grads=case.step0, overlap=run_overlaps(case, i))
    del run["params"]
    grads = run.pop("grads")
    if grads is not None:
        torch.save(grads, os.path.join(workdir, f"grads{rank}_{k}.pt"))
    run.update({"rank": rank, "coord": list(mesh.get_coordinate()),
                "staged": comm.staged(),
                "staged_by_purpose": comm.staged_by_purpose(),
                "overlapped": comm.overlapped(),
                "dispatches": moe.dispatch_counts()})
    return run


def pipe_cfg():
    return dataclasses.replace(get_config(TRAIN_MODEL),
                               num_layers=PIPE_STAGES * PIPE_STAGE_LAYERS)


def pipe_ref_path() -> str:
    return os.path.join(ROOT, "build", "pipe_ref.pt")


def pipe_inputs(cfg, dev) -> tuple:
    """x (TP_SHAPE's rows and tokens, d_model wide, in the model's dtype)
    from the seed, and the rope table of its positions."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((TP_SHAPE.global_batch, TP_SHAPE.seq_len, cfg.d_model),
                    generator=g, device=dev).to(getattr(torch, cfg.dtype))
    rope = rope_table(torch.arange(TP_SHAPE.seq_len, device=dev)[None, :],
                      cfg.head_dim, cfg.rope_theta)
    return x, rope


def pipe_layers(cfg, dev, stage: Optional[int] = None) -> dict:
    """The seed's dense layers (``init_model_params``' leaves) as a flat
    tree, made one leaf at a time; with ``stage``, only that stage's
    PIPE_STAGE_LAYERS layers."""
    out = {}
    for k, spec in flatten(model_specs(cfg)).items():
        if not k.startswith("dense_layers/"):
            continue
        leaf = flatten(init_params(unflatten({k: spec}), SEED, device=dev,
                                   keep=fp32_leaves(cfg)))[k]
        if stage is not None:
            leaf = leaf[stage * PIPE_STAGE_LAYERS:
                        (stage + 1) * PIPE_STAGE_LAYERS].clone()
        out[k[len("dense_layers/"):]] = leaf
    return out


def pipe_one_device(dev: str) -> dict:
    """The two-stage pipeline's reference: its layers in sequence on one
    device over the whole batch, forward and backward; the output,
    gradients and dx go to :func:`pipe_ref_path` on the host, for the
    ranks.  Returns its seconds and peak GB."""
    cfg = pipe_cfg()
    sync = _sync(dev)
    x, rope = pipe_inputs(cfg, dev)
    layers = pipe_layers(cfg, dev)
    if dev == "cuda":
        sync()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    y, grads, dx = grads_through(stage_fn_of(cfg, rope, "masked",
                                             "minimal"), layers, x,
                                 loss_weights(x))
    sync()
    secs = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" \
        else None
    torch.save({"y": y.cpu(), "dx": dx.cpu(),
                "grads": {k: v.cpu() for k, v in grads.items()}},
               pipe_ref_path())
    return {"s": secs, "peak_memory_gb": peak}


def pipe_rank_run(rank: int, dev: str) -> dict:
    """This rank's stage of the two-stage pipeline (a ("pipe",) mesh of
    the world's ranks, its own layers only: the stacked tree it passes is
    an expanded view of them, of which ``pipeline_apply`` reads slice s),
    forward and backward, held to :func:`pipe_one_device`'s run: the
    output's largest gap relative to its largest element, and each leaf's
    and dx's relative L2 gap.  Returns its row (with the bytes staged by
    purpose, launches, peak GB and seconds)."""
    cfg = pipe_cfg()
    sync = _sync(dev)
    mesh = init_device_mesh("cpu", (PIPE_STAGES,), mesh_dim_names=("pipe",))
    stage = comm.coordinate(mesh)["pipe"]
    x, rope = pipe_inputs(cfg, dev)
    mine = pipe_layers(cfg, dev, stage)
    fn = stage_fn_of(cfg, rope, "masked", "minimal")

    def run(p, xg):
        return pipeline_apply(fn, {k: v[None].expand(
            (PIPE_STAGES,) + tuple(v.shape)) for k, v in p.items()}, xg,
            mesh=mesh, num_microbatches=PIPE_MICROBATCHES)
    r = loss_weights(x)
    comm.reset_staged()
    ops.reset_launch_counts()
    if dev == "cuda":
        sync()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    y, grads, dx = grads_through(run, mine, x, r)
    sync()
    secs = time.monotonic() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" \
        else None
    want = torch.load(pipe_ref_path(), mmap=True)
    lo = stage * PIPE_STAGE_LAYERS
    gaps = {k: rel_l2(g, want["grads"][k][lo:lo + PIPE_STAGE_LAYERS].to(
        g.device)) for k, g in grads.items()}
    gaps["dx"] = rel_l2(dx, want["dx"].to(dx.device))
    wy = want["y"].to(y.device).float()
    return {"rank": rank, "stage": stage,
            "output_gap": float((y.float() - wy).abs().max()
                                / wy.abs().max()),
            "grads_relative_l2": gaps, "staged": comm.staged(),
            "staged_by_purpose": comm.staged_by_purpose(),
            "launches": launches, "peak_memory_gb": peak, "s": secs}


def pipe_run_row(ranks: list, one: dict, dev: str) -> dict:
    """The two-stage pipeline's ranks held to the one-device run: the
    output within MODEL_TOL of the largest element, every leaf's gradient
    and dx within TRAIN_TOL["grads"] (relative L2), a rank's bytes staged
    by purpose exactly its PIPE_MICROBATCHES hand-offs (sent or received)
    and one broadcast (copied out and back) each way, its launches exactly
    ``stage_launches``.  Logs a ``dist: pipeline`` line and returns the
    ranks' launches, summed."""
    cfg = pipe_cfg()
    size = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    whole = TP_SHAPE.global_batch * TP_SHAPE.seq_len * cfg.d_model * size
    each = {"collectives": PIPE_MICROBATCHES + 1,
            "bytes": whole + 2 * whole}
    want_staged = {"pipe_act": each, "pipe_grad": each}
    want_l = stage_launches(cfg, PIPE_STAGE_LAYERS, PIPE_MICROBATCHES)
    row = {"stages": PIPE_STAGES, "layers_a_stage": PIPE_STAGE_LAYERS,
           "model": TRAIN_MODEL, "dtype": cfg.dtype,
           "microbatches": PIPE_MICROBATCHES,
           "shape": [TP_SHAPE.global_batch, TP_SHAPE.seq_len, cfg.d_model],
           "attn_impl": "masked", "remat": "minimal", "loss": "sum(y * r)",
           "output_gap": [r["output_gap"] for r in ranks],
           "grads_relative_l2": [r["grads_relative_l2"] for r in ranks],
           "staged_by_purpose": [r["staged_by_purpose"] for r in ranks],
           "staged": [r["staged"] for r in ranks],
           "launches": [r["launches"] for r in ranks],
           "peak_gb": [r["peak_memory_gb"] for r in ranks],
           "host_staged_s": [r["s"] for r in ranks],
           "one_device_s": one["s"],
           "one_device_peak_gb": one["peak_memory_gb"]}
    log(f"dist: pipeline {json.dumps(row)} (seconds are of hand-offs "
        f"staged through the host over gloo, two processes sharing one "
        f"card: not a speed of pipelining; limits: output {MODEL_TOL} of "
        f"the largest, gradients {TRAIN_TOL['grads']} relative L2)")
    if not all(r["output_gap"] <= MODEL_TOL and all(
            v <= TRAIN_TOL["grads"] for v in r["grads_relative_l2"].values())
            for r in ranks):
        raise AssertionError("dist: the two-stage pipeline disagrees with "
                             "the sequential layers on one device")
    if dev == "cuda" and any(r["staged_by_purpose"] != want_staged
                             for r in ranks):
        raise AssertionError(f"dist: the two-stage pipeline staged "
                             f"{row['staged_by_purpose']}, expected "
                             f"{want_staged} a rank")
    if dev == "cuda" and any(r["launches"] != want_l for r in ranks):
        raise AssertionError(f"dist: the two-stage pipeline's launches "
                             f"{row['launches']}, expected {want_l} a rank")
    return {k: sum(r["launches"][k] for r in ranks) for k in want_l}


def tp_rank_main(argv: list) -> int:
    """One rank of phase 6 (e), in a process of its own: ``--tp-rank R
    --tp-world N --tp-dir DIR --tp-runs C:I,...`` (runs I of
    ``TP_CASES[C]``, all on one mesh).  Joins the gloo world
    (:func:`join_world`), then runs each in turn (:func:`tp_rank_run`),
    writes its row to ``DIR/rank<R>_<K>.json`` (K: its place in the list)
    and frees all it made before the next.  ``--tp-dev cpu`` rehearses it
    on the CPU."""
    import torch.distributed as dist
    args = dict(zip(argv[0::2], argv[1::2]))
    runs = [(c, int(i)) for c, i in (r.split(":") for r in
                                      args["--tp-runs"].split(","))]
    dev = args.get("--tp-dev", "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, mesh = join_world("tp", args, TP_CASES[runs[0][0]].mesh[1], dev)
    try:
        for k, (name, i) in enumerate(runs):
            row = pipe_rank_run(rank, dev) if name == PIPE_RUN else \
                tp_rank_run(name, i, mesh, rank, args["--tp-dir"], k, dev)
            with open(os.path.join(args["--tp-dir"], f"rank{rank}_{k}.json"),
                      "w") as f:
                json.dump(row, f)
            del row
            free_device(dev)
    finally:
        dist.destroy_process_group()
    return 0


def run_world(kind: str, n: int, workdir: str, extra: list, keys: list,
              deadline_s: float) -> None:
    """Starts ``n`` processes of this script as the ranks of a phase-6
    world (``--<kind>-rank R --<kind>-world n --<kind>-dir workdir`` and
    ``extra``), then waits for each run's rows (:func:`wait_rows`, for
    each of ``keys`` in turn) up to ``deadline_s`` after the previous
    run's, and for the ranks' end up to ``deadline_s`` after the last; a
    run that outlives its deadline, or a rank that fails, kills the rest
    and fails the world."""
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), f"--{kind}-rank", str(r),
         f"--{kind}-world", str(n), f"--{kind}-dir", workdir, *extra])
        for r in range(n)]
    why = None
    try:
        for key in keys:
            why = wait_rows(procs, workdir, key, deadline_s)
            if why is not None:
                break
        else:
            deadline = time.monotonic() + deadline_s
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        why = f"the ranks' end past {deadline_s} s"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    rcs = [p.returncode for p in procs]
    if why is not None or any(rc != 0 for rc in rcs):
        raise AssertionError(f"dist: {kind} ranks of {extra} exited {rcs}"
                             f" ({why or 'a rank failed'})")


def wait_rows(procs: list, workdir: str, key, deadline_s: float):
    """Waits for every rank's row of the run ``key``
    (``rank<R>_<key>.json``, written when the rank ends the run); returns
    None once they are all there, else why they are not: a rank failed,
    every rank ended, or ``deadline_s`` passed."""
    deadline = time.monotonic() + deadline_s
    while not all(os.path.exists(os.path.join(workdir, f"rank{r}_{key}.json"))
                  for r in range(len(procs))):
        rcs = [p.poll() for p in procs]
        if any(rc not in (None, 0) for rc in rcs) or None not in rcs:
            return f"a rank ended before run {key}'s rows"
        if time.monotonic() > deadline:
            return f"run {key}'s rows past {deadline_s} s"
        time.sleep(0.5)
    return None


def read_rows(workdir: str, n: int, key) -> list:
    """Each rank's row of the run ``key`` (``rank<R>_<key>.json``)."""
    rows = []
    for r in range(n):
        with open(os.path.join(workdir, f"rank{r}_{key}.json")) as f:
            rows.append(json.load(f))
    return rows


def tp_world(runs: list, dev: str = "cuda", grads=None) -> list:
    """``runs`` ([(case, run index)], all on one mesh) in turn as one world
    of processes of this script sharing the one card, one a rank of the
    mesh (:func:`tp_rank_main`), each run given TP_DEADLINE_S; returns
    each run's rank rows.  ``grads``: {case: {name: whole gradients of the
    first batch on the host}}, each of which that case's ranks' pieces of
    theirs are set against (a row's ``grads_gap``: {name: the largest
    relative L2 gap over the leaves})."""
    workdir = os.path.join(ROOT, "build", "tp_world")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    mesh = TP_CASES[runs[0][0]].mesh
    n = math.prod(mesh)
    run_world("tp", n, workdir, [
        "--tp-runs", ",".join(f"{c}:{i}" for c, i in runs),
        "--tp-dev", dev], list(range(len(runs))), TP_DEADLINE_S)
    out = []
    for k, (name, i) in enumerate(runs):
        rows = read_rows(workdir, n, k)
        if grads and name in grads:
            case = TP_CASES[name]
            rules = TRAIN_RULES.with_overrides(**case.runs[i][2])
            gap = grads_gaps(grads[name], [
                (dict(zip(("data", "model"), row["coord"])),
                 os.path.join(workdir, f"grads{r}_{k}.pt"))
                for r, row in enumerate(rows)], flatten(shardings_for_specs(
                    model_specs(tp_cfg(case)), rules,
                    dict(zip(("data", "model"), mesh)))))
            for row in rows:
                row["grads_gap"] = gap
        out.append(rows)
    shutil.rmtree(workdir, ignore_errors=True)
    return out


def grads_gaps(wants: dict, ranks: list, shardings: dict) -> dict:
    """{name: the largest ||g - g_want|| / ||g_want|| over the leaves} for
    each of ``wants`` ({name: whole gradients on the host}), each leaf's g
    put together from the ranks' pieces: ``ranks`` holds (mesh coordinate,
    path of the rank's pieces); a piece that two ranks hold counts once."""
    num = {n: {} for n in wants}
    seen = {}
    for coord, path in ranks:
        pieces = torch.load(path)
        for k, g in pieces.items():
            # the piece's place: its coordinate on the axes that split it
            where = tuple(coord.get(a, 0) for a in shardings[k].axes)
            if where in seen.setdefault(k, set()):
                continue
            seen[k].add(where)
            for n, want in wants.items():
                num[n][k] = num[n].get(k, 0.0) + float(
                    torch.linalg.vector_norm(
                        g - shardings[k].cut(want[k], coord),
                        dtype=torch.float64)) ** 2
        del pieces
    out = {}
    for n, want in wants.items():
        gaps = []
        for k, g in want.items():
            norm = float(torch.linalg.vector_norm(
                g, dtype=torch.float64)) ** 2
            gaps.append(math.sqrt(num[n][k] / norm) if norm else
                        (0.0 if num[n][k] == 0 else math.inf))
        out[n] = max(gaps)
    return out


def tp_rows(case: TpCase, sp: bool) -> int:
    """RMSNorm rows a rank of a run normalises at once: its rows of a
    microbatch of the case's shape, its rows of the sequence under SP."""
    data, model = case.mesh
    return case.shape.global_batch * case.shape.seq_len // (
        data * case.microbatches * (model if sp else 1))


def norm_rows(cfg, rows: int, entered: int, model: int = 1) -> list:
    """(row key, rows, width, row stride or None) of each RMSNorm a rank
    launches (none where the norms are LayerNorms): the block and final
    norms on its ``rows``, and MLA's ``q_norm`` and ``kv_norm`` (the latent
    read in place from the ``wkv_a`` output) on the ``entered`` rows of the
    sequence its attention reads; a hybrid's gated norms on ``model``
    ranks (:func:`split_gated_norms`): ``rmsnorm_split`` on the entered
    rows, at the rank's d_inner / model columns."""
    if cfg.norm_type == "layernorm":
        return []
    out = [("rmsnorm", rows, cfg.d_model, None)]
    if split_gated_norms(cfg, model):
        out.append(("rmsnorm_split", entered,
                    cfg.ssm.d_inner(cfg.d_model) // model, None))
    if cfg.attention_type == "mla":
        a = cfg.mla
        out += [("rmsnorm_q_norm", entered, a.q_lora_rank, None),
                ("rmsnorm_kv_norm", entered, a.kv_lora_rank,
                 a.kv_lora_rank + a.qk_rope_head_dim)]
    return out


def dist_tp(dev="cuda") -> dict:
    """(e): each case's one-device step first, then each run of TP_CASES on
    its case's mesh (tensor-parallel compute on (1, TP_MODEL_AXIS), FSDP
    on (2, 1)), the runs of one mesh in turn in one world of that many
    processes on the one card over gloo (:func:`tp_world`), each against
    its case's one-device step on the same params and batches
    (:func:`tp_run_row`); the FSDP world then runs the two-stage pipeline
    (PIPE_RUN) against its one-device run (:func:`pipe_run_row`).  Logs a ``dist: tp world`` line a world (its
    wall seconds) and returns each run's launches (summed over the ranks),
    keyed by its path."""
    log(f"dist: tp compute mode {compute_mode()}")
    ones, worlds = {}, {}
    for name, case in TP_CASES.items():
        cfg = tp_cfg(case)
        batches = dist_batches(cfg, case.shape, DIST_STEPS, dev)
        t0 = time.monotonic()
        ones[name] = dist_steps(cfg, tp_train_cfg(case), batches, None, dev,
                                grads=case.step0)
        ones[name]["wall_s"] = time.monotonic() - t0
        del ones[name]["params"], batches
        free_device(dev)
        for i in range(len(case.runs)):
            worlds.setdefault(case.mesh, []).append((name, i))
    t0 = time.monotonic()
    pipe_one = pipe_one_device(dev)
    pipe_one["wall_s"] = time.monotonic() - t0
    free_device(dev)
    worlds[TP_CASES["granite-fsdp"].mesh].append((PIPE_RUN, 0))
    out = {}
    for mesh, runs in worlds.items():
        t0 = time.monotonic()
        results = tp_world(runs, dev, grads={
            name: {"one_device": ones[name]["grads"]} for name, _ in runs
            if name in TP_CASES and TP_CASES[name].step0})
        log(f"dist: tp world " + json.dumps({
            "mesh": mesh, "runs": runs, "wall_s": time.monotonic() - t0}))
        for k, ((name, i), ranks) in enumerate(zip(runs, results)):
            if name == PIPE_RUN:
                out["dist:pipeline-2-stages"] = pipe_run_row(ranks,
                                                             pipe_one, dev)
                continue
            out[TP_CASES[name].runs[i][0]] = tp_run_row(name, i, ranks,
                                                        ones[name])
            if run_overlaps(TP_CASES[name], i):
                overlap_row(name, i, ranks, results[k - 1])
    os.remove(pipe_ref_path())
    return out


def tp_run_row(name: str, i: int, ranks: list, one: dict) -> dict:
    """Run ``i`` of ``TP_CASES[name]`` held to its case's one-device step
    ``one``: each rank's loss, grad norm and param norm within TRAIN_TOL
    (for a ``step0`` case, step 0's, and its gradients within
    TRAIN_TOL["grads"]), its launches exactly ``train_launches``, its
    ``max_memory_allocated`` within the case's ``peak_tol`` of
    ``cost_analysis``'s count of its step; a MoE run's ranks dispatched as
    often as each other and by the grouped dispatch.  Logs one ``dist:
    tp`` line (with the bytes staged by purpose and the ranks' step
    seconds) and returns its launches, summed over the ranks."""
    case = TP_CASES[name]
    path, sp, overrides = case.runs[i][:3]
    cfg = tp_cfg(case)
    want = train_launches(cfg, DIST_STEPS * case.microbatches,
                          case.mesh[1])
    gaps = [[{k: abs(a[k] - b[k]) / abs(b[k]) for k in a}
             for a, b in zip(r["metrics"], one["metrics"])] for r in ranks]
    held = 1 if case.step0 else DIST_STEPS
    if case.step0:
        for g in gaps:
            g[0]["grads"] = ranks[0]["grads_gap"]["one_device"]
    peaks = [(r["counted_peak_gb"], r["peak_memory_gb"]) for r in ranks]
    row = {"case": name, "model": case.model,
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "optimizer": case.optimizer,
           "mesh": dict(zip(("data", "model"), case.mesh)),
           "rules": overrides, "seq_parallel": sp,
           "seq_len": case.shape.seq_len,
           "global_batch": case.shape.global_batch,
           "microbatches": case.microbatches,
           **({"encoder_layers": cfg.num_encoder_layers,
               "source_frames": cfg.encdec_source_len}
              if cfg.family == "encdec" else {}),
           "held_steps": held,
           "rmsnorm_rows": tp_rows(case, sp),
           "one_device_metrics": one["metrics"],
           "rank_metrics": [r["metrics"] for r in ranks],
           "relative_gaps": gaps,
           "host_staged_step_s": [r["step_s"] for r in ranks],
           "one_device_step_s": one["step_s"],
           "staged": [r["staged"] for r in ranks],
           "staged_by_purpose": [r["staged_by_purpose"] for r in ranks],
           "dispatches": [r["dispatches"] for r in ranks],
           "peak_gb_counted_measured": peaks,
           "one_device_peak_gb": one["peak_memory_gb"],
           "launches": [r["launches"] for r in ranks],
           "one_device_wall_s": one["wall_s"]}
    log(f"dist: tp {json.dumps(row)} (step times are of exchanges "
        f"staged through the host over gloo, two processes sharing "
        f"one card: not a speed of tensor parallelism or FSDP; "
        f"limits {json.dumps(TRAIN_TOL)}, peak {case.peak_tol})")
    if not all(math.isfinite(v) for r in ranks
               for m in r["metrics"] for v in m.values()) or \
            not all(v <= TRAIN_TOL[k] for g in gaps
                    for s_ in g[:held] for k, v in s_.items()):
        raise AssertionError(f"{path}: a rank disagrees with the "
                             f"one-device step")
    if any(r["launches"] != want for r in ranks):
        raise AssertionError(f"{path}: launches "
                             f"{[r['launches'] for r in ranks]}, "
                             f"expected {want} a rank")
    if not all(abs(c - m) <= case.peak_tol * m for c, m in peaks):
        raise AssertionError(f"{path}: counted peaks off the "
                             f"measured ones: {peaks}")
    if cfg.moe is not None and any(
            r["dispatches"] != ranks[0]["dispatches"]
            or not r["dispatches"]["grouped"] for r in ranks):
        raise AssertionError(f"{path}: dispatches "
                             f"{[r['dispatches'] for r in ranks]}")
    return {k: sum(r["launches"][k] for r in ranks) for k in want}


def overlap_row(name: str, i: int, ranks: list, base: list) -> None:
    """Run ``i`` of ``TP_CASES[name]`` (its exchanges overlapped with
    compute) held to the run before it in its world (``base``: the same
    step without overlap, from the same seed): each rank's loss, grad norm
    and param norm at every step against the base's (the same bits
    expected: the overlapped step's arithmetic is the step's; within
    TRAIN_TOL where a kernel sums in no fixed order), and its exchanges
    run in flight, ``param_gather`` and ``grad_scatter`` both (none: the
    run fails).  Logs one ``dist: fsdp-overlap`` line: rank 0's step
    seconds of both runs, the gaps, staged bytes by purpose and the
    exchanges in flight of both, and each rank's counted and measured
    peak."""
    path = TP_CASES[name].runs[i][0]
    gaps = [[{k: abs(a[k] - b[k]) / abs(b[k]) for k in a}
             for a, b in zip(r["metrics"], q["metrics"])]
            for r, q in zip(ranks, base)]
    row = {"path": path, "base": TP_CASES[name].runs[i - 1][0],
           "step_s_rank0": ranks[0]["step_s"],
           "base_step_s_rank0": base[0]["step_s"],
           "gaps_from_base": gaps,
           "bit_equal": [r["metrics"] == q["metrics"]
                         for r, q in zip(ranks, base)],
           "staged_by_purpose": [r["staged_by_purpose"] for r in ranks],
           "base_staged_by_purpose": [r["staged_by_purpose"] for r in base],
           "overlapped": [r["overlapped"] for r in ranks],
           "base_overlapped": [r["overlapped"] for r in base],
           "peak_gb_counted_measured": [
               (r["counted_peak_gb"], r["peak_memory_gb"]) for r in ranks],
           "base_peak_gb_counted_measured": [
               (r["counted_peak_gb"], r["peak_memory_gb"]) for r in base]}
    log(f"dist: fsdp-overlap {json.dumps(row)} (step times are of "
        f"exchanges staged through the host over gloo, two processes "
        f"sharing one card; limits {json.dumps(TRAIN_TOL)})")
    if not all(v <= TRAIN_TOL[k] for g in gaps for s_ in g
               for k, v in s_.items()):
        raise AssertionError(f"{path}: the overlapped step disagrees with "
                             f"the step without overlap")
    if not all(r["overlapped"].get(p, 0) > 0 for r in ranks
               for p in ("param_gather", "grad_scatter")):
        raise AssertionError(f"{path}: exchanges in flight "
                             f"{row['overlapped']}: none ran overlapped")


def serve_world_cfg(world: ServeWorld, smoke: bool = False):
    """The world's config at its depth (``smoke``: the smoke config, for a
    rehearsal on the CPU, in fp32 for MLA: the deepseek smoke model's own
    bf16 noise, one device against itself in fp32, is 5.3% of its largest
    logit, the size of MODEL_TOL)."""
    cfg = get_config(world.model, smoke=smoke)
    if world.dtype:
        cfg = dataclasses.replace(cfg, dtype=world.dtype)
    if smoke:
        return dataclasses.replace(cfg, dtype="float32") \
            if cfg.attention_type == "mla" else cfg
    if world.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=world.layers)
        if cfg.family == "encdec":
            cfg = dataclasses.replace(cfg, num_encoder_layers=world.layers)
    return cfg


def serve_world_inputs(world: ServeWorld, cfg, dev, smoke: bool = False):
    """(tokens (B, S), prefill extras, max_len, decode extras of step k) of
    the world's workload on ``dev``; prompts right-aligned and BOS-padded
    to the longest, as the engine aligns them.  ``smoke``: a few short
    rows of the same kind (the long one past the smoke window of 16)."""
    if world.workload == "vlm":
        rows, grid, text, max_len = (4, 2, 8, 32) if smoke else \
            (VLM_ROWS, VLM_GRID, VLM_TEXT, VLM_MAX_LEN)
        toks, extras = vlm_inputs(cfg, rows, grid, text, getattr(
            torch, cfg.dtype), dev)
        nxt = int(extras["mrope_pos"].max()) + 1
        return toks, extras, max_len, lambda k: {"mrope_pos": torch.full(
            (rows, 1, 3), nxt + k, dtype=torch.long, device=dev)}
    if smoke:
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
                   for n in ((20, 17, 9, 13) if world.workload == "long"
                             else (12, 7, 10, 5))]
        max_len = 48
    else:
        prompts = smoke_prompts(cfg, "long" if world.workload == "long"
                                else "short")
        max_len = LONG_MAX_LEN if world.workload == "long" else MAX_LEN
    if world.max_len is not None and not smoke:
        max_len = world.max_len
    if world.workload == "encdec":
        toks, extras = encdec_inputs(cfg, prompts, cfg.encdec_source_len,
                                     getattr(torch, cfg.dtype), dev)
        return toks, extras, max_len, lambda k: None
    return right_aligned(prompts, dev), {}, max_len, lambda k: None


def serve_one_device(world: ServeWorld, dev="cuda", smoke=False) -> dict:
    """The world's batch through the one-device ``make_serve_fns`` on the
    seed's params: greedy, each step's last logits (SERVE_NEW, B, V) on
    the host in fp32, the tokens fed back (B, SERVE_NEW - 1), the peak and
    the seconds; the weights are freed on return."""
    cfg = serve_world_cfg(world, smoke)
    params = init_model_params(cfg, seed=SEED, device=dev,
                               compute_dtype=getattr(torch, cfg.dtype))
    toks, extras, max_len, dec = serve_world_inputs(world, cfg, dev, smoke)
    prefill, decode = make_serve_fns(cfg)
    sync = _sync(dev)
    if dev == "cuda":
        sync()
        torch.cuda.reset_peak_memory_stats()
    logits, fed = [], []
    with torch.inference_mode():
        t0 = time.monotonic()
        cache = init_cache(cfg, toks.shape[0], max_len, device=dev)
        last, cache = prefill(params, toks, cache, extras)
        logits.append(last.float().cpu())
        for k in range(SERVE_NEW - 1):
            nxt = torch.argmax(last, dim=-1)
            fed.append(nxt.cpu())
            last, cache = decode(params, cache, nxt[:, None],
                                 toks.shape[1] + k, dec(k))
            logits.append(last.float().cpu())
        sync()
        wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" \
        else None
    del params, cache
    return {"logits": torch.stack(logits), "fed": torch.stack(fed, dim=1),
            "peak_memory_gb": peak, "wall_s": wall}


def serve_rank_world(name: str, mesh, rank: int, workdir: str, dev: str,
                     smoke: bool) -> dict:
    """``SERVE_WORLDS[name]`` on this rank: makes the seed's params and
    keeps its pieces under the world's rules, allocates its cache piece,
    takes its rows of the batch and serves it through
    ``make_serve_fns(cfg, pc=)``, fed the one-device run's tokens
    (``DIR/fed_<name>.pt``); writes each step's logits gathered over
    "model" (its rows, fp32) to ``DIR/logits<R>_<name>.pt`` and returns its
    row (launches, peak, the count's peak, seconds, staged exchanges)."""
    from repro_torch.parallel.sharding import SERVE_RULES
    from repro_torch.serve.engine import (gather_logits, init_cache_piece,
                                          serve_shardings)
    from repro_torch.train.step import rows_for
    world = SERVE_WORLDS[name]
    cfg = serve_world_cfg(world, smoke)
    toks, extras, max_len, dec = serve_world_inputs(world, cfg, dev, smoke)
    pc = PartitionConstraints(SERVE_RULES.with_overrides(**world.rules),
                              mesh, batch=toks.shape[0], max_len=max_len)
    psh, _ = serve_shardings(cfg, pc)
    pieces = init_pieces(cfg, psh, mesh, dev,
                         compute_dtype=getattr(torch, cfg.dtype))
    free_device(dev)
    fed = torch.load(os.path.join(workdir, f"fed_{name}.pt")).to(dev)
    rows = rows_for({"i": torch.arange(toks.shape[0])}, pc)["i"]
    mine = rows_for({"tokens": toks, "fed": fed, **extras}, pc)
    toks, fed = mine.pop("tokens"), mine.pop("fed")
    extras = mine
    cache = init_cache_piece(cfg, pc, device=dev)
    prefill, decode = make_serve_fns(cfg, pc=pc)

    def dec_rows(k):
        ex = dec(k)
        return None if ex is None else rows_for(ex, pc)
    # the count of this rank's calls, on meta copies of its arguments
    counted = max(
        analyze_step(prefill, (pieces, toks, cache, extras))[
            "memory"]["peak_bytes"],
        analyze_step(decode, (pieces, cache, fed[:, :1], toks.shape[1],
                              dec_rows(0)))["memory"]["peak_bytes"])
    sync = _sync(dev)
    if dev == "cuda":
        sync()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    comm.reset_staged()
    logits = []
    t0 = time.monotonic()
    last, cache = prefill(pieces, toks, cache, extras)
    logits.append(gather_logits(cfg, last, pc).float().cpu())
    prefill_s = time.monotonic() - t0
    t0 = time.monotonic()
    for k in range(SERVE_NEW - 1):
        last, cache = decode(pieces, cache, fed[:, k:k + 1],
                             toks.shape[1] + k, dec_rows(k))
        logits.append(gather_logits(cfg, last, pc).float().cpu())
    decode_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" \
        else None
    torch.save(torch.stack(logits),
               os.path.join(workdir, f"logits{rank}_{name}.pt"))
    return {"rank": rank, "coord": list(mesh.get_coordinate()),
            "rows": rows.tolist(), "launches": ops.launch_counts(),
            "peak_memory_gb": peak, "counted_peak_gb": counted / 1e9,
            "prefill_s": prefill_s, "decode_s": decode_s,
            "staged": comm.staged(),
            "cache_gb": sum(t.numel() * t.element_size() for t in
                            flatten(cache).values()) / 1e9,
            "params_gb": sum(t.numel() * t.element_size() for t in
                             flatten(pieces).values()) / 1e9}


def serve_rank_main(argv: list) -> int:
    """One rank of phase 6 (f), in a process of its own: ``--serve-rank R
    --serve-world N --serve-dir DIR --serve-cases C,...``
    (``SERVE_WORLDS[C]``, all on one mesh; ``--serve-dev cpu
    --serve-smoke 1`` rehearse it on the CPU at smoke size).  Joins the
    gloo world (:func:`join_world`), then serves each in turn
    (:func:`serve_rank_world`), writes its row to
    ``DIR/rank<R>_<C>.json`` and frees all it made before the next."""
    import torch.distributed as dist
    args = dict(zip(argv[0::2], argv[1::2]))
    names = args["--serve-cases"].split(",")
    dev = args.get("--serve-dev", "cuda")
    smoke = args.get("--serve-smoke", "0") == "1"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, mesh = join_world("serve", args, SERVE_WORLDS[names[0]].mesh[1],
                            dev)
    try:
        for name in names:
            row = serve_rank_world(name, mesh, rank, args["--serve-dir"],
                                   dev, smoke)
            with open(os.path.join(args["--serve-dir"],
                                   f"rank{rank}_{name}.json"), "w") as f:
                json.dump(row, f)
            del row
            free_device(dev)
    finally:
        dist.destroy_process_group()
    return 0


def serve_world(names: list, feds: dict, dev: str = "cuda",
                smoke: bool = False) -> tuple:
    """``SERVE_WORLDS[name]`` for each of ``names`` (all on one mesh) in
    turn as one world of processes of this script sharing the one card
    (:func:`serve_rank_main`), fed ``feds[name]``, each given
    SERVE_DEADLINE_S; returns each world's rank rows, each with its logits
    (``"logits"``: (SERVE_NEW, its rows, V))."""
    mesh = SERVE_WORLDS[names[0]].mesh
    n = mesh[0] * mesh[1]
    workdir = os.path.join(ROOT, "build", "serve_world")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    for name in names:
        torch.save(feds[name], os.path.join(workdir, f"fed_{name}.pt"))
    run_world("serve", n, workdir, [
        "--serve-cases", ",".join(names), "--serve-dev", dev,
        "--serve-smoke", "1" if smoke else "0"], names, SERVE_DEADLINE_S)
    out = []
    for name in names:
        rows = read_rows(workdir, n, name)
        for r, row in enumerate(rows):
            row["logits"] = torch.load(
                os.path.join(workdir, f"logits{r}_{name}.pt"))
        out.append(rows)
    shutil.rmtree(workdir, ignore_errors=True)
    return out


def serve_rank_rows(world: ServeWorld, smoke: bool = False) -> tuple:
    """(flash (B, H, KV, S, D, Dv), RMSNorm prefill rows) of a rank of the
    world: its rows of the batch, its query heads and the KV heads they
    read, as ``gqa_attention`` hands them to the kernel (MLA: its heads of
    the decompressed K and V, V narrower); the norms as :func:`norm_rows`
    lists them (the whole prompt: no sequence parallelism in serving)."""
    cfg = serve_world_cfg(world, smoke)
    toks, _, _, _ = serve_world_inputs(world, cfg, "cpu", smoke)
    b, s = toks.shape
    dp, tp = world.mesh
    rows = b // dp if b % dp == 0 else b
    h = cfg.num_heads // tp if cfg.num_heads % tp == 0 else cfg.num_heads
    kv = max(1, h * cfg.num_kv_heads // cfg.num_heads)
    d, dv = cfg.head_dim, None
    if cfg.attention_type == "mla":
        d = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        dv = cfg.mla.v_head_dim
    return (rows, h, kv, s, d, dv), norm_rows(cfg, rows * s, rows * s, tp)


def dist_serve(dev="cuda", smoke: bool = False) -> dict:
    """(f): each world's batch through the one-device ``make_serve_fns``
    first (:func:`serve_one_device`, its weights freed), then the worlds of
    SERVE_WORLDS, those of one mesh in turn in one world of processes
    (:func:`serve_world`), each held to its one-device run
    (:func:`serve_world_row`).  Logs a ``dist: serve world`` line a world
    of processes (its wall seconds) and returns each world's
    launches (summed over the ranks), keyed by its path."""
    ones, worlds = {}, {}
    for name, world in SERVE_WORLDS.items():
        t0 = time.monotonic()
        ones[name] = serve_one_device(world, dev, smoke)
        ones[name]["run_s"] = time.monotonic() - t0
        free_device(dev)
        worlds.setdefault(world.mesh, []).append(name)
    out = {}
    for mesh, names in worlds.items():
        t0 = time.monotonic()
        results = serve_world(
            names, {n: ones[n]["fed"] for n in names}, dev, smoke)
        log("dist: serve world " + json.dumps({
            "mesh": mesh, "worlds": names,
            "wall_s": time.monotonic() - t0}))
        for name, ranks in zip(names, results):
            out[f"dist:serve-{name}"] = serve_world_row(name, ranks,
                                                        ones[name], dev,
                                                        smoke)
    return out


def serve_world_row(name: str, ranks: list, one: dict, dev: str,
                    smoke: bool) -> dict:
    """``SERVE_WORLDS[name]``'s ranks held to its one-device run ``one``:
    every rank's logits at each of the SERVE_NEW positions within
    MODEL_TOL of the one-device ones, relative to the largest logit (the
    greedy tokens that agree are logged); on the card its launches exactly
    ``expected_launches`` of one prefill and SERVE_NEW forwards and its
    ``max_memory_allocated`` within PEAK_TOL of ``cost_analysis``'s count
    of its calls.  Logs one ``dist: serve`` line and returns its launches,
    summed over the ranks."""
    world = SERVE_WORLDS[name]
    cfg = serve_world_cfg(world, smoke)
    want_l = expected_launches(cfg, 1, SERVE_NEW, world.mesh[1])
    gaps, agree = [], []
    for r in ranks:
        got, want = r.pop("logits"), one["logits"][:, r["rows"]]
        gaps.append(max(float((g - w).abs().max() / w.abs().max())
                        for g, w in zip(got, want)))
        agree.append(int((got.argmax(-1) == want.argmax(-1)).sum()))
    peaks = [(r["counted_peak_gb"], r["peak_memory_gb"]) for r in ranks]
    path = f"dist:serve-{name}"
    row = {"world": name, "model": world.model,
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "mesh": dict(zip(("data", "model"), world.mesh)),
           "rules": world.rules, "rows": [r["rows"] for r in ranks],
           "positions": SERVE_NEW,
           "largest_relative_gap": gaps,
           "greedy_agree": agree,
           "greedy_of": [SERVE_NEW * len(r["rows"]) for r in ranks],
           "prefill_s": [r["prefill_s"] for r in ranks],
           "decode_s": [r["decode_s"] for r in ranks],
           "one_device_wall_s": one["wall_s"],
           "staged": [r["staged"] for r in ranks],
           "cache_gb": [r["cache_gb"] for r in ranks],
           "params_gb": [r["params_gb"] for r in ranks],
           "peak_gb_counted_measured": peaks,
           "one_device_peak_gb": one["peak_memory_gb"],
           "launches": [r["launches"] for r in ranks],
           "one_device_run_s": one["run_s"]}
    log(f"dist: serve {json.dumps(row)} (seconds are of exchanges "
        f"staged through the host over gloo, two processes sharing "
        f"one card: not a speed of serving on a mesh; limits "
        f"{MODEL_TOL}, peak {PEAK_TOL})")
    if not all(g <= MODEL_TOL for g in gaps):
        raise AssertionError(f"{path}: a rank's logits disagree with "
                             f"the one-device run: {gaps}")
    if dev == "cuda":
        if any(r["launches"] != want_l for r in ranks):
            raise AssertionError(
                f"{path}: launches {[r['launches'] for r in ranks]}, "
                f"expected {want_l} a rank")
        if not all(abs(c - m) <= PEAK_TOL * m for c, m in peaks):
            raise AssertionError(f"{path}: counted peaks off the "
                                 f"measured ones: {peaks}")
    return {k: sum(r["launches"][k] for r in ranks) for k in want_l}


def dist_phase(dev: str = "cuda", backend: str = "nccl",
               phase4=None) -> dict:
    """Phase 6: (a)-(d) in one one-rank world, then (e) in worlds of
    processes of their own; returns each path's launches.  ``phase4``:
    phase 4's ``train_run`` row of the same model, whose step time and peak
    (of ``train()``) (a) reports beside its own."""
    with one_rank_world(backend):
        row, params, mesh, batches = dist_train(dev, phase4=phase4)
        cfg = dataclasses.replace(get_config(TRAIN_MODEL),
                                  num_layers=TRAIN_LAYERS_OF[TRAIN_MODEL])
        dist_compress(params, cfg, batches[0], dev)
        _, pipe = dist_pipeline(params, cfg, batches[0], dev)
        del params, batches
        if dev == "cuda":
            torch.cuda.empty_cache()
        _, a2a = dist_a2a(dev)
    t0 = time.monotonic()
    tp = dist_tp(dev)
    log(f"dist: tp phase {time.monotonic() - t0:.2f} s")
    t0 = time.monotonic()
    served = dist_serve(dev)
    log(f"dist: serve phase {time.monotonic() - t0:.2f} s")
    return {f"dist:{TRAIN_MODEL}": row["launches"],
            "dist:pipeline": pipe, "dist:mixtral-a2a": a2a, **tp, **served}


# ---------------------------------------------------------------------------
# Phase 7: analysis -- launch analysis' counts against the card
# ---------------------------------------------------------------------------


def analysis_cells(trained: dict) -> list:
    """(a): each phase-4 cell's counted flops, bytes and predicted peak
    (``train()``'s own analysis of its step) beside its measured step time
    and peak; returns the failures."""
    bad = []
    for model, row in trained.items():
        a = row["step_analysis"]
        per, mem = a["per_device"], a["memory"]
        step_s = row["step_s_median_2_6"]
        flops_bound = per["flops"] / PEAK_FLOPS[torch.bfloat16]
        bytes_bound = per["bytes"] / PEAK_BYTES
        predicted = mem["peak_bytes"] / 1e9
        measured = row["peak_memory_gb"]
        cell = {"model": model, "flops": per["flops"], "bytes": per["bytes"],
                "elementwise_flops": per["elementwise_flops"],
                "operations": per["operations"],
                "kernels": {k: v["calls"] for k, v in
                            per["kernels"].items()},
                "bound_s": max(flops_bound, bytes_bound),
                "bound_by": "operations" if flops_bound >= bytes_bound
                else "bytes",
                "step_s": step_s,
                "bound_frac_of_step": max(flops_bound, bytes_bound) / step_s,
                "hbm_bw_util": bytes_bound / step_s,
                "predicted_peak_gb": predicted, "measured_peak_gb": measured,
                "peak_gap": (predicted - measured) / measured,
                "memory": {k: v / 1e9 for k, v in mem.items()}}
        log(f"analysis: train {json.dumps(cell)}")
        if per["bytes"] / step_s > RATE_LIMIT * PEAK_BYTES or \
                per["flops"] / step_s > RATE_LIMIT * \
                PEAK_FLOPS[torch.bfloat16]:
            bad.append(f"{model}: the count exceeds the card's rates")
        if not abs(cell["peak_gap"]) <= PEAK_TOL:
            bad.append(f"{model}: predicted peak {predicted:.3f} GB, "
                       f"measured {measured:.3f} GB")
    return bad


def analysis_posted(posted: dict) -> dict:
    """(b): what phase 5's monitored train CLI posted: ``mem_gb_per_s`` and
    ``hbm_bw_util`` a step, the ``train_step`` region's ``bytes`` (the
    step constant ``hlo_bytes``, which the hpm rate times the step time
    gives back) and its roofline fraction on the received calibration."""
    hpm, region = posted["hpm"], posted["train_step"]
    calls = sum(p["calls"] for p in region)
    per_call = sum(p["bytes"] for p in region) / calls
    utils = [p["hbm_bw_util"] for p in hpm]
    implied = [p["mem_gb_per_s"] * 1e9 * max(p["step_time_s"], 1e-9)
               for p in hpm]
    tot = {k: sum(p[k] for p in region) for k in ("flops", "bytes",
                                                  "time_s")}
    calib = posted["calib"][-1]
    frac = roofline_frac(tot, calib["peak_flops"], calib["peak_bw"])
    out = {"hpm_points": len(hpm), "train_step_calls": calls,
           "hlo_bytes": per_call,
           "hbm_bw_util_min": min(utils), "hbm_bw_util_max": max(utils),
           "mem_gb_per_s_median": statistics.median(
               p["mem_gb_per_s"] for p in hpm),
           "train_step_roofline_frac": frac}
    log(f"analysis: monitor {json.dumps(out)}")
    if not hpm or not all(0 < u <= RATE_LIMIT for u in utils):
        raise AssertionError(f"analysis: hbm_bw_util {utils}")
    if not all(math.isclose(b, per_call, rel_tol=1e-9) for b in implied):
        raise AssertionError("analysis: the hpm points' bytes are not the "
                             "train_step region's")
    if not 0 < frac <= RATE_LIMIT:
        raise AssertionError(f"analysis: train_step roofline fraction "
                             f"{frac}")
    return out


def analysis_mesh(phase4=None, dev: str = "cuda",
                  backend: str = "nccl") -> dict:
    """(c): phase 6's granite mesh step at world size 1, traced as the dry
    run traces a cell (``launch.steps``): every axis has size 1, so no
    collective byte is counted."""
    cfg = dataclasses.replace(get_config(TRAIN_MODEL),
                              num_layers=TRAIN_LAYERS_OF[TRAIN_MODEL])
    with one_rank_world(backend):
        mesh = make_mesh_for(1, device_type=dev)
        a = trace_bundle(build_train_bundle(cfg, TRAIN_SHAPE,
                                            dist_train_cfg(), mesh))
    per = a["per_device"]
    out = {"model": TRAIN_MODEL, "mesh": dict(zip(mesh.mesh_dim_names,
                                                  mesh.shape)),
           "collective_operand_bytes": per["collective_operand_bytes"],
           "collective_wire_bytes": per["collective_wire_bytes"],
           "flops": per["flops"], "bytes": per["bytes"],
           "predicted_peak_gb": a["memory"]["peak_bytes"] / 1e9}
    if phase4 is not None:
        out["phase4_flops"] = phase4["step_analysis"]["per_device"]["flops"]
    log(f"analysis: mesh {json.dumps(out)}")
    if per["collective_operand_bytes"] or per["collective_wire_bytes"] or \
            per["by_collective"]:
        raise AssertionError("analysis: collectives counted on a one-rank "
                             "mesh")
    return out


def analysis_dryrun(out_dir: str) -> list:
    """(d): the dry run's DRY_CELLS on this machine's CPU (meta tensors, a
    fake world of 256 or 512 ranks; the H100's data-sheet rates)."""
    rows = []
    for arch, shape, multi in DRY_CELLS:
        r = dryrun.run_cell(arch, shape, multi, out_dir)
        log(f"analysis: dryrun {dryrun.summary(r)}")
        if r["status"] != "ok":
            raise AssertionError(f"analysis: dry run {arch} {shape}: "
                                 f"{r.get('error', r['status'])}")
        rows.append(r)
    return rows


def analysis_phase(trained: dict, posted: dict) -> None:
    """Phase 7: (a)-(d); every cell of (a) prints before a failure is
    raised."""
    bad = analysis_cells(trained)
    analysis_posted(posted)
    analysis_mesh(trained.get(TRAIN_MODEL))
    t0 = time.monotonic()
    analysis_dryrun(os.path.join(ROOT, "build", "dryrun_torch"))
    log(f"analysis: dry run {time.monotonic() - t0:.2f} s")
    if bad:
        raise AssertionError("analysis: " + "; ".join(bad))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # Phase 1: build
    t0 = time.monotonic()
    kbuild.build(ptxas_verbose=True)
    kbuild.load_library()
    log(f"build: {time.monotonic() - t0:.2f} s into "
        f"{os.path.relpath(kbuild.BUILD_ROOT, ROOT)}")
    for r in ptxas_report():
        log(f"ptxas: {json.dumps(r)}")
    log(f"gpu: {gpu_line()}")

    plen, lplen = (max(len(p) for p in serve_plan(m)[1])
                   for m in ("granite-3-8b", "mixtral-8x7b"))

    # Phase 2: kernels against plain
    t0 = time.monotonic()
    rows = kernel_checks(plen, lplen)
    log(f"kernels: all checks within tolerance "
        f"({time.monotonic() - t0:.2f} s)")

    # Phase 3: serve, one model after the other; the VLM and the
    # encoder-decoder last, through make_serve_fns
    served = {}
    for name in MODELS:
        t0 = time.monotonic()
        served[name] = serve(name)
        torch.cuda.empty_cache()
        log(f"serve: {name} phase {time.monotonic() - t0:.2f} s")
    for name, fn in ((VLM_MODEL, serve_vlm), (ENCDEC_MODEL, serve_encdec)):
        t0 = time.monotonic()
        served[name] = fn()
        torch.cuda.empty_cache()
        log(f"serve: {name} phase {time.monotonic() - t0:.2f} s")

    # Phase 4: train, once the served weights are freed
    t0 = time.monotonic()
    rows.update(train_kernel_checks())
    launches = {m: served[m]["launches"] for m in served}
    for name in parity_models():
        train_parity(name)
    trained = {}
    for model in TRAIN_LAYERS_OF:
        trained[model] = train_run(model)
        launches[f"train:{model}"] = trained[model]["launches"]
    log(f"train: phase {time.monotonic() - t0:.2f} s")

    # Phase 5: the monitored job over HTTP through the CLIs
    t0 = time.monotonic()
    rows.update(monitor_kernel_rows())
    _, monitor_launches, posted = monitor_phase()
    launches.update(monitor_launches)
    log(f"monitor: phase {time.monotonic() - t0:.2f} s")

    # Phase 6: the data-parallel path at world size 1 through NCCL, then
    # tensor-parallel compute on two ranks sharing the card over gloo
    t0 = time.monotonic()
    dist_launches = dist_phase(phase4=trained[TRAIN_MODEL])
    launches.update(dist_launches)
    # rows timed in phase 2 for (e)'s paths only
    rows.update({p: {} for p in dist_launches if p not in rows})
    log(f"dist: phase {time.monotonic() - t0:.2f} s")

    # Phase 7: the step counts of launch analysis against the card
    t0 = time.monotonic()
    analysis_phase(trained, posted)
    log(f"analysis: phase {time.monotonic() - t0:.2f} s")

    # Phase 8: kernels line (launches summed over the paths; numbers at
    # zamba2-7b's prefill shapes, the RMSNorm backward's at granite's
    # training shape, the SSD backward's at zamba2's, the statistic-from-
    # outside mode's at a rank's rows of zamba2's TP world; per path the
    # rows each kernel was timed at), then the result
    main_rows = {"rmsnorm_backward": f"train:{TRAIN_MODEL}",
                 "ssd_scan_backward": "train:zamba2-7b",
                 "rmsnorm_split": "dist:tp-zamba2-sp",
                 "rmsnorm_split_backward": "dist:tp-zamba2-sp"}
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = rows[main_rows.get(name, "zamba2-7b")][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(n[name] for n in launches.values()),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{k: r[k] for k in ("vs_library", "frac_of_bound") if k in r},
            "paths": {p: {"launches": n[name],
                          "rows": [{k: v for k, v in rr.items()
                                    if k != "name"}
                                   for rr in rows[p].values()
                                   if rr["name"] == name]}
                      for p, n in launches.items() if n[name]}})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(tp_rank_main(sys.argv[1:]) if "--tp-rank" in sys.argv
             else serve_rank_main(sys.argv[1:])
             if "--serve-rank" in sys.argv else main())
