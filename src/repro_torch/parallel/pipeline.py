"""GPipe-style pipeline parallelism over a mesh axis (port of
``repro.parallel.pipeline``).

Stage s (the rank at coordinate s of the ``"pipe"`` axis) holds slice s of
the stacked params.  Microbatches tick through ``num_microbatches + stages
- 1`` steps: at tick t stage s works on microbatch t - s, stage 0 takes it
from the batch, every other stage from what the stage before it sent at the
previous tick (``batch_isend_irecv``: neighbour-only traffic), and the last
stage keeps its outputs.  The reference's ticks where a stage holds no
microbatch compute what nothing reads; here they are skipped.  At the end
the last stage's outputs are broadcast to every stage (the reference uses a
masked ``psum``).  The bubble fraction is (S-1)/(M+S-1); pick M >= 4*S.

The forward only: the hand-offs carry no gradient.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.models.params import tree_map
from repro_torch.parallel import comm


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   mesh, axis: str = "pipe", num_microbatches: int = 4):
    """Run ``x`` through ``stages`` sequential stages, pipelined.

    stage_fn(params_slice, x_mb) -> y_mb   (one stage's compute; y_mb of
    x_mb's shape and dtype, as the reference's ring hand-off needs)
    stage_params: tree with a leading stage dimension (the axis' size);
    this rank reads slice s (a view).
    x: (B, ...) the whole batch on every rank; B must divide into
    ``num_microbatches``.  Returns y: (B, ...) after all stages, on every
    rank (a collective: every rank of the axis calls it)."""
    stages = comm.axis_sizes(mesh)[axis]
    b = x.shape[0]
    m = num_microbatches
    if b % m:
        raise ValueError(f"batch {b} does not split into {m} microbatches")
    s = comm.coordinate(mesh)[axis]
    mine = tree_map(lambda v: v[s], stage_params)
    xs = x.reshape((m, b // m) + tuple(x.shape[1:]))
    outputs = torch.zeros_like(xs)
    group = mesh.get_group(axis) if stages > 1 else None
    ranks = dist.get_process_group_ranks(group) if group is not None else []
    state = None
    for t in range(m + stages - 1):
        if 0 <= t - s < m:
            y = stage_fn(mine, xs[t] if s == 0 else state)
            if s == stages - 1:
                outputs[t - s] = y
        send = y if s < stages - 1 and 0 <= t - s < m else None
        recv = None
        if s > 0 and 0 <= t + 1 - s < m:
            state = recv = torch.empty_like(xs[0])
        if send is not None or recv is not None:
            comm.send_recv(send, ranks[(s + 1) % stages], recv, ranks[s - 1],
                           group, stages)
    if group is not None:
        comm.broadcast(outputs, ranks[-1], group, stages)
    return outputs.reshape((b,) + tuple(x.shape[1:]))


def bubble_fraction(stages: int, num_microbatches: int) -> float:
    """Pipeline bubble overhead (the napkin-math term used in §Perf)."""
    return (stages - 1) / (num_microbatches + stages - 1)
