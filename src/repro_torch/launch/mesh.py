"""Device meshes on ``torch.distributed`` (port of ``repro.launch.mesh``).

A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` over the
ranks of the default process group, which the caller has initialised
(``torch.distributed.init_process_group`` with an address, a world size and
a rank: nothing on the machine tells a program of a cluster).  Building a
mesh is a collective: every rank calls it.  Meshes are on the CUDA device
unless the caller asks for another (``device_type="cpu"`` with gloo, as
the tests run).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@contextmanager
def fake_world(n: int, rank: int = 0):
    """A "fake" process group of ``n`` ranks in which this process is
    ``rank`` (``torch.testing``'s ``FakeStore``): meshes build on it and
    collectives return at once, exchanging nothing, so a production mesh
    can be laid out in one process without a card (the dry run).  The
    group is global to the process: one world at a time, destroyed on
    exit."""
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; a fake "
                           "world needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """16 x 16 = 256 ranks a pod; 2 pods = 512 ranks with a leading "pod"
    axis (data parallelism spans pod x data, TP spans model).  Built only
    on a world of that size (:func:`fake_world` makes one without cards):
    any other raises."""
    shape, names = PRODUCTION_SHAPES[multi_pod]
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(
            f"the production mesh {shape} needs {n} ranks, this world has "
            f"{world}; to lay it out without them, run the dry run "
            f"(python -m repro_torch.launch.dryrun), which builds it in "
            f"fake_world({n})")
    return init_device_mesh(device_type or "cuda", shape,
                            mesh_dim_names=names)


def tp_size_for(n: int, model: int = 0) -> int:
    """The reference's choice of the "model" axis for ``n`` ranks: the
    largest power of two whose square times 4 fits in ``n`` (or the
    request), halved until it divides ``n``."""
    if model <= 0:
        model = 1
        while model * model * 4 <= n:
            model *= 2
    while n % model != 0:
        model //= 2
    return model


def make_mesh_for(devices: Optional[int] = None, *, model: int = 0,
                  device_type: Optional[str] = None):
    """Elastic ("data", "model") mesh for the ranks this job has (the
    world size by default): the restart path after a node failure builds
    its mesh through here."""
    n = devices if devices is not None else dist.get_world_size()
    model = tp_size_for(n, model)
    return init_device_mesh(device_type or "cuda", (n // model, model),
                            mesh_dim_names=("data", "model"))
