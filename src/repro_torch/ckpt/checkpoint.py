"""Atomic, keep-k checkpoints with async write-out (port of
``repro.ckpt.checkpoint``), in the reference's on-disk format.

* **format**: ``<dir>/step_<10 digits>/`` holds one ``<group>.npz`` per
  top-level group (``params``, ``opt_state``, ...) keyed by the "/"-joined
  tree paths, plus ``manifest.json`` (step, metadata, groups, time).  A
  checkpoint written here loads in ``repro.ckpt.load_checkpoint`` and the
  reverse, with the same tree layouts;
* **atomic**: a checkpoint is written to ``.tmp-<step>``, fsynced and
  renamed, so a crash mid-save never corrupts the latest good checkpoint;
* **keep-k** garbage collection and a **background writer**: the
  device-to-host copy happens at ``save`` (values frozen), the file write on
  a thread that ``wait()`` joins.

Arrays are saved as numpy.  A bf16 leaf is saved as its raw 2-byte words
(numpy dtype ``V2``), which is what ``np.savez`` writes for the
reference's bfloat16 arrays, and read back from them.  ``load_checkpoint``
puts the leaves back into the structure, dtypes and device of the
templates.

Under a mesh (the data-parallel step's pieces, :mod:`repro_torch.train.step`)
a checkpoint still holds whole leaves: ``CheckpointManager.save`` with
``shardings`` gathers them (every rank calls it) and the rank at the mesh's
origin writes them.  ``load_checkpoint(..., shardings=, mesh=)`` reads the
whole leaves on every rank and keeps the slice of each that the rank holds
under the mesh it has now, which may be smaller than the writer's (the
elastic restart path, as the reference's ``shardings=``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models.params import flatten, unflatten
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import gather_tree


def to_numpy(leaf) -> np.ndarray:
    """A tensor (or array, or number) -> a host numpy array; bf16 as raw
    2-byte words.  A tensor is always copied: a CPU tensor's numpy view
    would share memory that the next step's in-place update rewrites while
    the background writer is still saving it."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def from_numpy(arr, like: torch.Tensor) -> torch.Tensor:
    """numpy array -> a tensor with ``like``'s dtype and device (2-byte
    words, ``V2`` or a bfloat16 type, are read as bf16)."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"shape {tuple(t.shape)}, expected "
                         f"{tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:010d}")


def save_checkpoint(ckpt_dir: str, step: int, trees: dict,
                    metadata: Optional[dict] = None) -> str:
    """trees: {"params": tree, "opt_state": tree, ...} of tensors or numpy
    arrays; returns the checkpoint's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}")
    final = _step_dir(ckpt_dir, step)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "metadata": metadata or {},
                "groups": sorted(trees), "time": time.time()}
    for group, tree in trees.items():
        arrays = {k: to_numpy(v) for k, v in flatten(tree).items()}
        np.savez(os.path.join(tmp, f"{group}.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def available_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, d, "manifest.json")):
            out.append(int(d[len("step_"):]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def read_group(ckpt_dir: str, group: str,
               step: Optional[int] = None) -> tuple:
    """(step, {"/"-joined path: numpy array}) of one group, the latest step
    by default."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = _step_dir(ckpt_dir, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if group not in manifest.get("groups", []):
        raise KeyError(f"checkpoint {path} holds no {group} group")
    with np.load(os.path.join(path, f"{group}.npz")) as z:
        return manifest["step"], {k: z[k] for k in z.files}


def load_checkpoint(ckpt_dir: str, templates: dict,
                    step: Optional[int] = None,
                    shardings: Optional[dict] = None, mesh=None):
    """Load a step (the latest by default) into the templates' structure.

    templates: {"params": tree, ...}; each leaf gives the loaded array's
    shape, dtype and device.  ``shardings``: {group: Sharding tree} on
    ``mesh``; a sharded group's leaves are this rank's pieces of the whole
    arrays (``Sharding.cut``; the templates are the pieces).  Returns
    (step, {"params": tree, ...})."""
    step = step if step is not None else latest_step(ckpt_dir)
    coord = comm.coordinate(mesh)
    out = {}
    for group, template in templates.items():
        step, flat = read_group(ckpt_dir, group, step)
        fsh = flatten(shardings[group]) if shardings and \
            group in shardings else {}
        tree = {}
        for key, like in flatten(template).items():
            if key not in flat:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = flat[key]
            if key in fsh:
                if tuple(arr.shape) != fsh[key].shape:
                    raise ValueError(f"{key}: shape {arr.shape}, the mesh's "
                                     f"leaf is {fsh[key].shape}")
                arr = fsh[key].cut(arr, coord)
            tree[key] = from_numpy(arr, like)
        out[group] = unflatten(tree)
    return step, out


class CheckpointManager:
    """keep-k + async write-out wrapper around save/load."""

    def __init__(self, ckpt_dir: str, keep: int = 3, async_write: bool = True):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, trees: dict, metadata: Optional[dict] = None,
             shardings: Optional[dict] = None, mesh=None):
        """Save ``trees``; with ``shardings`` ({group: Sharding tree}) the
        trees are this rank's pieces on ``mesh``: every rank calls this, the
        pieces are gathered, and the rank at the mesh's origin writes."""
        self.wait()
        if shardings:
            trees = {g: gather_tree(t, shardings[g], mesh) if g in shardings
                     else t for g, t in trees.items()}
            if any(comm.coordinate(mesh).values()):
                return
        # device->host now (values frozen), file IO possibly in background
        host_trees = {g: {k: to_numpy(v) for k, v in flatten(t).items()}
                      for g, t in trees.items()}

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_trees, metadata)
                self._gc()
            except Exception as e:           # surfaced on next wait()
                self._error = e

        if self.async_write:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_if_failed()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def restore(self, templates: dict, step: Optional[int] = None,
                shardings: Optional[dict] = None, mesh=None):
        self.wait()
        return load_checkpoint(self.ckpt_dir, templates, step, shardings,
                               mesh)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.ckpt_dir)

    def _gc(self):
        steps = available_steps(self.ckpt_dir)
        for s in steps[:-self.keep]:
            shutil.rmtree(_step_dir(self.ckpt_dir, s), ignore_errors=True)
