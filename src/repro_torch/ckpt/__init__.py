"""Checkpoints (port of ``repro.ckpt``)."""

from repro_torch.ckpt.checkpoint import (
    CheckpointManager, available_steps, latest_step, load_checkpoint,
    save_checkpoint)

__all__ = ["CheckpointManager", "available_steps", "latest_step",
           "load_checkpoint", "save_checkpoint"]
