"""Checkpoints of the port (counterpart of ``repro.checkpoint``), in the
reference's on-disk layout: a step saved by either package loads in the
other."""
from .checkpoint import (CheckpointManager, latest_step, load_checkpoint,
                         save_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint",
           "latest_step"]
