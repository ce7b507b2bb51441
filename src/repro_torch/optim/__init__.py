"""Optimizers and schedules of the port (counterpart of ``repro.optim``)."""
from .optimizers import (Optimizer, adafactor, adamw, clip_by_global_norm,
                         global_norm, with_master)
from .schedules import cosine_with_warmup

__all__ = ["adamw", "adafactor", "with_master", "Optimizer", "global_norm",
           "clip_by_global_norm", "cosine_with_warmup"]
