"""Learning-rate schedules (counterpart of ``repro.optim.schedules``):
pure functions of the step count, in f32."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                       final_frac: float = 0.1):
    """Linear warm-up to ``peak_lr``, then a cosine down to ``final_frac``
    of it at ``total_steps``.  ``schedule(step)`` takes an int or a tensor
    and returns an f32 tensor (on the step's device)."""
    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(1.0, warmup_steps)
        t = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        t = torch.clamp(t, 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule
