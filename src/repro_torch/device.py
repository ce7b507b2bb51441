"""Device resolution: the port runs on the GPU unless asked for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` -> the CUDA device, raising when there is none.

    ``"cpu"`` is the only way to get the CPU (the tests ask for it, and the
    kernels' plain versions then run).  There is no silent fallback: a
    caller that wanted the card and got the CPU would measure the wrong
    machine.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev
