"""PyTorch / CUDA port of the JAX model tier, for one NVIDIA H100.

The package mirrors ``repro``'s module names (``models.layers``,
``models.moe``, ``kernels.ops`` ...) so each counterpart is easy to find,
but it imports nothing of ``repro`` and never imports jax: what it needs
from the jax-free half (``ModelConfig``, the config registry) it keeps as
its own copy.  Submodules load lazily, so ``import repro_torch`` stays
cheap and imports no torch either.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :mod:`repro_torch.device`).
"""
from __future__ import annotations

import importlib

__all__ = ["configs", "data", "device", "kernels", "launch", "models",
           "optim", "runtime", "weights", "workloads"]


def __getattr__(name: str):
    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
