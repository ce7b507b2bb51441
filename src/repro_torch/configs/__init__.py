"""Architecture config registry of the port (the families ported so far).

Each module keeps the same name and values as its ``repro.configs``
counterpart; the other architectures join as their families are ported.
"""
from __future__ import annotations

import importlib
from typing import List

from ..models.spec import ModelConfig

ALIASES = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "mamba2-780m": "mamba2_780m",
}


def _module(name: str):
    mod = ALIASES.get(name, name)
    if mod not in ALIASES.values():
        raise ValueError(f"unknown or not yet ported architecture {name!r}; "
                         f"ported: {sorted(ALIASES)}")
    return importlib.import_module(f".{mod}", __package__)


def get_config(name: str) -> ModelConfig:
    """Full-size (paper-exact) config for a ported architecture."""
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU tests."""
    return _module(name).smoke()


def list_archs() -> List[str]:
    return list(ALIASES.keys())
