"""Architecture config registry of the port: every architecture of
``repro.configs``, in its order.

Each module keeps the same name and values as its ``repro.configs``
counterpart.  mistral-large-123b, qwen3-moe-235b-a22b and jamba do not fit
one card at full size: they serve at smoke size, and the calibration
harness reads only their dimensions.
"""
from __future__ import annotations

import importlib
from typing import List

from ..models.spec import ModelConfig
# Re-exported shape registry, as ``repro.configs`` does.
from .shapes import SHAPES, ShapeSpec, shape_applicable  # noqa: F401

ALIASES = {
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "mistral-large-123b": "mistral_large_123b",
    "qwen2-1.5b": "qwen2_1_5b",
    "qwen3-14b": "qwen3_14b",
    "qwen3-1.7b": "qwen3_1_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "whisper-medium": "whisper_medium",
    "mamba2-780m": "mamba2_780m",
}


def _module(name: str):
    mod = ALIASES.get(name, name)
    if mod not in ALIASES.values():
        raise ValueError(f"unknown architecture {name!r}; known: "
                         f"{sorted(ALIASES)}")
    return importlib.import_module(f".{mod}", __package__)


def get_config(name: str) -> ModelConfig:
    """Full-size (paper-exact) config for a ported architecture."""
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU tests."""
    return _module(name).smoke()


def list_archs() -> List[str]:
    return list(ALIASES.keys())


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (shapes on the meta device, no
    allocation)."""
    import torch
    from ..models import api
    from ..weights import tree_leaves
    params = api.init(cfg, torch.Generator(), torch.device("meta"))
    return sum(t.numel() for t in tree_leaves(params))


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE: top_k of n_experts)."""
    total = param_count(cfg)
    if cfg.n_experts <= 0:
        return total
    # expert weights: 3 matrices per MoE layer
    n_moe_layers = sum(1 for i in range(cfg.n_layers)
                       if i % cfg.moe_every == cfg.moe_every - 1)
    per_expert = 3 * cfg.d_model * cfg.d_ff_expert
    expert_total = n_moe_layers * cfg.n_experts * per_expert
    expert_active = n_moe_layers * cfg.top_k * per_expert
    return total - expert_total + expert_active
