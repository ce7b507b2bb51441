"""Architecture specification — the port's own copy of ``repro.models.spec``.

The port imports nothing of ``repro``, so :class:`ModelConfig` is copied
here field for field (same names, same defaults); the parity tests build
both from the same registry entry and would notice a drift.  ``dtype`` and
``param_dtype`` stay dtype *names*; :func:`torch_dtype` maps them.  The
module imports torch only inside :func:`torch_dtype`, so the config
registry loads without it (the simulator's replay path is torch-free).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Tuple

if TYPE_CHECKING:  # pragma: no cover - typing only
    import torch

_DTYPES = ("float32", "bfloat16")


def torch_dtype(name) -> torch.dtype:
    """Map a dtype name ("bfloat16" or "float32") to a torch dtype."""
    if str(name) not in _DTYPES:
        raise ValueError(f"unsupported dtype name {name!r}")
    import torch
    return getattr(torch, str(name))


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1               # MoE FFN on layers where idx % every == r
    capacity_factor: float = 1.25
    moe_impl: str = "gather"
    # SSM / hybrid
    layer_pattern: Tuple[str, ...] = ()
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # encoder-decoder (whisper-style)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500
    # VLM
    n_img_tokens: int = 0
    # attention extras
    sliding_window: int = 0          # 0 = full causal
    # execution (dtype names)
    dtype: Any = "bfloat16"
    param_dtype: Any = "float32"
    remat: bool = True
    scan_layers: bool = True
    ffn_chunks: int = 1
    ssm_scan_groups: int = 1

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV-cache footprint of one token across all attention layers."""
        if self.layer_pattern:
            attn_per_block = sum(1 for kind in self.layer_pattern
                                 if kind == "attn")
            attn_layers = self.n_blocks * attn_per_block
        else:
            attn_layers = self.n_layers
        return self.n_kv_heads * self.d_head * 2 * dtype_bytes * attn_layers

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.layer_pattern:
            return self.layer_pattern
        return ("attn",)

    @property
    def block_size(self) -> int:
        return len(self.pattern)

    @property
    def n_blocks(self) -> int:
        if self.n_layers % self.block_size:
            raise ValueError(
                f"{self.name}: n_layers {self.n_layers} not divisible by "
                f"pattern period {self.block_size}")
        return self.n_layers // self.block_size

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ------------------------------------------------------- logical sharding
class PartitionSpec(tuple):
    """A tensor's sharding: per dim ``None`` (replicated), a mesh axis name,
    or a tuple of names (one dim over several axes, outer first).  The
    port's counterpart of ``jax.sharding.PartitionSpec``; like it, a
    one-name tuple is stored as the name."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, (tuple, list)) and len(p) == 1
            else tuple(p) if isinstance(p, list) else p for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def logical_to_pspec(axes, rules) -> PartitionSpec:
    """Logical axis names -> a :class:`PartitionSpec` under ``rules``
    (logical name -> mesh axis, tuple of axes, or None).  A mesh axis may
    shard one dim of an array at most: a later name that maps onto an axis
    already used is replicated."""
    parts = []
    used = set()
    for a in axes:
        m = rules.get(a) if a is not None else None
        if m is not None:
            key = tuple(m) if isinstance(m, (tuple, list)) else (m,)
            if any(k in used for k in key):
                m = None
            else:
                used.update(key)
        parts.append(m)
    return PartitionSpec(*parts)
