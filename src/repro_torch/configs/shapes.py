"""Assigned input shapes (identical for every LM-family architecture).

A copy of ``repro.configs.shapes``.

``train_*`` lowers ``train_step``; ``prefill_*`` lowers the prefill forward;
``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV /
SSM cache of ``seq_len``).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
    sub_quadratic_only: bool = False


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1,
                           sub_quadratic_only=True),
}


def shape_applicable(cfg, spec: ShapeSpec) -> bool:
    """long_500k only runs for sub-quadratic (SSM / hybrid) archs."""
    if not spec.sub_quadratic_only:
        return True
    return any(k != "attn" for k in cfg.pattern)
