"""Gradient compression with error feedback (counterpart of
``repro.runtime.compression``).

Two codecs for the gradient reduction across pods: ``bf16`` rounds each
gradient to bf16 and back (2x on the wire), and ``int8`` quantizes each
leaf to int8 with its absmax scale (4x) and carries the quantization
residual to the next step (error feedback).  The round trip is computed
in place of the transport, so the numbers are what the wire would carry.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..weights import tree_map


class CompressionState(NamedTuple):
    error: Any   # tree of residuals (None when the codec has no feedback)


def _quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_gradients(grads, codec: str = "none",
                       state: Optional[CompressionState] = None):
    """Returns (decompressed-after-transport grads, new state)."""
    if codec == "none":
        return grads, state
    if codec == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16).float(), grads), state
    if codec == "int8":
        err = (state.error if state is not None and state.error is not None
               else tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                             grads))

        def one(g, e):
            g32 = g.float() + e
            q, scale = _quantize_int8(g32)
            deq = q.float() * scale
            return deq.to(g.dtype), g32 - deq

        outs = tree_map(one, grads, err)
        return (tree_map(lambda o: o[0], outs),
                CompressionState(error=tree_map(lambda o: o[1], outs)))
    raise ValueError(f"unknown codec {codec!r}")


def make_compressor(codec: str):
    """(init(grads) -> state, apply(grads, state) -> (grads, state))."""
    if codec not in ("none", "bf16", "int8"):
        raise ValueError(f"unknown codec {codec!r}")

    def init(grads):
        if codec == "int8":
            return CompressionState(error=tree_map(
                lambda g: torch.zeros_like(g, dtype=torch.float32), grads))
        return CompressionState(error=None)

    def apply(grads, state):
        return compress_gradients(grads, codec, state)

    return init, apply
