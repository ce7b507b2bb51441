"""Seeded weights for a cell, drawn on its device in a few large calls.

A reference family's ``leaves(model)`` names every leaf of the program's
tree, its shape, how it is drawn and whether it is served in the
activation dtype ("act") or in f32.  :func:`draw` makes one flat buffer
per dtype with one ``randn`` call each, from a generator on the device
seeded by ``--seed``, and hands out aligned views of it, scaled in place.
The program and the reference get the same tensors.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

ALIGN = 64                 # elements: every leaf starts 128-byte aligned


def seed_for(seed: int, stream: int) -> int:
    """A generator seed for one of a run's streams (weights 0, prompts of
    call i: i + 1, warm-up: negative), fixed by ``--seed``."""
    return (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9
            + 0x94D049BB133111EB) % (2 ** 63)


def _layout(leaves, kind: str):
    """(offsets, total) of the leaves served as ``kind``, each aligned."""
    offs, n = {}, 0
    for path, (shape, _, dt) in leaves.items():
        if dt == kind:
            offs[path] = n
            n += -(-math.prod(shape) // ALIGN) * ALIGN
    return offs, n


def draw(leaves: Dict[str, Tuple], seed: int, act_dtype: torch.dtype,
         device) -> Dict[str, torch.Tensor]:
    """``{path: tensor}`` of every leaf, drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed_for(seed, 0))
    out = {}
    for kind, dtype in (("act", act_dtype), ("f32", torch.float32)):
        offs, total = _layout(leaves, kind)
        if not offs:
            continue
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        uni = None
        if any(leaves[p][1][0] in ("A_log", "dt_bias") for p in offs):
            uni = torch.rand(total, generator=gen, device=device,
                             dtype=torch.float32)
        for path, off in offs.items():
            shape, init, _ = leaves[path]
            n = math.prod(shape)
            t = flat[off:off + n].view(shape)
            if init[0] == "normal":
                t.mul_(init[1])
            elif init[0] == "scale":
                t.mul_(0.1).add_(1.0)
            elif init[0] == "A_log":           # A uniform in [1, 16]
                t.copy_(torch.log(1.0 + 15.0 * uni[off:off + n].view(shape)))
            elif init[0] == "dt_bias":         # dt log-uniform in [1e-3, 0.1]
                dt = torch.exp(math.log(1e-3) + uni[off:off + n].view(shape)
                               * (math.log(0.1) - math.log(1e-3)))
                t.copy_(dt + torch.log(-torch.expm1(-dt)))
            else:
                raise ValueError(f"{path}: unknown init {init!r}")
            out[path] = t
    return {path: out[path] for path in leaves}


def tree(flat: Dict[str, torch.Tensor]):
    """``{"a/b": t}`` -> the nested dict the program takes."""
    root: Dict = {}
    for path, t in flat.items():
        node = root
        *parents, leaf = path.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = t
    return root
