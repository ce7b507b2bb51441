"""Parameter trees: path flattening and the loader from JAX params.

A params tree is a nested dict of tensors keyed like the JAX package's
pytree (``blocks/l0/attn/wq`` ...), with every ``blocks`` leaf stacked over
the blocks.  :func:`from_jax_params` takes that pytree exported with
``np.asarray`` (no jax needed here) so both packages compute with the same
weights: ``jax.random`` init cannot be reproduced in torch.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> ``{"a/b/c": leaf}``."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``{"a/b/c": leaf}`` -> nested dict."""
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def from_jax_params(tree_of_numpy, device="cpu") -> Dict[str, Any]:
    """JAX params pytree of numpy arrays -> the port's params tree.

    Leaves keep their shapes and paths; f32 leaves stay f32, and any other
    float type (bf16 arrives as an ``ml_dtypes`` array) is widened to f32,
    which is exact.
    """
    flat = {}
    for path, leaf in flatten(tree_of_numpy).items():
        arr = np.asarray(leaf).astype(np.float32)     # a writable copy
        flat[path] = torch.from_numpy(arr).to(device)
    return unflatten(flat)
