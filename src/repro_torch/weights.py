"""Parameter trees: path flattening, tree maps and the loaders from JAX.

A params tree is a nested dict of tensors keyed like the JAX package's
pytree (``blocks/l0/attn/wq`` ...), with every ``blocks`` leaf stacked over
the blocks.  :func:`from_jax_params` takes that pytree exported with
``np.asarray`` (no jax needed here) so both packages compute with the same
weights: ``jax.random`` init cannot be reproduced in torch.
:func:`from_jax_opt_state` carries an optimizer state tree the same way
(``with_master(adamw)``: ``master``, ``inner/m``, ``inner/v``,
``inner/count``; ``adafactor``: ``v/.../vr``, ``vc`` or ``v``, ``count``),
and :func:`to_numpy` is the way back.  bf16 leaves arrive as ``ml_dtypes``
arrays; they are read through their 16-bit pattern, so nothing here imports
``ml_dtypes``.
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


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of a nested dict, in its flattening order."""
    return list(flatten(tree).values())


def _is_bf16(arr: np.ndarray) -> bool:
    return arr.dtype.name == "bfloat16" and arr.dtype.itemsize == 2


def _leaf_to_torch(leaf, keep_bf16: bool, device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if _is_bf16(arr):
        if keep_bf16:
            bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.int16)
            return torch.from_numpy(bits).view(torch.bfloat16).to(device)
        arr = arr.astype(np.float32)
    elif arr.dtype.kind == "f":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr)).to(device)   # a writable copy


def from_jax_params(tree_of_numpy, device="cpu", *,
                    keep_bf16: bool = False) -> Dict[str, Any]:
    """JAX params pytree of numpy arrays -> the port's params tree.

    Leaves keep their shapes and paths; f32 leaves stay f32.  Any other
    float type (bf16 arrives as an ``ml_dtypes`` array) is widened to f32,
    which is exact, unless ``keep_bf16``: then bf16 leaves stay bf16 (the
    working params of training, ``param_dtype = dtype``), bit for bit.
    """
    return unflatten({path: _leaf_to_torch(leaf, keep_bf16, device)
                      for path, leaf in flatten(tree_of_numpy).items()})


def from_jax_opt_state(tree_of_numpy, device="cpu") -> Dict[str, Any]:
    """A JAX optimizer state tree of numpy arrays (``with_master(adamw)``
    or ``adafactor``, exported with ``np.asarray``) -> the port's state tree
    of the same paths: f32 moments and master stay f32, the int32 step
    count stays an int32 scalar, bf16 leaves stay bf16."""
    return unflatten({path: _leaf_to_torch(leaf, True, device)
                      for path, leaf in flatten(tree_of_numpy).items()})


def to_numpy(tree) -> Dict[str, Any]:
    """A params or optimizer state tree -> nested dict of numpy arrays on
    the host (the inverse of the loaders): f32 and integer leaves exactly,
    bf16 leaves widened to f32 (exact; ``astype(jnp.bfloat16)`` restores
    them)."""
    def one(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()
    return tree_map(one, tree)


def ep_slice(moe_params, rank: int, ep: int) -> Dict[str, Any]:
    """Rank ``rank``'s share of full MoE params for ``moe_block_ep`` over
    ``ep`` shards: expert rows ``rank*E_loc:(rank+1)*E_loc`` of
    ``wi_gate``, ``wi_up`` and ``wo`` (``shard_map``'s ``P("model", None,
    None)``), the router whole."""
    E = moe_params["wi_gate"].shape[0]
    if E % ep or not 0 <= rank < ep:
        raise ValueError(f"ep_slice: rank {rank} of {ep} shards over {E} "
                         f"experts")
    lo, hi = rank * (E // ep), (rank + 1) * (E // ep)
    return {"router": moe_params["router"],
            **{name: moe_params[name][lo:hi]
               for name in ("wi_gate", "wi_up", "wo")}}
