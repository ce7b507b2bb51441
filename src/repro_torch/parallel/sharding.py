"""Logical -> mesh sharding rules per workload (counterpart of
``repro.parallel.sharding``).

Mesh axes: ``("pod", "data", "model")`` multi-pod or ``("data", "model")``
single-pod.  ``pod`` and ``data`` split the global batch and, as FSDP,
shard the weights' rows (``embed``) too, so params and optimizer state are
sharded over both axes.  ``model`` shards attention heads, MLP columns,
vocab and the experts, for tensor- and expert-parallel compute: in the
port each such sublayer keeps its ``model``-local weights and ends in one
sum over ``model`` (``parallel.fsdp.Sharded.tp``, ``parallel.tp``), and a
weight whose fit drops ``model`` is gathered before use
(``parallel.fsdp``).  Decode moves the KV cache's shard onto ``head_dim``
(kv_heads may not divide ``model``), and its attention computes on that
shard (``parallel.tp.HeadDimAxis``); long decode (one sequence) shards
the cache's sequence over ``data`` too.

A spec is a :class:`~repro_torch.models.spec.PartitionSpec`; trees of specs
follow the params' dicts and the caches' NamedTuples.  ``fit_*`` take a
mesh or anything with a ``shape`` mapping axis name to size, or that
mapping itself (``launch.mesh.PRODUCTION_SHAPES``), so a 256-chip layout is
computed without 256 ranks.
"""
from __future__ import annotations

import enum
from typing import Any, Dict, Mapping, Optional, Tuple

from ..models.layers import KVCache
from ..models.spec import PartitionSpec, logical_to_pspec
from ..models.ssd import SSMCache


class WorkloadKind(str, enum.Enum):
    TRAIN = "train"
    PREFILL = "prefill"
    DECODE = "decode"
    LONG_DECODE = "long_decode"


def rules_for(kind: WorkloadKind, multi_pod: bool = False,
              fsdp: bool = True, seq_shard: bool = False) -> Dict[str, Any]:
    """The logical -> mesh axis rules of one workload.  ``seq`` names
    activations only, which the port does not pin, so ``seq_shard`` changes
    no spec that the port uses."""
    data = ("pod", "data") if multi_pod else ("data",)
    rules: Dict[str, Any] = {
        "batch": data,
        "embed": (data if fsdp else None),   # FSDP row-shard of weights
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",                  # expert parallelism
        "expert_embed": data,                # FSDP rows of expert weights
        "expert_mlp": None,
        "ssm_inner": "model",
        "cache_seq": None,
        # flattened [batch*seq, d] token tensors (the MoE dispatch)
        "tokens": data + ("model",),
        "seq": ("model" if seq_shard else None),
        "layers": None,
    }
    if kind in (WorkloadKind.DECODE, WorkloadKind.LONG_DECODE):
        rules["tokens"] = data
        rules["kv_heads"] = None
        rules["head_dim"] = "model"          # shards any GQA cache
    if kind == WorkloadKind.LONG_DECODE:
        rules["batch"] = None                # global_batch = 1
        rules["cache_seq"] = data            # sequence-sharded cache
    return rules


# ------------------------------------------------------------ spec trees
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of trees of dicts and NamedTuples (caches) of
    one structure; a plain tuple (logical axes, a spec) is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    return fn(tree, *rest)


def param_pspecs(specs, rules) -> Any:
    """A logical-axes tree (``api.param_specs``) -> a spec tree."""
    return tree_map(lambda ax: logical_to_pspec(ax, rules), specs)


def mesh_shape(mesh) -> Mapping[str, int]:
    """Axis name -> size of a mesh, of anything with such a ``shape``, or
    of that mapping itself."""
    return mesh if isinstance(mesh, Mapping) else mesh.shape


def axes_of(part) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, outer first."""
    if part is None:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


def _axis_size(sizes: Mapping[str, int], part) -> int:
    n = 1
    for a in axes_of(part):
        n *= sizes[a]
    return n


def fit_pspec(spec, shape, mesh) -> PartitionSpec:
    """Drop the partitions whose axes' size does not divide the dim (e.g.
    kv_heads 2 cannot shard over model 16: that dim is replicated).  The
    result has one entry a dim of ``shape``."""
    sizes = mesh_shape(mesh)
    shape = tuple(shape)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    return PartitionSpec(*(
        part if part is None or dim % _axis_size(sizes, part) == 0 else None
        for dim, part in zip(shape, parts[:len(shape)])))


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else ()


def fit_tree(spec_tree, shape_tree, mesh):
    """:func:`fit_pspec` over parallel trees of specs and of tensors (or
    anything with a ``shape``; a Python number has shape ``()``)."""
    return tree_map(lambda s, x: fit_pspec(s, _shape(x), mesh), spec_tree,
                    shape_tree)


def batch_pspec(rules, ndim: int = 2) -> PartitionSpec:
    """[B, S, ...] batches: the batch dim sharded, the rest replicated."""
    return PartitionSpec(rules.get("batch"), *([None] * (ndim - 1)))


def placements(mesh, spec) -> Dict[str, Optional[int]]:
    """For each mesh axis, the tensor dim that ``spec`` shards over it, or
    None.  A tuple entry such as ``("pod", "data")`` shards one dim over
    both axes, the first outermost."""
    out: Dict[str, Optional[int]] = {a: None for a in mesh_shape(mesh)}
    for dim, part in enumerate(spec):
        for a in axes_of(part):
            out[a] = dim
    return out


# -------------------------------------------------------------- cache specs
def cache_pspecs(cfg, cache_shapes, rules) -> Any:
    """Specs of a decode-cache tree, by each leaf's rank, as the reference
    maps them: KV [L, B, S, KV, Dh] (batch, ``cache_seq``, ``kv_heads``,
    ``head_dim``), the SSM conv tail [L, B, K-1, C] and state [L, B, H, P,
    N] (batch only), the encoder-decoder's cross K/V as KV.  A KV cache's
    ``length`` is a Python int in the port (its decode writes the cache in
    place), replicated.  ``cache_shapes``: ``launch.specs
    .cache_specs_shapes``."""
    from ..models.layers import KVCache
    from ..models.ssd import SSMCache

    data = rules.get("batch")
    cseq = rules.get("cache_seq")
    hd = rules.get("head_dim")
    kv = rules.get("kv_heads")

    def spec_for(leaf):
        nd = len(_shape(leaf))
        if nd == 5:                      # [L, B, S, KV, Dh]
            return PartitionSpec(None, data, cseq, kv, hd)
        if nd == 4:                      # [L, B, K-1, x|B|C] conv tail:
            # its channels join a sharded and two replicated streams
            return PartitionSpec(None, data, None, None)
        if nd == 3:
            return PartitionSpec(None, data, None)
        if nd == 2:
            return PartitionSpec(None, data)
        return PartitionSpec(*([None] * nd))

    def one(c):
        if isinstance(c, KVCache):
            return KVCache(k=spec_for(c.k), v=spec_for(c.v),
                           length=PartitionSpec())
        if isinstance(c, SSMCache):
            return SSMCache(conv=spec_for(c.conv), state=PartitionSpec(
                None, data, None, None, None))
        return spec_for(c)

    if isinstance(cache_shapes, dict):
        return {k: one(c) for k, c in cache_shapes.items()}
    return type(cache_shapes)(*(one(c) for c in cache_shapes))
