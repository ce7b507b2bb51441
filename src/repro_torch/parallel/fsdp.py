"""FSDP over a ``launch.mesh.Mesh`` with explicit collectives: the port's
counterpart of the collectives GSPMD inserts for the reference's sharded
steps.

Each rank holds, per leaf, only its shard under the leaf's fitted spec
(``parallel.sharding``): :func:`shard_tree` cuts it.  A block's weights are
all-gathered just before the block runs (:func:`gather_leaves`) and
dropped after it; under remat the backward gathers them again.  The leaves
of a tensor-parallel sublayer (:meth:`Sharded.tp`: attention by heads or
by the K/V head_dim, the MLP by columns, the MoE by experts, the
embeddings by vocab rows, an SSM mixer by its whole heads of
``ssm_inner``, where the fit puts ``model`` there) are gathered over every
axis but ``model``: a rank computes on its ``model``-local part and the
sublayer ends in one sum over ``model`` (``parallel.tp``), or none for an
attention on its head_dim shard whose heads do not split.  Prefill
gathers the head_dim-sharded ``wk``, ``wv``, ``bk`` and ``bv`` over
``model`` too (the K/V of every kv head, for its local q heads); decode
computes on them as they are, and gathers an SSM mixer's ``conv_x`` and
``conv_x_b`` whole (each rank advances the whole replicated conv tail and
state).  A sublayer whose fit dropped ``model`` (an SSM mixer whose heads
do not split) gathers over ``model`` too and computes whole, the same
rows on each ``model`` rank of a batch slice.

A gathered leaf's gradient is summed over the batch axes, whose ranks saw
different rows, and averaged by their size, leaving each rank its shard
(:func:`reduce_grads`): a reduce-scatter where a batch axis shards the
leaf, an all-reduce where none does.  Over ``model`` nothing is summed
here: a tensor-parallel leaf's gradient is this rank's own already, and a
leaf gathered over ``model`` has the whole gradient on each rank, which
is only cut.  (A replicated leaf that a rank reads for its own heads only
is summed over ``model`` by the layer, ``parallel.tp.ModelAxis.enter``.)

Every collective runs on one mesh axis's group, for all of a block's
leaves of one dtype at once, back to back in one buffer: a dim sharded
over ``("pod", "data")`` is gathered over ``data``, then ``pod``, and
reduced in the opposite order.  Collectives run at every size, a group of
one included (where they copy), and each one counts in
``mesh.collectives`` (by kind) and ``mesh.axis_collectives`` (by axis),
and under a ``launch.roofline.Counter`` with its bytes too, under the tag
``"cache"`` where it gathers a cache (:func:`reshard`; no step does).

:class:`Sharded` is what a sharded step hands the model: the block loops of
``models.transformer`` and ``models.encdec`` call its ``gather`` on each
block's shards and its ``tp`` for each sublayer, MoE routing takes its
``data_mean`` for the load-balance loss's batch means, prefill its
``cache_cut`` (each block's new cache to this rank's shard before the next
block runs) and decode its ``cache_seq`` (a cache's sequence block, which
decode attention merges its softmax over); decode reads and writes the
cache shards in place.  The optimizer takes its ``mean`` and the clipping
its ``global_norm``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..launch import roofline
from ..models.spec import PartitionSpec
from ..weights import flatten, unflatten
from .sharding import axes_of, tree_map


def _count(mesh, kind: str, axis: Optional[str], out: torch.Tensor,
           tag: Optional[str] = None) -> None:
    """One collective of ``kind`` over ``axis`` (``None``: the world), by
    kind in ``mesh.collectives`` and by axis in ``mesh.axis_collectives``;
    under a counter, with the bytes of its output ``out`` on this rank
    (and under ``tag`` too)."""
    mesh.collectives[kind] = mesh.collectives.get(kind, 0) + 1
    by_axis = mesh.axis_collectives.setdefault(axis or "world", {})
    by_axis[kind] = by_axis.get(kind, 0) + 1
    if roofline.ACTIVE is not None:
        roofline.ACTIVE.collective(kind, axis,
                                   out.numel() * out.element_size(), tag)


def _block(dim: int, n: int, i: int):
    return slice(i * (dim // n), (i + 1) * (dim // n))


def shard_slices(spec, shape, mesh) -> Tuple[slice, ...]:
    """This rank's block of a leaf of ``shape`` under ``spec``: a dim over
    axes ``(a, b)`` is cut into ``size(a) * size(b)`` blocks, ``a``
    outermost."""
    out = []
    for dim, part in zip(shape, tuple(spec) + (None,) * len(shape)):
        idx, n = 0, 1
        for a in axes_of(part):
            idx, n = idx * mesh.shape[a] + mesh.coords[a], n * mesh.shape[a]
        if dim % n:
            raise ValueError(f"spec {spec} does not divide shape "
                             f"{tuple(shape)} over {mesh.shape}")
        out.append(_block(dim, n, idx))
    return tuple(out)


def shard_leaf(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's shard of a full leaf, as a tensor of its own."""
    return t[shard_slices(spec, t.shape, mesh)].clone()


def shard_tree(tree, pspecs, mesh):
    """:func:`shard_leaf` over a tree (dicts and cache NamedTuples); a
    leaf that is not a tensor (a cache length) stays as it is."""
    return tree_map(lambda t, s: shard_leaf(t, s, mesh)
                    if isinstance(t, torch.Tensor) else t, tree, pspecs)


def _by_dtype(items):
    """``(key, tensor, ...)`` items grouped by the tensor's dtype, in
    order: one collective a group."""
    groups = {}
    for item in items:
        groups.setdefault(item[1].dtype, []).append(item)
    return groups.values()


def _all_gather(jobs, mesh, axis: str, tag: Optional[str] = None):
    """One all-gather over ``axis`` of every ``(key, shard, dim)`` job,
    back to back in one buffer; returns ``{key: shard gathered along
    dim}``."""
    n = mesh.shape[axis]
    flat = torch.cat([t.reshape(-1) for _, t, _ in jobs])
    # the n buffers back to back, [n * numel], as gloo wants it
    out = flat.new_empty(n * flat.numel())
    _count(mesh, "all_gather", axis, out, tag)
    dist.all_gather_into_tensor(out, flat, group=mesh.group(axis))
    rows, off, res = out.view(n, flat.numel()), 0, {}
    for key, t, dim in jobs:
        piece = rows[:, off:off + t.numel()].view(n, *t.shape)
        res[key] = piece.movedim(0, dim).reshape(
            *t.shape[:dim], n * t.shape[dim], *t.shape[dim + 1:])
        off += t.numel()
    return res


def _reduce_scatter(jobs, mesh, axis: str):
    """One reduce-scatter over ``axis`` of every ``(key, grad, dim)``
    job: ``{key: the sum of this rank's block along dim}``."""
    n = mesh.shape[axis]
    blocks = [g.unflatten(dim, (n, g.shape[dim] // n)).movedim(dim, 0)
              for _, g, dim in jobs]
    send = torch.cat([b.reshape(n, -1) for b in blocks], dim=1)
    out = send.new_empty(send.shape[1])
    _count(mesh, "reduce_scatter", axis, out)
    dist.reduce_scatter_tensor(out, send.view(-1), group=mesh.group(axis))
    res, off = {}, 0
    for (key, _, _), b in zip(jobs, blocks):
        size = b[0].numel()
        res[key] = out[off:off + size].view(b.shape[1:])
        off += size
    return res


def _all_reduce(t: torch.Tensor, mesh, axis: Optional[str]) -> torch.Tensor:
    """Sum over ``axis``'s group (``None``: the world), into a copy."""
    t = t.clone(memory_format=torch.contiguous_format)
    _count(mesh, "all_reduce", axis, t)
    dist.all_reduce(t, group=None if axis is None else mesh.group(axis))
    return t


def _all_reduce_many(items, mesh, axis: str):
    """One all-reduce over ``axis`` of every ``(key, tensor)``."""
    flat = _all_reduce(torch.cat([t.reshape(-1) for _, t in items]), mesh,
                       axis)
    res, off = {}, 0
    for key, t in items:
        res[key] = flat[off:off + t.numel()].view(t.shape)
        off += t.numel()
    return res


def gather_leaves(shards, specs, mesh, tag: Optional[str] = None):
    """The whole leaves of ``shards`` (key -> this rank's shard, ``specs``
    key -> its spec), all-gathered: one collective a mesh axis (innermost
    first) and dtype, whatever dim each leaf has on it, counted under
    ``tag``.  No gradient (:class:`Sharded`'s ``gather`` is the
    differentiable one); a leaf no axis shards comes back as a copy."""
    out = {k: t.detach() for k, t in shards.items()}
    for a in reversed(tuple(mesh.shape)):
        jobs = [(k, out[k], dim) for k, spec in specs.items()
                for dim, part in enumerate(spec) if a in axes_of(part)]
        for group in _by_dtype(jobs):
            out.update(_all_gather(group, mesh, a, tag))
    return {k: t if _sharding_axes(specs[k]) else t.clone()
            for k, t in out.items()}


def gather_leaf(shard: torch.Tensor, spec, mesh,
                tag: Optional[str] = None) -> torch.Tensor:
    """One leaf whole (:func:`gather_leaves`)."""
    return gather_leaves({0: shard}, {0: spec}, mesh, tag)[0]


def reduce_grads(grads, pspecs, mesh, batch_axes: Sequence[str]):
    """Whole leaves' gradients (key -> tensor, ``pspecs`` key -> spec) ->
    this rank's shards of their mean over the ``batch_axes`` ranks: over
    each axis that shards a leaf, outermost first, reduce-scattered if it
    is a batch axis and cut if not; all-reduced over a batch axis that
    shards none of it.  One collective an axis and dtype."""
    out = dict(grads)
    for a in mesh.shape:
        jobs = [(k, out[k], dim) for k, spec in pspecs.items()
                for dim, part in enumerate(spec) if a in axes_of(part)]
        if a not in batch_axes:
            for k, g, dim in jobs:
                out[k] = g.narrow(dim, mesh.coords[a] * (
                    g.shape[dim] // mesh.shape[a]),
                    g.shape[dim] // mesh.shape[a])
            continue
        for group in _by_dtype(jobs):
            out.update(_reduce_scatter(group, mesh, a))
    for a in batch_axes:
        rest = [(k, out[k]) for k, spec in pspecs.items()
                if a not in _sharding_axes(spec)]
        for group in _by_dtype(rest):
            out.update(_all_reduce_many(group, mesh, a))
    n = math.prod(mesh.shape[a] for a in batch_axes)
    return {k: (g / n if n > 1 else g).contiguous() for k, g in out.items()}


def global_norm(tree, pspecs, mesh) -> torch.Tensor:
    """The f32 norm of a tree of shards, each element counted once: a
    leaf's sum of squares is divided by the number of ranks that hold the
    same shard before one sum over the world."""
    total = 0
    for path, x in flatten(tree).items():
        sq = torch.sum(torch.square(x.float()))
        held = math.prod(n for a, n in mesh.shape.items()
                         if a not in _sharding_axes(pspecs_at(pspecs, path)))
        total = total + (sq / held if held > 1 else sq)
    return torch.sqrt(_all_reduce(total, mesh, None))


def _sharding_axes(spec) -> set:
    return {a for part in spec for a in axes_of(part)}


def pspecs_at(pspecs, path: str):
    node = pspecs
    for key in path.split("/"):
        node = node[key]
    return node


def _drop_layers(spec, ndim: int) -> PartitionSpec:
    """A stacked leaf's spec for one block (the leading ``layers`` entry,
    never sharded, dropped) when the tensor is a block's."""
    return PartitionSpec(*spec[1:]) if len(spec) == ndim + 1 else spec


class _Gather(torch.autograd.Function):
    """Shards -> whole leaves (``specs``: path -> spec); the backward
    reduces the whole leaves' gradients to shards (:func:`reduce_grads`)."""

    @staticmethod
    def forward(ctx, hook, specs, *shards):
        ctx.hook, ctx.specs = hook, specs
        return tuple(gather_leaves(dict(zip(specs, shards)), specs,
                                   hook.mesh).values())

    @staticmethod
    def backward(ctx, *grads):
        h = ctx.hook
        reduced = reduce_grads(dict(zip(ctx.specs, grads)), ctx.specs,
                               h.mesh, h.batch_axes)
        return (None, None, *reduced.values())


class _DataMean(torch.autograd.Function):
    """The mean over the batch axes' ranks; its backward is the same mean
    of the gradients, so each rank's share of the loss counts once."""

    @staticmethod
    def forward(ctx, hook, t):
        ctx.hook = hook
        return hook.batch_mean(t)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.hook.batch_mean(g)


# The sublayers that can compute tensor-parallel, by the name of their
# subtree (of the leaf itself for the embeddings), and their kind
REGIONS = {"attn": "attn", "xattn": "attn", "mlp": "mlp", "moe": "moe",
           "ssm": "ssm", "tok_embed": "vocab", "unembed": "vocab"}
# an attention's K/V leaves: sharded on head_dim by the decode rules
_KV_LEAVES = ("wk", "wv", "bk", "bv")
# an SSM mixer's leaves that decode gathers whole over model: the x
# channels' conv, which advances the replicated conv tail and state
_SSM_DECODE_WHOLE = ("conv_x", "conv_x_b")
# A sublayer of each kind computes tensor-parallel when ``model`` shards the
# dim (from the end) of each of these weights, as True or False says it
# must: the heads of wq and wo, and not the head_dim of wk and wv; the MLP
# columns; the experts; the vocab; an SSM mixer's ssm_inner (its z, x and
# out projections, x conv and gated norm).  An attention whose wk head_dim
# carries model is the other kind (``parallel.tp.HeadDimAxis``)
_TP_DIMS = {
    "attn": {"wq": (-2, True), "wo": (-3, True), "wk": (-1, False),
             "wv": (-1, False)},
    "mlp": {"wi_gate": (-1, True), "wi_up": (-1, True), "wo": (-2, True)},
    "moe": {"wi_gate": (-3, True), "wi_up": (-3, True), "wo": (-3, True)},
    "vocab": {"tok_embed": (-2, True), "unembed": (-1, True)},
    "ssm": {"z_proj": (-1, True), "x_proj": (-1, True), "conv_x": (-1, True),
            "conv_x_b": (-1, True), "norm": (-1, True),
            "out_proj": (-2, True)},
}


def region_of(path: str) -> Optional[str]:
    """The path of the sublayer (``REGIONS``) that holds the leaf at
    ``path``, or None."""
    parts = path.split("/")
    for i, part in enumerate(parts):
        if part in REGIONS:
            return "/".join(parts[:i + 1])
    return None


def _without(spec, axis: str) -> PartitionSpec:
    """``spec`` with ``axis`` taken out of every entry."""
    return PartitionSpec(*(tuple(a for a in axes_of(p) if a != axis) or None
                           for p in spec))


class Sharded:
    """The collectives of one sharded step, over ``mesh``.

    ``pspecs``: the fitted specs of the params tree; ``batch_axes``: the
    mesh axes that split the batch (``rules["batch"]``; none in long
    decode); ``cache_pspecs``: the fitted specs of the caches, for
    serving; ``decode``: the step is a decode step, whose attention on
    the K/V head_dim computes on its shards; ``ssm_dims``: the SSM
    mixers' ``(d_inner, head_dim)``, without which they compute whole.
    ``on_gather(t)``, when given, sees every leaf a ``gather`` returns
    (the tests count the live ones).  Which sublayers compute
    tensor-parallel follows from ``pspecs`` (:meth:`tp`)."""

    def __init__(self, mesh, pspecs, batch_axes: Sequence[str] = (),
                 cache_pspecs=None, decode: bool = False,
                 on_gather: Optional[Callable[[torch.Tensor], None]] = None,
                 ssm_dims: Optional[Tuple[int, int]] = None):
        self.mesh = mesh
        self.pspecs = pspecs
        self.batch_axes = tuple(batch_axes)
        self.cache_pspecs = cache_pspecs
        self.decode = decode
        self.on_gather = on_gather
        self.ssm_dims = ssm_dims
        self._specs = {}      # (path, leaf paths) -> their specs, a block's
        self._regions = {}    # sublayer path -> its ModelAxis or None
        self._axis = None

    # ------------------------------------------------- tensor parallelism
    def tp(self, path: str):
        """The ``model`` axis (``parallel.tp.ModelAxis``) of the sublayer at
        ``path`` of the params (``blocks/l0/attn``, ``dec/xattn``,
        ``blocks/l1/moe``, ``blocks/l0/ssm``, ``unembed``) when it computes
        tensor-parallel: the fitted specs put ``model`` on its heads, MLP
        columns, experts, vocab or ``ssm_inner`` (an SSM mixer's only where
        each rank holds whole heads, ``ssm_dims``).  An attention whose K/V head_dim carries ``model`` (the
        decode rules; prefill's where the kv heads do not split) gets a
        ``parallel.tp.HeadDimAxis``: ``on_head_dim`` is the one question
        that tells the two kinds apart.  Otherwise None: the sublayer
        gathers its weights over ``model`` and computes whole."""
        if path not in self._regions:
            self._regions[path] = self._region(path)
        return self._regions[path]

    def _region(self, path: str):
        name = path.rsplit("/", 1)[-1]
        kind = REGIONS.get(name)
        if kind is None:
            return None
        try:
            node = pspecs_at(self.pspecs, path)
        except KeyError:          # no such sublayer (an SSM layer's cache)
            return None
        if kind == "vocab":
            node = {name: node}
        if kind == "ssm" and not self._ssm_heads_split():
            return None
        if kind == "attn" and "model" in axes_of(node["wk"][-1]):
            from .tp import HeadDimAxis
            return HeadDimAxis(self.mesh,
                               heads="model" in axes_of(node["wq"][-2]),
                               kv_whole=not self.decode)
        for leaf, (dim, sharded) in _TP_DIMS[kind].items():
            if leaf in node and ("model" in axes_of(node[leaf][dim])) != \
                    sharded:
                return None
        if self._axis is None:
            from .tp import ModelAxis
            self._axis = ModelAxis(self.mesh)
        return self._axis

    def _ssm_heads_split(self) -> bool:
        """Each ``model`` rank holds whole SSM heads: ``head_dim`` divides
        ``d_inner / model``."""
        if self.ssm_dims is None:
            return False
        d_inner, head_dim = self.ssm_dims
        m = self.mesh.shape["model"]
        return d_inner % m == 0 and (d_inner // m) % head_dim == 0

    def _gather_spec(self, path: str, ndim: int) -> PartitionSpec:
        """How the leaf at ``path`` is gathered: over every axis that its
        spec names, but over no ``model`` in a tensor-parallel sublayer,
        whose leaves stay ``model``-local; a prefill attention on the K/V
        head_dim takes ``wk``, ``wv``, ``bk`` and ``bv`` whole, and a
        decode SSM mixer ``conv_x`` and ``conv_x_b``."""
        spec = _drop_layers(pspecs_at(self.pspecs, path), ndim)
        region = region_of(path)
        tp = None if region is None else self.tp(region)
        leaf = path.rsplit("/", 1)[-1]
        if tp is None or (tp.on_head_dim and tp.kv_whole and
                          leaf in _KV_LEAVES) or (
                self.decode and REGIONS[region.rsplit("/", 1)[-1]] == "ssm"
                and leaf in _SSM_DECODE_WHOLE):
            return spec
        return _without(spec, "model")

    # ----------------------------------------------------------- weights
    def gather(self, tree, path: str):
        """The leaves of ``tree``, the shards found at ``path`` of the
        params (a block's slice of a stacked tree, or unstacked leaves),
        gathered whole, but ``model``-local in a tensor-parallel sublayer.
        With grad enabled the backward reduces their gradients (over the
        axes gathered)."""
        flat = flatten(tree)
        key = (path, tuple(flat), tuple(t.ndim for t in flat.values()))
        if key not in self._specs:
            self._specs[key] = {
                k: self._gather_spec(f"{path}/{k}" if path else k, t.ndim)
                for k, t in flat.items()}
        specs = self._specs[key]
        shards = tuple(flat.values())
        if torch.is_grad_enabled():
            full = _Gather.apply(self, specs, *shards)
        else:
            full = tuple(gather_leaves(flat, specs, self.mesh).values())
        if self.on_gather is not None:
            for t in full:
                self.on_gather(t)
        return unflatten(dict(zip(flat, full)))

    # -------------------------------------------------------------- batch
    def batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the batch axes' ranks (no gradient)."""
        for a in self.batch_axes:
            t = _all_reduce(t, self.mesh, a)
        n = math.prod(self.mesh.shape[a] for a in self.batch_axes)
        return t / n if n > 1 else t

    def data_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the batch axes' ranks (differentiable)."""
        return _DataMean.apply(self, t)

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the batch axes' ranks (no gradient)."""
        for a in self.batch_axes:
            t = _all_reduce(t, self.mesh, a)
        return t

    # ---------------------------------------------------------- optimizer
    def global_norm(self, tree) -> torch.Tensor:
        return global_norm(tree, self.pspecs, self.mesh)

    def mean(self, path: str, t: torch.Tensor, dims) -> torch.Tensor:
        """The mean over the param dims ``dims`` of the whole leaf at
        ``path``, of which ``t`` is this rank's shard (a leaf or a state
        of its shape with dims dropped after ``dims``)."""
        spec = pspecs_at(self.pspecs, path)
        axes = [a for d in dims for a in axes_of(spec[d])]
        if not axes:
            return t.mean(dims)
        s = t.sum(dims)
        for a in axes:
            s = _all_reduce(s, self.mesh, a)
        n = math.prod(t.shape[d] for d in dims) * math.prod(
            self.mesh.shape[a] for a in axes)
        return s / n

    # ------------------------------------------------------------- caches
    def _cache_node(self, name: str):
        """The specs of cache ``name``: a KVCache or SSMCache of specs, or
        one spec."""
        return (self.cache_pspecs[name] if isinstance(self.cache_pspecs, dict)
                else getattr(self.cache_pspecs, name))

    def _cache_spec(self, name: str, field: Optional[str], ndim: int):
        spec = self._cache_node(name)
        if field is not None:
            spec = getattr(spec, field)
        # a block's cache [B, ...]: its batch rows are this rank's already
        return PartitionSpec(None, *_drop_layers(spec, ndim)[1:])

    def cache_cut(self, cache, name: str, local: bool = False):
        """This rank's shard of one block's cache ``name`` (a KVCache, an
        SSMCache or a tensor) that prefill made whole but for the batch,
        and for ``model`` too when ``local`` (a tensor-parallel attention
        made its K/V heads, or its head_dim slice, already).  A field no
        axis shards is kept as it is."""

        def cut(field, t):
            if not isinstance(t, torch.Tensor):    # a KV cache's length
                return t
            spec = self._cache_spec(name, field, t.ndim)
            if local:
                spec = _without(spec, "model")
            return shard_leaf(t, spec, self.mesh) if _sharding_axes(
                spec) else t

        if isinstance(cache, torch.Tensor):
            return cut(None, cache)
        return type(cache)(*(cut(f, t) for f, t in zip(cache._fields,
                                                         cache)))

    def cache_seq(self, name: str):
        """The sequence block (``parallel.tp.SeqShard``) of a block's KV
        cache ``name`` (a KVCache or a tensor [B, S, KV, Dh]) where its
        fitted spec cuts the sequence (long decode), else None."""
        spec = self._cache_node(name)
        axes = axes_of(_drop_layers(getattr(spec, "k", spec), 4)[1])
        if not axes:
            return None
        from .tp import SeqShard
        return SeqShard(self.mesh, axes)


def reshard(tree, src, dst, mesh):
    """Shards under the specs ``src`` -> shards under ``dst`` (each leaf
    gathered whole, then cut), e.g. prefill's caches into the serve step's
    layout: its gathers count under the tag ``"cache"``."""
    return tree_map(lambda t, a, b: shard_leaf(
        gather_leaf(t, a, mesh, "cache"), b, mesh)
                    if isinstance(t, torch.Tensor) else t, tree, src, dst)
