"""Tensor- and expert-parallel compute on a mesh's ``model`` axis: the
port's counterpart of what GSPMD does where the reference's rules shard a
sublayer's heads, MLP columns, experts or vocab over ``model``.

A sublayer that computes tensor-parallel (``parallel.fsdp.Sharded.tp``
says which) holds the ``model``-local part of its weights and ends in one
sum over ``model``, as Megatron-LM's column- then row-parallel layers do.
Its :class:`ModelAxis` carries the two collectives:

- :meth:`ModelAxis.enter` (``to_model``): identity forward, the gradients
  summed over ``model`` backward.  It goes on each replicated tensor that a
  rank uses for its own part only, whose gradient on a rank is partial: the
  activation entering the region, the MoE combine weights, and the
  replicated leaves read for the local heads alone (``q_norm``,
  ``k_norm``; ``wk``, ``wv``, ``bk`` and ``bv`` where the kv heads do not
  split over ``model``; an SSM mixer's ``b_proj``, ``c_proj``,
  ``dt_proj``, B and C convs, ``dt_bias``, ``A_log`` and ``D``).  A tensor
  used whole by every rank (``ln1``, the router's load-balance term) never
  goes through it: its gradient is whole on every rank already.
- :meth:`ModelAxis.exit` (``from_model``): the sum over ``model`` forward,
  identity backward: the region's partial output.

An SSM mixer on its ``ssm_inner`` shard (``models.ssd``) normalises its
gated output over the whole ``d_inner`` with :meth:`ModelAxis.rmsnorm`:
each row's sum of squares over the local columns, summed over ``model``,
then the scale; backward the rows' sums of squares and of ``w dy x``,
summed, then dx and the local ``dw``.  On the card each half is an
rmsnorm kernel launch (``kernels.ops.rmsnorm_part`` and the rest), in the
one-pass kernel's order, so at ``model = 1`` they give its bits; on the
CPU the same formulas run as plain torch that autograd follows, whose
bits at ``model = 1`` are ``ops.rmsnorm``'s plain version's.

The vocab-parallel loss takes :meth:`ModelAxis.logsumexp` and
:meth:`ModelAxis.pick` over vocab-local logits, and :func:`greedy_tokens`
the greedy token.  Sums run in the tensor's dtype, the activation dtype
for a region's output.  Every collective counts in the mesh's
``collectives`` and ``axis_collectives``; a group of one copies, so at
``model = 1`` the arithmetic is the unsharded step's.

An attention whose fitted specs put ``model`` on the K/V head_dim (the
decode rules; prefill's where ``n_kv_heads`` does not split over
``model``) gets a :class:`HeadDimAxis` (``on_head_dim``): in decode it
computes on its head_dim shard of the weights and the KV cache
(``models.layers.attention_decode``), in prefill on its local q heads
with the K/V weights gathered whole.  A KV cache whose sequence is cut
over the batch axes (long decode) merges its softmax over them through a
:class:`SeqShard`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..kernels import ops, ref
from ..launch import roofline
from .fsdp import _all_gather, _all_reduce, _all_reduce_many, _count
from .sharding import axes_of

AXIS = "model"


class _ToModel(torch.autograd.Function):
    """Identity forward; backward, one all-reduce over ``model`` of all
    the gradients (a buffer a dtype)."""

    @staticmethod
    def forward(ctx, axis, *ts):
        ctx.axis = axis
        return ts

    @staticmethod
    def backward(ctx, *grads):
        items = list(enumerate(grads))
        summed = {}
        for dtype in dict.fromkeys(g.dtype for g in grads):
            summed.update(_all_reduce_many(
                [(i, g) for i, g in items if g.dtype == dtype],
                ctx.axis.mesh, AXIS))
        return (None, *(summed[i] for i in range(len(grads))))


class _FromModel(torch.autograd.Function):
    """The sum over ``model`` forward; identity backward."""

    @staticmethod
    def forward(ctx, axis, t):
        return _all_reduce(t, axis.mesh, AXIS)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _SumBoth(torch.autograd.Function):
    """The sum over ``model`` forward and backward: a split row's partial
    sums, which every rank's part of the row reads."""

    @staticmethod
    def forward(ctx, axis, t):
        ctx.axis = axis
        return _all_reduce(t, axis.mesh, AXIS)

    @staticmethod
    def backward(ctx, g):
        return None, _all_reduce(g, ctx.axis.mesh, AXIS)


class _SplitRmsNorm(torch.autograd.Function):
    """The norm of rows whose ``n`` columns are split over ``model``,
    through the kernels: the rows' partial sums, one all-reduce, the scale;
    backward the same shape of work, ending in the local ``dw``."""

    @staticmethod
    def forward(ctx, axis, x, w, n, eps):
        ctx.save_for_backward(x, w)
        ctx.axis, ctx.n, ctx.eps = axis, n, eps
        ss = _all_reduce(ops.rmsnorm_part(x), axis.mesh, AXIS)
        return ops.rmsnorm_scale(x, w, ss, n, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        sums = _all_reduce(ops.rmsnorm_bwd_part(x, w, dy), ctx.axis.mesh,
                           AXIS)
        dx, dw = ops.rmsnorm_bwd_scale(x, w, dy, sums, ctx.n, ctx.eps)
        return None, dx, dw.to(w.dtype), None, None


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim of vocab-local logits, the
    whole vocab's: the row max, then the sum of exponentials, each
    all-reduced over ``model``.  The same operations as
    ``torch.logsumexp`` forward and backward, so at ``model = 1`` its
    bits."""

    @staticmethod
    def forward(ctx, axis, x):
        mx = axis.all_max(torch.amax(x, -1, keepdim=True))
        mx_rows = mx.squeeze(-1)
        mx_rows.masked_fill_(mx_rows.abs() == float("inf"), 0)
        s = axis.exit(torch.sum((x - mx).exp_(), -1))
        out = s.log_().add_(mx_rows)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return None, g.unsqueeze(-1) * (x - out.unsqueeze(-1)).exp()


class ModelAxis:
    """This rank's place on the ``model`` axis of ``mesh``, and the
    collectives of a tensor-parallel region over it.  In an attention,
    the local heads' K/V are this rank's kv heads (``on_head_dim`` False;
    :class:`HeadDimAxis` is the other kind)."""

    on_head_dim = False
    heads = True

    def __init__(self, mesh):
        self.mesh = mesh
        self.rank = mesh.coords[AXIS]
        self.size = mesh.shape[AXIS]

    def local_range(self, n: int) -> Tuple[int, int]:
        """This rank's block ``[lo, hi)`` of ``n`` rows cut over
        ``model``."""
        return self.rank * (n // self.size), (self.rank + 1) * (n // self.size)

    def enter(self, *ts: torch.Tensor):
        """``to_model`` of each tensor (one all-reduce backward for all);
        one tensor in, one out."""
        out = _ToModel.apply(self, *ts)
        return out[0] if len(ts) == 1 else out

    def exit(self, t: torch.Tensor) -> torch.Tensor:
        """``from_model``: the sum of the ranks' partial ``t``."""
        return _FromModel.apply(self, t)

    def gather(self, t: torch.Tensor, dim: int = -1,
               tag: Optional[str] = None) -> torch.Tensor:
        """``t``, this rank's block along ``dim``, whole along it: one
        all-gather over ``model`` (no gradient), counted under ``tag``."""
        return _all_gather([(0, t.contiguous(), dim % t.ndim)], self.mesh,
                           AXIS, tag)[0]

    def rmsnorm(self, x: torch.Tensor, w: torch.Tensor,
                eps: float) -> torch.Tensor:
        """The RMS norm of ``x`` [..., D / m] over whole rows of D columns
        cut over ``model`` (``w``: this rank's D / m scales): one
        all-reduce of a row's sums each way (module docstring)."""
        shape = x.shape
        x2 = x.reshape(-1, shape[-1]).contiguous()
        n = shape[-1] * self.size
        if not x2.is_cuda and roofline.ACTIVE is None:
            # one f32 copy of x, as ops.rmsnorm's plain version takes, so
            # its gradient is summed in f32 before the one cast back
            xf = x2.float()
            y = ref.rmsnorm_scale_ref(
                xf, w, _SumBoth.apply(self, ref.rmsnorm_part_ref(xf)), n,
                eps).to(x.dtype)
        else:
            y = _SplitRmsNorm.apply(self, x2, w, n, eps)
        return y.reshape(shape)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max over ``model``, into a copy (no
        gradient)."""
        t = t.detach().clone(memory_format=torch.contiguous_format)
        _count(self.mesh, "all_reduce", AXIS, t)
        dist.all_reduce(t, op=dist.ReduceOp.MAX,
                        group=self.mesh.group(AXIS))
        return t

    def logsumexp(self, x: torch.Tensor) -> torch.Tensor:
        """The logsumexp of each row of vocab-local ``x`` over the whole
        vocab, on every ``model`` rank."""
        return _LogSumExp.apply(self, x)

    def pick(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``x[..., idx]`` for global vocab ids ``idx`` of vocab-local
        ``x``: taken on the rank that holds each id, then summed over
        ``model``."""
        local = idx - self.rank * x.shape[-1]
        inside = (local >= 0) & (local < x.shape[-1])
        got = torch.gather(x, -1, torch.where(inside, local, 0)[..., None])
        return self.exit(torch.where(inside, got[..., 0], 0))

    def lookup(self, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``table[idx]`` for global ids ``idx`` of this rank's rows
        ``table`` (a vocab-local embedding): the local rows, zero where
        another rank holds the id, summed over ``model``."""
        local = idx - self.rank * table.shape[0]
        inside = (local >= 0) & (local < table.shape[0])
        rows = table[torch.where(inside, local, 0)]
        return self.exit(torch.where(inside[..., None], rows, 0))


class HeadDimAxis(ModelAxis):
    """The ``model`` axis of an attention whose K/V head_dim carries it:
    each rank holds slice ``rank`` of ``head_dim`` of every kv head of
    ``wk``, ``wv`` (``bk``, ``bv``) and the KV cache.  ``heads``: ``wq``,
    ``bq`` and ``wo`` hold the local heads (``n_heads`` splits over
    ``model``), so the sublayer ends in :meth:`exit`; otherwise they are
    whole and it ends in no sum.  ``kv_whole`` (prefill): the K/V weights
    are gathered whole, the attention runs on the local q heads and the kv
    heads they read, and the layer cuts its cache to this rank's slice
    (:meth:`dh_slice`)."""

    on_head_dim = True

    def __init__(self, mesh, heads: bool, kv_whole: bool):
        super().__init__(mesh)
        self.heads = heads
        self.kv_whole = kv_whole

    def dh_slice(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the last dim (head_dim) of whole ``t``."""
        lo, hi = self.local_range(t.shape[-1])
        return t.narrow(-1, lo, hi - lo)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over ``model`` (no gradient): partial logits
        of the head_dim slices."""
        return _all_reduce(t, self.mesh, AXIS)


class SeqShard:
    """A KV cache's sequence cut over ``axes`` (long decode's
    ``cache_seq``, the batch axes, outer first): this rank's block
    ``index`` of ``count``, and the sums of a softmax merged over them."""

    def __init__(self, mesh, axes):
        self.mesh, self.axes = mesh, tuple(axes)
        self.index, self.count = 0, 1
        for a in self.axes:
            self.index = self.index * mesh.shape[a] + mesh.coords[a]
            self.count *= mesh.shape[a]

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the axes, into a copy."""
        t = t.clone(memory_format=torch.contiguous_format)
        for a in self.axes:
            _count(self.mesh, "all_reduce", a, t)
            dist.all_reduce(t, op=dist.ReduceOp.MAX,
                            group=self.mesh.group(a))
        return t

    def sum(self, *ts: torch.Tensor):
        """Each ``t`` summed over the axes, in one all-reduce an axis."""
        items = list(enumerate(ts))
        for a in self.axes:
            got = _all_reduce_many(items, self.mesh, a)
            items = [(i, got[i]) for i, _ in items]
        return tuple(t for _, t in items)


def greedy_tokens(logits: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The greedy token ``argmax(logits, -1)`` of logits under ``spec``
    (a serving step's logits spec): where ``spec`` shards the vocab over
    ``model``, each rank's max and its global index, all-gathered as
    ``[B, 2]`` f64 pairs (exact for bf16 and f32 values and for ids), and
    the first rank holding the largest max wins, as ``torch.argmax`` takes
    the first maximal index.  Every ``model`` rank gets the same tokens."""
    if AXIS not in axes_of(spec[-1]):
        return torch.argmax(logits, dim=-1)
    idx = torch.argmax(logits, dim=-1)
    val = torch.gather(logits, -1, idx[..., None])[..., 0]
    base = mesh.coords[AXIS] * logits.shape[-1]
    pairs = torch.stack([val.double(), (idx + base).double()], dim=-1)
    every = _all_gather([(0, pairs, 0)], mesh, AXIS)[0]
    every = every.view(mesh.shape[AXIS], *pairs.shape)
    best = torch.argmax(every[..., 0], dim=0)
    return torch.gather(every[..., 1], 0, best[None])[0].long()
