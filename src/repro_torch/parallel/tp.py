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
  split over ``model``).  A tensor used whole by every rank (``ln1``, the
  router's load-balance term) never goes through it: its gradient is
  whole on every rank already.
- :meth:`ModelAxis.exit` (``from_model``): the sum over ``model`` forward,
  identity backward: the region's partial output.

The vocab-parallel loss takes :meth:`ModelAxis.logsumexp` and
:meth:`ModelAxis.pick` over vocab-local logits, and :func:`greedy_tokens`
the greedy token.  Sums run in the tensor's dtype, the activation dtype
for a region's output.  Every collective counts in the mesh's
``collectives`` and ``axis_collectives``; a group of one copies, so at
``model = 1`` the arithmetic is the unsharded step's.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

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
    collectives of a tensor-parallel region over it."""

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
