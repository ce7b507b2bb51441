"""Latency-hiding all-to-alls on ``torch.distributed`` (counterpart of
``repro.core.overlap``).

Every function takes a send buffer ``x [ep, C, ...]``: row ``p`` of the
peer axis goes to peer ``p``, and row ``p`` of the result is what peer
``p`` sent (``lax.all_to_all(..., split_axis=0, concat_axis=0,
tiled=True)``).  Transfers are ``all_to_all_single`` calls with async work
handles:

* :func:`warmup_all_to_all` issues a head of the transfer before the
  compute it is meant to hide behind, so that the collective's cold start
  runs beside that compute;
* :func:`pipelined_all_to_all` cuts the transfer into chunks that are all
  in flight at once.

Three choices differ from the reference, on purpose (ROADMAP §3):

* Chunks cut the slot axis ``C`` (dim 1), never the peer axis, at
  ``tensor_split`` boundaries, so every route returns exactly what one
  all-to-all returns, at any ``ep`` and any chunk count up to ``C``.  The
  reference chunks the peer axis, which at ``ep > 1`` reorders rows or
  fails to trace.
* The warm-up head is counted in slots per peer: ``h = clamp(
  warmup_chunk_bytes // (ep * slot_bytes), 1, C)``, so it carries about
  ``warmup_chunk_bytes`` in all.  The reference counts rows of the peer
  axis, so on ``[ep, C, D]`` its head is always the whole buffer.
* Under a plan with both a warm-up and ``n_chunks > 1``, the tail after
  the head is pipelined in ``n_chunks`` (what the reference's docstring
  says; its code sends the tail whole).

Contiguity: ``all_to_all_single`` wants contiguous buffers and
``x[:, c0:c1]`` is contiguous only at ``ep == 1``.  At ``ep > 1`` each
chunk is copied into a send buffer of its own and received into another,
which is copied into place after its wait: one more read and write of the
whole buffer each way.  At ``ep == 1`` (one card) a chunk is sent from
and received into the slices themselves, with no copy.

Async semantics: ``Work.wait()`` makes the current stream wait for the
collective (NCCL) or blocks until it is done (gloo); it does not block
the host on the card.  Each chunk's buffers are held until its wait, and
everything after a wait is ordered after the transfer on the current
stream, so the caching allocator never hands a buffer in flight to
another op.  CUDA events recorded on the current stream before the first
issue and after the last wait bracket the whole route.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..launch import roofline
from .scheduler import CollectivePlan

# the axis name a counter files these all-to-alls under: the group is an
# expert-parallel group (``launch.mesh.EPGroup``), whatever mesh axis it is
AXIS = "ep"


def _check(x: torch.Tensor, group) -> None:
    ep = dist.get_world_size(group)
    if x.ndim < 2 or x.shape[0] != ep:
        raise ValueError(f"all-to-all: send buffer [ep={ep}, C, ...] "
                         f"expected, got {tuple(x.shape)}")


def _count(out: torch.Tensor) -> None:
    """Under a counter, one all-to-all whose output is ``out``."""
    if roofline.ACTIVE is not None:
        roofline.ACTIVE.collective("all_to_all", AXIS,
                                   out.numel() * out.element_size())


def _a2a(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-to-all along the leading (peer) dimension of ``x``."""
    x = x.contiguous()
    out = torch.empty_like(x)
    _count(out)
    dist.all_to_all_single(out, x, group=group)
    return out


def _bounds(c0: int, c1: int, n_chunks: int) -> List[Tuple[int, int]]:
    """``[c0, c1)`` cut as ``torch.tensor_split`` cuts it into
    ``min(n_chunks, c1 - c0)`` pieces (at least one)."""
    n = max(1, min(n_chunks, c1 - c0))
    q, r = divmod(c1 - c0, n)
    out, lo = [], c0
    for i in range(n):
        hi = lo + q + (i < r)
        out.append((lo, hi))
        lo = hi
    return out


def _start(x: torch.Tensor, out: torch.Tensor, c0: int, c1: int, group):
    """Issue the all-to-all of slots ``[c0, c1)`` into ``out[:, c0:c1]``."""
    src = x[:, c0:c1].contiguous()
    dst = out[:, c0:c1]
    buf = dst if dst.is_contiguous() else torch.empty_like(src)
    _count(buf)
    work = dist.all_to_all_single(buf, src, group=group, async_op=True)
    return work, src, buf, dst


def _finish(pending) -> None:
    work, _src, buf, dst = pending
    work.wait()
    if buf is not dst:
        dst.copy_(buf)


def warmup_all_to_all(x: torch.Tensor, group=None, *, warmup_slots: int,
                      compute_fn: Callable[[torch.Tensor], torch.Tensor],
                      compute_arg, tail_chunks: int = 1):
    """All-to-all of ``x`` with a head of ``warmup_slots`` slots per peer
    (clamped to ``[1, C]``) issued before ``compute_fn(compute_arg)``; the
    rest follows the compute in ``tail_chunks`` chunks.

    Returns ``(a2a(x), compute_fn(compute_arg))``."""
    _check(x, group)
    C = x.shape[1]
    h = min(max(warmup_slots, 1), C)
    out = torch.empty_like(x)
    pending = [_start(x, out, 0, h, group)]        # no dep on compute_fn
    y = compute_fn(compute_arg)                    # runs beside the head
    if h < C:
        pending += [_start(x, out, c0, c1, group)
                    for c0, c1 in _bounds(h, C, tail_chunks)]
    for p in pending:
        _finish(p)
    return out, y


def pipelined_all_to_all(x: torch.Tensor, group=None, *, n_chunks: int):
    """All-to-all of ``x`` in ``n_chunks`` chunks of the slot axis (at most
    ``C``), all issued before the first wait."""
    _check(x, group)
    out = torch.empty_like(x)
    pending = [_start(x, out, c0, c1, group)
               for c0, c1 in _bounds(0, x.shape[1], n_chunks)]
    for p in pending:
        _finish(p)
    return out


def scheduled_all_to_all(x: torch.Tensor, group, plan: CollectivePlan, *,
                         compute_fn: Optional[Callable] = None,
                         compute_arg=None):
    """An all-to-all of ``x`` under ``plan``; returns ``(a2a(x), y)``.

    The warm-up route applies when the plan has warm-up bytes and there is
    a compute to hide them in; otherwise the transfer is pipelined in
    ``plan.n_chunks`` and ``y = compute_fn(compute_arg)`` (or ``None``)
    follows it."""
    if plan.warmup_chunk_bytes and compute_fn is not None:
        slot_bytes = max(1, x[:, :1].numel() * x.element_size())
        return warmup_all_to_all(
            x, group, warmup_slots=plan.warmup_chunk_bytes // slot_bytes,
            compute_fn=compute_fn, compute_arg=compute_arg,
            tail_chunks=plan.n_chunks)
    out = pipelined_all_to_all(x, group, n_chunks=plan.n_chunks)
    y = compute_fn(compute_arg) if compute_fn is not None else None
    return out, y
