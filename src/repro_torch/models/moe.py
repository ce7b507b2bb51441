"""Mixture-of-Experts FFN in PyTorch (counterpart of ``repro.models.moe``).

Both paths keep the JAX routing and drop rule exactly (:func:`route`: f32
router, top-k renormalised over the chosen experts, the Switch-style aux
loss), and run the expert FFN as three grouped-matmul kernel calls (gate,
up, down) over the kept assignments stably sorted by expert.  Rows past
the last group are zero-filled by the kernel and add nothing.

:func:`moe_gather` dispatches within each batch row: a capacity of
``max(8, int(S*k*cf/E))`` per row, assignments kept in the order of a
cumsum over the row's flattened ``[S*k]`` assignments.  The reference
fills a ``[B, E, C, D]`` buffer instead of sorting.  Under a sharded step
that puts the experts on ``model`` it is expert-parallel in place: each
``model`` rank holds every token of its batch rows, keeps the reference's
per-row set, runs its own experts' kept rows and sums the partial outputs
over ``model`` (``tp``).

:func:`moe_block_ep` is explicit expert parallelism over a
``torch.distributed`` group (``launch.mesh``): tokens go to the shard that
holds their expert and come back through ``all_to_all_single``, the
collective the paper studies; the dispatch can run under a
:class:`~repro_torch.core.CollectivePlan` (``core.overlap``).  Its pieces
(:func:`ep_dispatch`, :func:`ep_expert_ffn`, :func:`ep_combine`) are
public so that each window can be timed alone.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.overlap import _a2a, scheduled_all_to_all
from ..device import resolve_device
from ..kernels import ops
from .spec import ModelConfig, torch_dtype


def init_moe(cfg: ModelConfig, generator: torch.Generator, device=None,
             lead: tuple = ()):
    """Random MoE params in ``cfg.param_dtype`` (``repro.models.moe.init_moe``'s
    shapes and scales: normal with std ``1/sqrt(fan_in)``), each with the
    leading dims ``lead`` (``api.init`` stacks them over the blocks)."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.param_dtype)

    def normal(shape, fan_in):
        t = torch.randn((*lead, *shape), generator=generator, device=dev,
                        dtype=dt)
        return t.mul_(1.0 / math.sqrt(fan_in))

    return {k: normal(shape, fan_in)
            for k, (shape, fan_in) in moe_shapes(cfg).items()}


def moe_shapes(cfg: ModelConfig):
    """Each MoE leaf's (shape, fan_in), in the order they are drawn."""
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    return {"router": ((D, E), D), "wi_gate": ((E, D, Fe), D),
            "wi_up": ((E, D, Fe), D), "wo": ((E, Fe, D), Fe)}


def route(p, cfg: ModelConfig, x_flat: torch.Tensor, data_mean=None):
    """Top-k routing in f32.  Returns ``(idx [T,k], weights [T,k], aux)``.

    ``data_mean`` (a sharded step's) takes the aux loss's two means over
    every rank's tokens, as the reference's are over the global batch."""
    logits = x_flat.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    w = w / w.sum(dim=-1, keepdim=True)                 # renormalise
    E = logits.shape[-1]
    me = probs.mean(dim=0)
    ce = F.one_hot(idx, E).float().sum(dim=1).mean(dim=0)
    if data_mean is not None:
        me, ce = data_mean(torch.stack([me, ce])).unbind(0)
    aux = E * (me * ce).sum() / cfg.top_k
    return idx, w.to(x_flat.dtype), aux


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, c)


def _grouped_ffn(p, xs: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """SwiGLU of rows sorted by expert: three grouped_matmul launches."""
    g = ops.grouped_matmul(xs, p["wi_gate"].to(xs.dtype), offsets)
    u = ops.grouped_matmul(xs, p["wi_up"].to(xs.dtype), offsets)
    return ops.grouped_matmul(F.silu(g) * u, p["wo"].to(xs.dtype), offsets)


def moe_gather(p, cfg: ModelConfig, x: torch.Tensor, data_mean=None,
               tp=None):
    """MoE FFN for ``[B, S, D]`` input.  Returns ``(y [B,S,D], aux)``;
    ``data_mean`` goes to :func:`route`.

    With ``tp`` (a ``parallel.tp.ModelAxis``) ``p`` holds this rank's
    ``E / model`` experts, ``[r E/m, (r+1) E/m)``: routing, the load-balance
    loss and the keep rule run whole, as without it, and the grouped
    matmuls run on the local experts' kept rows alone; the combine ends in
    one sum over ``model``."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(cfg, S)

    idx, w, aux = route(p, cfg, x.reshape(B * S, D), data_mean)
    idx, w = idx.reshape(B, S, k), w.reshape(B, S, k)

    # keep rule: position of each assignment among its row's earlier
    # assignments to the same expert, in flattened (s, k) order
    a = idx.reshape(B, S * k)
    onehot = F.one_hot(a, E)                              # [B, S*k, E]
    pos = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(pos, 2, a[..., None])[..., 0]
    keep = pos < C

    # the kept assignments of this rank's experts ``[lo, lo + E_loc)`` (all
    # of them without ``tp``) sorted stably by expert; reading their count
    # is the layer's one host read (``index_add_`` counts without one)
    E_loc = p["wi_gate"].shape[0]
    lo = 0 if tp is None else tp.rank * E_loc
    mine = keep if tp is None else keep & (a >= lo) & (a < lo + E_loc)
    key = torch.where(mine, a - lo, E_loc).reshape(-1)    # [B*S*k]
    order = torch.sort(key, stable=True).indices
    counts = torch.zeros(E_loc + 1, dtype=torch.long,
                         device=x.device).index_add_(
        0, key, torch.ones_like(key))[:E_loc]
    offsets = F.pad(torch.cumsum(counts, 0), (1, 0)).to(torch.int32)
    order = order[:int(offsets[-1])]
    if tp is not None:
        # x and w are replicated and each rank uses its own rows of them
        x, w = tp.enter(x, w)

    ys = _grouped_ffn(p, x.reshape(B * S, D)[order // k], offsets)
    gathered = ys.new_zeros((B * S * k, D))
    gathered[order] = ys
    y = (gathered.reshape(B, S, k, D) * w[..., None]).sum(dim=2)
    return (y if tp is None else tp.exit(y)), aux


# ------------------------------------------------------ expert parallelism
@dataclass
class EPDispatch:
    """What routing and packing hand to the collectives and the combine.

    ``send`` [ep, C, D]: row ``s`` holds the tokens for shard ``s``'s
    experts, zero in empty slots; ``meta`` [ep, C] int32: the local expert
    id + 1 of each slot, 0 when empty; ``slot`` [T*k]: ``shard * C + pos``
    of each assignment in flat ``(t, k)`` order, ``ep * C`` when dropped;
    ``keep`` [T*k]; ``w`` [T, k] the combine weights; ``aux`` the loss."""
    send: torch.Tensor
    meta: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    w: torch.Tensor
    aux: torch.Tensor


def ep_dispatch(p, cfg: ModelConfig, x: torch.Tensor, ep: int) -> EPDispatch:
    """Routing and packing of local tokens ``x [T, D]`` for ``ep`` shards.

    The reference's capacity and keep rule: ``C = _capacity(T) * E_loc``
    slots per destination shard, positions from the cumsum of the one-hot
    of the destination shard in flat ``(t, k)`` order.  Only the kept
    assignments are written: the reference adds dropped ones as zeros at
    slot ``(0, C-1)``, which a plain write would let overwrite a kept
    row there.  Here a dropped assignment points past the buffer, at a
    slot that is cut off before anything reads it."""
    T, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    if E % ep:
        raise ValueError(f"moe_block_ep: {E} experts do not split over "
                         f"{ep} shards")
    E_loc = E // ep
    C = _capacity(cfg, T) * E_loc
    idx, w, aux = route(p, cfg, x)
    a = idx.reshape(-1)                                   # global expert id
    shard = a // E_loc                                    # destination
    onehot = F.one_hot(shard, ep)
    pos = torch.cumsum(onehot, dim=0) - onehot
    pos = torch.gather(pos, 1, shard[:, None])[:, 0]
    keep = pos < C
    n = ep * C
    slot = torch.where(keep, shard * C + pos, n)
    # the assignment each slot holds (T*k: none); dropped ones all land on
    # slot n, which is cut off
    asg = torch.full((n + 1,), T * k, dtype=torch.long, device=x.device)
    asg[slot] = torch.arange(T * k, device=x.device)
    asg = asg[:n]
    x_pad = torch.cat([x, x.new_zeros(1, D)])             # row T: zeros
    send = x_pad[asg // k].view(ep, C, D)
    eid = F.pad((a % E_loc + 1).to(torch.int32), (0, 1))  # T*k -> 0
    return EPDispatch(send=send, meta=eid[asg].view(ep, C), slot=slot,
                      keep=keep, w=w, aux=aux)


def _expert_order(recv_meta: torch.Tensor, E_loc: int):
    """The received slots' order, stably sorted by local expert with the
    empty slots past the last group, and the ``[E_loc + 1]`` int32 group
    offsets into it."""
    key = recv_meta.reshape(-1).long() - 1
    key = torch.where(key < 0, E_loc, key)
    sorted_key, order = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        sorted_key, torch.arange(E_loc + 1, device=key.device))
    return order, offsets.to(torch.int32)


def ep_expert_ffn(p, recv: torch.Tensor, recv_meta: torch.Tensor):
    """The local experts' SwiGLU on the received slots ``[ep, C, D]``.

    Rows are sorted stably by local expert, empty slots past the last
    group (the kernel zero-fills them), through three ``grouped_matmul``
    launches, and put back in slot order.  ``kernels.ref.expert_ffn_ref``
    is its plain version."""
    ep, C, D = recv.shape
    order, offsets = _expert_order(recv_meta, p["wi_gate"].shape[0])
    ys = _grouped_ffn(p, recv.reshape(ep * C, D)[order], offsets)
    out = torch.empty_like(ys)
    out[order] = ys
    return out.view(ep, C, D)


def ep_combine(d: EPDispatch, back: torch.Tensor) -> torch.Tensor:
    """Unpack the combine all-to-all's ``[ep, C, D]``: gather each
    assignment's row by ``(shard, pos)``, zero the dropped ones, weight and
    sum over ``k``.  Returns ``y [T, D]``."""
    T, k = d.w.shape
    ep, C, D = back.shape
    rows = back.reshape(ep * C, D)[d.slot.clamp(max=ep * C - 1)]
    rows = torch.where(d.keep[:, None], rows, 0)
    return (rows.view(T, k, D) * d.w[..., None]).sum(dim=1)


def moe_block_ep(p, cfg: ModelConfig, x: torch.Tensor, group=None,
                 plan=None, overlap_compute=None):
    """Expert-parallel MoE over the process group ``group`` (``None``: the
    default group).

    ``x`` [T_loc, D] are this rank's tokens; ``p`` holds the replicated
    router and this rank's ``E / ep`` experts (``weights.ep_slice``).  The
    dispatch all-to-all runs under ``plan`` when both ``plan`` and
    ``overlap_compute = (fn, arg)`` are given (``fn(arg)`` is computed
    beside it and, as in the reference, its result is not returned);
    otherwise it is one all-to-all.  The metadata and combine all-to-alls
    are plain.  Returns ``(y [T_loc, D], aux)``."""
    d = ep_dispatch(p, cfg, x, dist.get_world_size(group))
    if plan is not None and overlap_compute is not None:
        recv, _ = scheduled_all_to_all(d.send, group, plan,
                                       compute_fn=overlap_compute[0],
                                       compute_arg=overlap_compute[1])
    else:
        recv = _a2a(d.send, group)
    recv_meta = _a2a(d.meta, group)
    back = _a2a(ep_expert_ffn(p, recv, recv_meta), group)
    return ep_combine(d, back), d.aux
