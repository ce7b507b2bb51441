"""Mixture-of-Experts FFN in PyTorch (counterpart of ``repro.models.moe``).

:func:`moe_gather` keeps the JAX routing and drop rule exactly: f32 router,
top-k renormalised over the chosen experts, the Switch-style aux loss, and a
capacity of ``max(8, int(S*k*cf/E))`` per batch row, with the assignments
kept in the order of a cumsum over each row's flattened ``[S*k]``
assignments.  Only the expert compute differs in form: instead of a
``[B, E, C, D]`` capacity buffer, the kept assignments of all rows are
stably sorted by expert and run through three grouped-matmul kernel calls
(gate, up, down).  Dropped assignments are sorted past the last group, so
the kernel writes zeros for them and they add nothing to the combine.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .spec import ModelConfig


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, c)


def moe_gather(p, cfg: ModelConfig, x: torch.Tensor):
    """MoE FFN for ``[B, S, D]`` input.  Returns ``(y [B,S,D], aux)``."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(cfg, S)

    # routing (f32) on [B, S, E]
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)                 # [B, S, k]
    w = (w / w.sum(dim=-1, keepdim=True)).to(x.dtype)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(idx, E).float().sum(dim=2).mean(dim=(0, 1))
    aux = E * (me * ce).sum() / k

    # keep rule: position of each assignment among its row's earlier
    # assignments to the same expert, in flattened (s, k) order
    a = idx.reshape(B, S * k)
    onehot = F.one_hot(a, E)                              # [B, S*k, E]
    pos = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(pos, 2, a[..., None])[..., 0]
    keep = pos < C

    # kept assignments sorted (stably) by expert; dropped ones after all
    # groups, where the kernel zero-fills
    key = torch.where(keep, a, E).reshape(-1)             # [B*S*k]
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=E + 1)[:E]
    offsets = F.pad(torch.cumsum(counts, 0), (1, 0)).to(torch.int32)

    xs = x.reshape(B * S, D)[order // k]                  # [B*S*k, D]
    g = ops.grouped_matmul(xs, p["wi_gate"].to(x.dtype), offsets)
    u = ops.grouped_matmul(xs, p["wi_up"].to(x.dtype), offsets)
    h = F.silu(g) * u
    ys = ops.grouped_matmul(h, p["wo"].to(x.dtype), offsets)

    gathered = torch.empty_like(ys)
    gathered[order] = ys
    y = (gathered.reshape(B, S, k, D) * w[..., None]).sum(dim=2)
    return y, aux
