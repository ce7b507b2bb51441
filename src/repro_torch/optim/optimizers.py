"""AdamW and Adafactor over a params tree (counterpart of
``repro.optim.optimizers``).

Functional, as the JAX package's are: ``init(params) -> state`` and
``update(grads, state, params) -> (new_params, new_state)``, with no
``torch.optim`` class (its AdamW orders weight decay and bias correction
differently).  The state trees have the JAX trees' paths and dtypes
(``m``, ``v``, ``count``; Adafactor's ``vr``/``vc`` or ``v`` per leaf;
``with_master``'s ``master`` and ``inner``), so a state carries across
(``weights.from_jax_opt_state``).  The arithmetic is f32, in the JAX
code's order.  Updates run under ``torch.no_grad``; the new params are new
tensors (the step makes them leaves that require grad again).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from ..weights import flatten, tree_leaves, tree_map, unflatten


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def _count_like(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def with_master(inner: Optimizer, master_dtype=torch.float32) -> Optimizer:
    """Mixed precision: bf16 working params, an f32 master copy in the
    state; the update applies to the master and casts back."""

    def init(params):
        master = tree_map(lambda p: p.detach().to(master_dtype)
                          if p.is_floating_point() else p.detach(), params)
        return {"master": master, "inner": inner.init(master)}

    @torch.no_grad()
    def update(grads, state, params):
        grads32 = tree_map(lambda g: g.float(), grads)
        new_master, new_inner = inner.update(grads32, state["inner"],
                                             state["master"])
        new_params = tree_map(lambda m, p: m.to(p.dtype), new_master, params)
        return new_params, {"master": new_master, "inner": new_inner}

    return Optimizer(init=init, update=update)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf by ``min(1, max_norm / norm)``; returns (tree,
    norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


# --------------------------------------------------------------------- AdamW
def adamw(schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, state_dtype=torch.float32) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": _count_like(params)}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        lr = schedule(count)
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()

        def upd(g, m, v, p):
            g = g.float()
            m_new = b1 * m.float() + (1 - b1) * g
            v_new = b2 * v.float() + (1 - b2) * g * g
            step = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            step = step + weight_decay * p.float()
            new_p = p.float() - lr * step
            return (new_p.to(p.dtype), m_new.to(state_dtype),
                    v_new.to(state_dtype))

        out = {path: upd(g, m, v, p) for path, (g, m, v, p) in _zip(
            grads, state["m"], state["v"], params).items()}
        return (unflatten({k: o[0] for k, o in out.items()}),
                {"m": unflatten({k: o[1] for k, o in out.items()}),
                 "v": unflatten({k: o[2] for k, o in out.items()}),
                 "count": count})

    return Optimizer(init=init, update=update)


def _zip(*trees):
    """{path: (leaf of each tree)} over the first tree's paths."""
    flats = [flatten(t) for t in trees]
    return {path: tuple(f[path] for f in flats) for path in flats[0]}


# ----------------------------------------------------------------- Adafactor
def adafactor(schedule, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0,
              min_dim_size_to_factor: int = 128) -> Optimizer:
    """Adafactor (Shazeer & Stern): factored second moments (``vr`` over
    rows, ``vc`` over columns) for leaves whose last two dims are both at
    least ``min_dim_size_to_factor``, a full ``v`` otherwise; updates
    clipped to RMS ``clip_threshold``."""

    def _factored(p) -> bool:
        return (p.ndim >= 2 and p.shape[-1] >= min_dim_size_to_factor
                and p.shape[-2] >= min_dim_size_to_factor)

    def init(params):
        flat = {}
        for path, p in flatten(params).items():
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if _factored(p):
                flat[f"{path}/vr"] = z(p.shape[:-1])
                flat[f"{path}/vc"] = z(p.shape[:-2] + p.shape[-1:])
            else:
                flat[f"{path}/v"] = z(p.shape)
        return {"v": unflatten(flat), "count": _count_like(params)}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        lr = schedule(count)
        beta = 1.0 - count.float() ** (-decay)
        flat_v = flatten(state["v"])
        new_p, new_v = {}, {}
        for path, (g, p) in _zip(grads, params).items():
            g = g.float()
            g2 = g * g + eps
            if _factored(p):
                vr = beta * flat_v[f"{path}/vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * flat_v[f"{path}/vc"] + (1 - beta) * g2.mean(-2)
                denom = (vr[..., None] / vr.mean(-1, keepdim=True)[..., None]
                         ) * vc[..., None, :]
                u = g * torch.rsqrt(denom + eps)
                new_v[f"{path}/vr"], new_v[f"{path}/vc"] = vr, vc
            else:
                v = beta * flat_v[f"{path}/v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                new_v[f"{path}/v"] = v
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            new_p[path] = (p.float() - lr * u
                           - lr * weight_decay * p.float()).to(p.dtype)
        return unflatten(new_p), {"v": unflatten(new_v), "count": count}

    return Optimizer(init=init, update=update)
