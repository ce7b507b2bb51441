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

``state_specs(param_specs, param_shapes)`` gives the state's logical axes
from the params' (``api.param_specs``), as the reference's does, so the
sharded step holds the state sharded as the params are.  On a sharded tree
``update`` takes ``mean``: ``mean(path, t, dims)`` is the mean over the
param dims ``dims`` of the whole leaf at ``path``, of which ``t`` is this
rank's shard (``parallel.fsdp.Sharded.mean``); Adafactor's factored
moments and its update clipping need it, AdamW is elementwise.  So that no
rank builds the whole state, ``init(shards, shapes)`` takes this rank's
shards of the params and the whole leaves' shapes, from which Adafactor
decides which leaves it factors.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from ..weights import flatten, tree_leaves, tree_map, unflatten


@dataclass(frozen=True)
class Optimizer:
    # (params, whole params' shapes when params are shards) -> state
    init: Callable[..., Any]
    # (grads, state, params, mean=None) -> (new params, new state)
    update: Callable[..., Tuple[Any, Any]]
    # (param logical specs, param shape tree) -> state logical specs
    state_specs: Callable[[Any, Any], Any]


def _count_like(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def with_master(inner: Optimizer, master_dtype=torch.float32) -> Optimizer:
    """Mixed precision: bf16 working params, an f32 master copy in the
    state; the update applies to the master and casts back."""

    def init(params, shapes=None):
        master = tree_map(lambda p: p.detach().to(master_dtype)
                          if p.is_floating_point() else p.detach(), params)
        return {"master": master, "inner": inner.init(master, shapes)}

    @torch.no_grad()
    def update(grads, state, params, mean=None):
        grads32 = tree_map(lambda g: g.float(), grads)
        new_master, new_inner = inner.update(grads32, state["inner"],
                                             state["master"], mean)
        new_params = tree_map(lambda m, p: m.to(p.dtype), new_master, params)
        return new_params, {"master": new_master, "inner": new_inner}

    def state_specs(param_specs, param_shapes):
        return {"master": param_specs,
                "inner": inner.state_specs(param_specs, param_shapes)}

    return Optimizer(init=init, update=update, state_specs=state_specs)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float, norm_fn=global_norm):
    """Scale every leaf by ``min(1, max_norm / norm)``; returns (tree,
    norm).  ``norm_fn`` takes the norm (a sharded tree's counts each
    element once: ``parallel.fsdp.Sharded.global_norm``)."""
    norm = norm_fn(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


# --------------------------------------------------------------------- AdamW
def adamw(schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, state_dtype=torch.float32) -> Optimizer:
    def init(params, shapes=None):
        zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": _count_like(params)}

    @torch.no_grad()
    def update(grads, state, params, mean=None):
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

    def state_specs(param_specs, param_shapes=None):
        return {"m": param_specs, "v": param_specs, "count": ()}

    return Optimizer(init=init, update=update, state_specs=state_specs)


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

    def init(params, shapes=None):
        whole = flatten(params if shapes is None else shapes)
        flat = {}
        for path, p in flatten(params).items():
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if _factored(whole[path]):
                flat[f"{path}/vr"] = z(p.shape[:-1])
                flat[f"{path}/vc"] = z(p.shape[:-2] + p.shape[-1:])
            else:
                flat[f"{path}/v"] = z(p.shape)
        return {"v": unflatten(flat), "count": _count_like(params)}

    @torch.no_grad()
    def update(grads, state, params, mean=None):
        count = state["count"] + 1
        lr = schedule(count)
        beta = 1.0 - count.float() ** (-decay)
        flat_v = flatten(state["v"])
        new_p, new_v = {}, {}
        for path, (g, p) in _zip(grads, params).items():
            g = g.float()
            g2 = g * g + eps
            n = g.ndim
            m = (functools.partial(mean, path) if mean is not None
                 else _local_mean)
            # the state says whether a leaf is factored: a shard's own
            # shape may be under the threshold where the whole leaf's is not
            if f"{path}/vr" in flat_v:
                vr = beta * flat_v[f"{path}/vr"] + (1 - beta) * m(g2, (n - 1,))
                vc = beta * flat_v[f"{path}/vc"] + (1 - beta) * m(g2, (n - 2,))
                denom = (vr[..., None] / m(vr, (n - 2,))[..., None, None]
                         ) * vc[..., None, :]
                u = g * torch.rsqrt(denom + eps)
                new_v[f"{path}/vr"], new_v[f"{path}/vc"] = vr, vc
            else:
                v = beta * flat_v[f"{path}/v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                new_v[f"{path}/v"] = v
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(m(u * u, tuple(range(n))) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            new_p[path] = (p.float() - lr * u
                           - lr * weight_decay * p.float()).to(p.dtype)
        return unflatten(new_p), {"v": unflatten(new_v), "count": count}

    def state_specs(param_specs, param_shapes):
        flat_s = flatten(param_shapes)
        out = {}
        for path, spec in flatten(param_specs).items():
            spec = tuple(spec)
            if _factored(flat_s[path]):
                out[f"{path}/vr"] = spec[:-1]
                out[f"{path}/vc"] = spec[:-2] + spec[-1:]
            else:
                out[f"{path}/v"] = spec
        return {"v": unflatten(out), "count": ()}

    return Optimizer(init=init, update=update, state_specs=state_specs)


def _local_mean(t: torch.Tensor, dims) -> torch.Tensor:
    """Mean of an unsharded leaf over ``dims``."""
    return t.mean(dims)
