"""The train step (counterpart of ``repro.launch.steps.make_train_step``),
for one device: gradients with f32 accumulation over microbatches, then
clipping by the global norm, then the optimizer's update.  Sharding comes
with the distributed tier (ROADMAP queue 1, item 3)."""
from __future__ import annotations

from typing import Dict

import torch

from ..models import api
from ..models.spec import ModelConfig
from ..optim import Optimizer, clip_by_global_norm
from ..weights import flatten, tree_leaves, tree_map, unflatten


def as_trainable(params):
    """Each leaf as a fresh leaf tensor that requires grad."""
    return tree_map(lambda p: p.detach().requires_grad_(), params)


def loss_and_grads(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                   microbatches: int = 1):
    """(loss, grads) of ``api.loss_fn``; ``params``' leaves require grad.

    With one microbatch the grads keep the params' dtype (as
    ``jax.value_and_grad`` gives them); with more, the batch is split along
    its first dim and the grads are summed in f32 and averaged, as are the
    losses."""
    paths = list(flatten(params))
    leaves = tree_leaves(params)

    def one(b):
        loss, _ = api.loss_fn(cfg, params, b)
        return loss, torch.autograd.grad(loss, leaves)

    if microbatches <= 1:
        loss, grads = one(batch)
        return loss.detach(), unflatten(dict(zip(paths, grads)))
    n = next(iter(batch.values())).shape[0]
    if n % microbatches:
        raise ValueError(f"batch {n} not divisible by {microbatches} "
                         f"microbatches")
    size = n // microbatches
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves]
    lsum = 0.0
    for i in range(microbatches):
        mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        loss, grads = one(mb)
        for acc, g in zip(gsum, grads):
            acc.add_(g.float())
        lsum = lsum + loss.detach()
    grads = unflatten({p: g / microbatches for p, g in zip(paths, gsum)})
    return lsum / microbatches, grads


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *,
                    microbatches: int = 1, clip_norm: float = 1.0,
                    grad_transform=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``.  The model trains on working params in
    ``cfg.dtype`` (``param_dtype = dtype``); ``with_master`` keeps the f32
    master in the optimizer state.

    ``grad_transform(grads, state) -> (grads, state)`` (a compressor's
    ``apply`` from :mod:`..runtime.compression`) runs on the gradients
    before clipping, and the step then carries its state as the reference
    trainer's step does: ``train_step(params, opt_state, state, batch) ->
    (params, opt_state, state, metrics)``."""
    train_cfg = cfg.replace(param_dtype=cfg.dtype)

    def step(params, opt_state, tstate, batch):
        loss, grads = loss_and_grads(train_cfg, as_trainable(params), batch,
                                     microbatches)
        if grad_transform is not None:
            grads, tstate = grad_transform(grads, tstate)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        return (as_trainable(new_params), new_opt, tstate,
                {"loss": loss, "grad_norm": gnorm})

    if grad_transform is not None:
        return step

    def train_step(params, opt_state, batch):
        new_params, new_opt, _, metrics = step(params, opt_state, None, batch)
        return new_params, new_opt, metrics

    return train_step
