"""The train, prefill and serve steps (counterpart of
``repro.launch.steps``).

``make_train_step(cfg, optimizer)`` is the one-device step: gradients with
f32 accumulation over microbatches, clipping by the global norm, the
optimizer's update.  Given a mesh (``launch.mesh.Mesh``) it is the sharded
step of the reference's ``make_train_step`` (ROADMAP queue 1, item 2), and
``make_prefill_step`` and ``make_serve_step`` are its serving steps.  Each
sharded builder returns ``(step, in_specs, out_specs, shapes)``: the
fitted specs (``parallel.sharding``) of what the step takes and returns,
and shapes on the meta device (``launch.specs``).  A rank passes the step
its shards (``parallel.fsdp.shard_tree``) and this rank's batch rows, and
gets shards back.  A builder given only axis sizes (a mapping such as
``launch.mesh.PRODUCTION_SHAPES[0]``) returns the specs and shapes of that
layout; its step cannot run.

The collectives are explicit (``parallel.fsdp``, ``parallel.tp``): the
weights are gathered a block at a time over the batch axes, the gradients
reduced to shards.  On ``model`` the steps compute as the reference's rules
shard: each sublayer whose fitted specs put ``model`` on its heads, MLP
columns, experts or vocab keeps its ``model``-local weights and ends in
one all-reduce over ``model`` (``Sharded.tp``); the loss is vocab-parallel
and the prefill and serve steps return vocab-local logits.  Where the
rules put ``model`` on the K/V head_dim (decode, and prefill where
``n_kv_heads`` does not divide ``model``) the attention is a
``parallel.tp.HeadDimAxis``: decode computes on its head_dim shard of the
weights and the KV cache (long decode on its sequence block too), and
gathers no weight or cache over ``model``; prefill gathers ``wk``, ``wv``,
``bk`` and ``bv`` over ``model``, attends on the local q heads and keeps
its head_dim slice of the cache.  An SSM mixer whose ``ssm_inner`` splits
into whole heads over ``model`` computes on its local heads (``models.ssd``:
the gated norm summed over ``model``; prefill gathers its cache's state and
x channels whole, decode the new ``xs_raw`` row and ``conv_x``); a
sublayer whose fit drops ``model`` gathers over ``model`` and computes
whole.  The layout of the state and the shapes are the reference's.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

from ..configs.shapes import ShapeSpec
from ..models import api
from ..models.spec import ModelConfig, PartitionSpec, logical_to_pspec
from ..optim import Optimizer, clip_by_global_norm
from ..parallel.fsdp import Sharded
from ..parallel.sharding import (WorkloadKind, axes_of, batch_pspec,
                                 cache_pspecs, fit_tree, mesh_shape,
                                 param_pspecs, rules_for, tree_map)
from ..weights import flatten, tree_leaves, tree_map as map_leaves, unflatten
from . import specs as sp

# params subtrees stacked over layers, gathered a block at a time; every
# other leaf (embeddings, final norms, mm_proj) is gathered once a step
STACKED = ("blocks", "enc", "dec")


def as_trainable(params):
    """Each leaf as a fresh leaf tensor that requires grad."""
    return map_leaves(lambda p: p.detach().requires_grad_(), params)


def loss_and_grads(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                   microbatches: int = 1, loss_fn=None):
    """(loss, grads) of ``api.loss_fn``; ``params``' leaves require grad.

    With one microbatch the grads keep the params' dtype (as
    ``jax.value_and_grad`` gives them); with more, the batch is split along
    its first dim and the grads are summed in f32 and averaged, as are the
    losses.  ``loss_fn(params, batch) -> loss`` replaces ``api.loss_fn``
    (the sharded step's)."""
    paths = list(flatten(params))
    leaves = tree_leaves(params)
    if loss_fn is None:
        def loss_fn(p, b):
            return api.loss_fn(cfg, p, b)[0]

    def one(b):
        loss = loss_fn(params, b)
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


def _ssm_dims(cfg: ModelConfig):
    """The SSM mixers' ``(d_inner, head_dim)`` for ``Sharded``, or None
    for a model with none."""
    if "mamba" not in cfg.pattern:
        return None
    return cfg.ssm_expand * cfg.d_model, cfg.ssm_head_dim


def _batch_pspecs(cfg: ModelConfig, rules) -> Dict[str, PartitionSpec]:
    out = {"inputs": batch_pspec(rules, 2), "targets": batch_pspec(rules, 2)}
    if cfg.n_img_tokens > 0:
        out["img_embeds"] = batch_pspec(rules, 3)
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = batch_pspec(rules, 3)
    return out


def _logits_pspec(cfg: ModelConfig, rules, mesh) -> PartitionSpec:
    """[B, V] logits: sharded on vocab over ``model`` when it divides."""
    vshard = ("model" if cfg.vocab_size % mesh_shape(mesh)["model"] == 0
              else None)
    return PartitionSpec(rules.get("batch"), vshard)


def _check_runnable(mesh) -> None:
    if isinstance(mesh, Mapping):
        raise TypeError("this step was built from axis sizes only; it runs "
                        "on a launch.mesh.Mesh")


def _gather_unstacked(sharded: Sharded, params):
    """Every unstacked leaf whole, the stacked subtrees as shards."""
    top = {k: v for k, v in params.items() if k not in STACKED}
    return {**sharded.gather(top, ""),
            **{k: v for k, v in params.items() if k in STACKED}}


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, mesh=None, *,
                    multi_pod: bool = False, microbatches: int = 1,
                    clip_norm: float = 1.0, seq_shard: bool = False,
                    grad_transform=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``.  The model trains on working params in
    ``cfg.dtype`` (``param_dtype = dtype``); ``with_master`` keeps the f32
    master in the optimizer state, so the FSDP gathers move working params.

    Without ``mesh``, one device.  ``grad_transform(grads, state) ->
    (grads, state)`` (a compressor's ``apply`` from
    :mod:`..runtime.compression`) runs on the gradients before clipping,
    and the step then carries its state as the reference trainer's step
    does: ``train_step(params, opt_state, state, batch) -> (params,
    opt_state, state, metrics)``.

    With ``mesh``, returns ``(train_step, (param specs, opt specs, batch
    specs), (param specs, opt specs, {"loss", "grad_norm": P()}),
    (param shapes, opt shapes))``; the step takes and returns shards and
    this rank's batch rows, its loss and norm global.  The loss's means are
    the global batch's: each rank weights its nll by its share of the
    tokens, and the MoE load-balance loss takes its batch means over the
    batch ranks.  Microbatches split each rank's rows.  The step's
    ``loss_and_grads(params, batch)`` gives this rank's loss and its shards
    of the gradients before clipping, and its ``sharded`` the
    :class:`Sharded`."""
    train_cfg = cfg.replace(param_dtype=cfg.dtype)
    if mesh is None:
        return _local_train_step(train_cfg, optimizer, microbatches,
                                 clip_norm, grad_transform)
    if grad_transform is not None:
        raise ValueError("the sharded train step takes no grad_transform")
    rules = rules_for(WorkloadKind.TRAIN, multi_pod, seq_shard=seq_shard)
    params_s, specs, opt_s = sp.state_shapes(train_cfg, optimizer)
    p_pspecs = fit_tree(param_pspecs(specs, rules), params_s, mesh)
    # the state's logical axes come from the params' (a factored Adafactor
    # moment drops one), then map onto the mesh
    o_pspecs = fit_tree(tree_map(lambda ax: logical_to_pspec(ax, rules),
                                 optimizer.state_specs(specs, params_s)),
                        opt_s, mesh)
    b_pspecs = _batch_pspecs(cfg, rules)
    batch_axes = axes_of(rules["batch"])
    sharded = Sharded(mesh, p_pspecs, batch_axes, ssm_dims=_ssm_dims(cfg))
    n_batch = math.prod(mesh_shape(mesh)[a] for a in batch_axes)

    def loss(params, b):
        full = _gather_unstacked(sharded, params)
        lval, metrics = api.loss_fn(train_cfg, full, b, sharded)
        if "mask" in b:
            # this rank's nll weighted by its share of the global tokens,
            # so that the mean over the batch ranks is the global nll
            n = metrics["tokens"]
            share = n * n_batch / sharded.batch_sum(n.clone())
            lval = lval + metrics["nll"] * (share - 1.0)
        return lval

    def grads_of(params, batch):
        """(this rank's loss, its shards of the gradients) before
        clipping."""
        _check_runnable(mesh)
        return loss_and_grads(train_cfg, as_trainable(params), batch,
                              microbatches, loss)

    def train_step(params, opt_state, batch):
        lval, grads = grads_of(params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip_norm,
                                           sharded.global_norm)
        new_params, new_opt = optimizer.update(grads, opt_state, params,
                                               sharded.mean)
        return (as_trainable(new_params), new_opt,
                {"loss": sharded.batch_mean(lval), "grad_norm": gnorm})

    train_step.sharded, train_step.rules = sharded, rules
    train_step.loss_and_grads = grads_of
    scalar = {"loss": PartitionSpec(), "grad_norm": PartitionSpec()}
    return (train_step, (p_pspecs, o_pspecs, b_pspecs),
            (p_pspecs, o_pspecs, scalar), (params_s, opt_s))


def _local_train_step(train_cfg, optimizer, microbatches, clip_norm,
                      grad_transform):
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


def _serving(cfg, mesh, rules, shape: ShapeSpec, decode: bool = False):
    """The serving params' shapes (every floating leaf in ``cfg.dtype`` but
    those ``api.cast_for_serving`` keeps in f32) and specs, the caches'
    shapes and specs, and the steps' :class:`Sharded` (of a decode step
    with ``decode``)."""
    params_s, specs, _ = sp.state_shapes(cfg)
    params_s = api.cast_for_serving(cfg, params_s)
    p_pspecs = fit_tree(param_pspecs(specs, rules), params_s, mesh)
    cache_shapes = sp.cache_specs_shapes(cfg, shape)
    c_pspecs = fit_tree(cache_pspecs(cfg, cache_shapes, rules), cache_shapes,
                        mesh)
    sharded = Sharded(mesh, p_pspecs, axes_of(rules.get("batch")),
                      cache_pspecs=c_pspecs, decode=decode,
                      ssm_dims=_ssm_dims(cfg))
    return params_s, p_pspecs, cache_shapes, c_pspecs, sharded


def make_prefill_step(cfg: ModelConfig, mesh, shape: ShapeSpec, *,
                      multi_pod: bool = False, seq_shard: bool = False):
    """``prefill_step(params, batch) -> (logits, caches)`` over
    ``shape.seq_len`` tokens into caches of ``s_max = seq_len +
    DECODE_MARGIN``.  Returns ``(prefill_step, (param specs, batch specs),
    (logits spec, cache specs), param shapes)``.  Serving params are
    ``api.cast_for_serving``'s.  When ``n_kv_heads`` does not divide the
    ``model`` axis the KV cache is sharded on ``head_dim`` instead: the
    attention gathers ``wk``, ``wv``, ``bk`` and ``bv`` over ``model``,
    runs on the local q heads and the kv heads they read, and keeps this
    rank's head_dim slice of every kv head; else it makes this rank's kv
    heads only.  Each block's caches are cut to this rank's shard as the
    block makes them (``Sharded.cache_cut``).  The logits are this rank's
    block of the logits spec: vocab-local where the vocab splits over
    ``model`` (``parallel.tp.greedy_tokens`` takes a token)."""
    rules = rules_for(WorkloadKind.PREFILL, multi_pod, seq_shard=seq_shard)
    if cfg.n_kv_heads % mesh_shape(mesh)["model"] != 0:
        # a 32k cache would otherwise be replicated over the model axis
        rules["kv_heads"] = None
        rules["head_dim"] = "model"
    s_max = shape.seq_len + sp.DECODE_MARGIN
    params_s, p_pspecs, _, c_pspecs, sharded = _serving(
        cfg, mesh, rules, shape)
    b_pspecs = _batch_pspecs(cfg, rules)
    b_pspecs.pop("targets")
    l_pspec = _logits_pspec(cfg, rules, mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        _check_runnable(mesh)
        return api.prefill(cfg, _gather_unstacked(sharded, params), batch,
                           s_max, sharded)

    prefill_step.rules, prefill_step.sharded = rules, sharded
    return (prefill_step, (p_pspecs, b_pspecs), (l_pspec, c_pspecs),
            params_s)


def make_serve_step(cfg: ModelConfig, mesh, shape: ShapeSpec, *,
                    multi_pod: bool = False):
    """``serve_step(params, token, caches) -> (logits, caches)``: one
    decode token against caches ``shape.seq_len`` deep, written in place.
    Returns ``(serve_step, (param specs, token spec, cache specs), (logits
    spec, cache specs), (param shapes, cache shapes))``.  One sequence
    (``global_batch == 1``) is long decode: the cache's sequence is sharded
    over the batch axes.  An FFN of ``d_ff >= 16384`` runs in 4 chunks.
    The FFN, the MoE and the embeddings are tensor-parallel as in prefill;
    the attention computes on its head_dim shard of the weights and the
    caches, where the decode rules put ``model`` (and in long decode on
    its sequence block, its softmax merged over the batch axes).  The
    logits are vocab-local as prefill's."""
    kind = (WorkloadKind.LONG_DECODE if shape.global_batch == 1
            else WorkloadKind.DECODE)
    rules = rules_for(kind, multi_pod)
    if cfg.d_ff >= 16384 and cfg.ffn_chunks == 1:
        cfg = cfg.replace(ffn_chunks=4)
    params_s, p_pspecs, cache_shapes, c_pspecs, sharded = _serving(
        cfg, mesh, rules, shape, decode=True)
    l_pspec = _logits_pspec(cfg, rules, mesh)
    t_pspec = PartitionSpec(rules.get("batch"))

    @torch.no_grad()
    def serve_step(params, token, caches):
        _check_runnable(mesh)
        return api.decode_step(cfg, _gather_unstacked(sharded, params),
                               token, caches, sharded)

    serve_step.rules, serve_step.cfg = rules, cfg
    serve_step.sharded = sharded
    return (serve_step, (p_pspecs, t_pspec, c_pspecs), (l_pspec, c_pspecs),
            (params_s, cache_shapes))
