"""Decoder-only LM assembly in PyTorch (counterpart of
``repro.models.transformer``) for the dense, MoE, SSM, hybrid and VLM
families.  A VLM (phi-3-vision) projects its image embeddings with
``mm_proj`` and puts them ahead of the token embeddings; decode positions
then continue after both.

Layers come in repeating blocks (the config's ``layer_pattern``; one
``attn`` layer for homogeneous transformers, one ``mamba`` layer for
mamba2, eight mixed layers for jamba).  Parameters keep the JAX tree:
``blocks/l{pos}`` holds every leaf of pattern position ``pos`` stacked over
the blocks, so one loader maps a JAX params pytree onto the port.  The
block loop that JAX runs under ``lax.scan`` is a Python loop over those
stacks.  Caches are ``{"l{pos}": KVCache | SSMCache}``, stacked over blocks
as the JAX ``prefill`` returns them; ``decode_step`` advances them in place.

Training: ``forward`` and ``loss_fn`` (next-token cross-entropy in f32 with
the optional ``mask``, plus ``0.01 * aux`` for MoE; a VLM's image-token
logits are sliced off).  With ``cfg.remat``, each layer runs under
``torch.utils.checkpoint`` (non-reentrant) when grad is enabled, as JAX
remats ``_layer_forward``: only the layer's input is kept, and its forward
runs again in the backward pass.

Sharded steps (``launch.steps`` with a mesh) pass ``sharded``, a
``parallel.fsdp.Sharded``: each layer's weights arrive as this rank's
shards, and the layer gathers them first, inside its remat, so that only
one layer's gathered weights are alive and the backward gathers them
again; ``prefill`` and ``decode_step`` gather a block at a time.  Each
sublayer asks ``sharded.tp(path)`` whether it computes tensor-parallel:
then its weights stay ``model``-local (attention on the local heads or
its K/V head_dim shard, the MLP on its columns, the MoE on its experts,
the SSM mixer on its heads of ``ssm_inner``, the embeddings and logits on
the local vocab) and it ends in one sum over ``model``; the loss is the
vocab-parallel one (:func:`lm_nll`).  Otherwise it computes whole on
gathered weights.  Prefill cuts each block's new caches to this rank's
shard before the next block runs, and decode computes on the cache
shards in place: attention on its head_dim slice (and sequence block,
``sharded.cache_seq``), the SSM mixers on their batch rows of the state
and conv tail, which ``model`` replicates.  The MoE load-balance loss takes its batch means over
the ranks that split the batch.
"""
from __future__ import annotations

import functools
from typing import Dict, Union

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from .layers import KVCache
from .moe import moe_gather
from .spec import ModelConfig
from .ssd import SSMCache, ssm_decode, ssm_layer, ssm_prefill


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a layer kind other than 'attn' and 'mamba' (the reference
    would build an SSM layer for it without a word)."""
    if any(kind not in ("attn", "mamba") for kind in cfg.pattern):
        raise NotImplementedError(
            f"{cfg.name}: layer pattern {cfg.pattern} has a kind other "
            f"than 'attn' and 'mamba'")


def _layer_is_moe(cfg: ModelConfig, global_idx: int) -> bool:
    if cfg.n_experts <= 0:
        return False
    return global_idx % cfg.moe_every == (cfg.moe_every - 1)


def _has_ffn(cfg: ModelConfig) -> bool:
    return cfg.d_ff > 0 or cfg.n_experts > 0


def layer_slice(tree, i: int):
    """Entry ``i`` of every leaf of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def unbind_layers(tree):
    """Every entry of a stacked tree, as a list of trees of views.

    ``unbind``'s backward stacks the entries' gradients once; indexing the
    stacked leaf once per layer would instead make each layer's gradient a
    zero-filled stacked-size tensor, summed over the layers."""
    if isinstance(tree, dict):
        subs = {k: unbind_layers(v) for k, v in tree.items()}
        n = len(next(iter(subs.values())))
        return [{k: v[i] for k, v in subs.items()} for i in range(n)]
    return tree.unbind(0)


def block_params(params, i: int):
    """Block ``i`` of the stacked ``blocks`` tree (views, no copies)."""
    return layer_slice(params["blocks"], i)


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``cfg.remat``
    and grad is enabled (serving runs it plainly)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def tp_of(sharded, path: str):
    """The ``model`` axis of the sublayer at ``path`` when ``sharded`` runs
    it tensor-parallel, else None."""
    return None if sharded is None else sharded.tp(path)


def _ffn(cfg: ModelConfig, p, x: torch.Tensor, pos: int, sharded=None,
         data_mean=None):
    """x + FFN(rmsnorm(x)); returns (x, the MoE aux loss or None).
    ``data_mean`` goes to the MoE's routing (training's)."""
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if _layer_is_moe(cfg, pos):
        h, aux = moe_gather(p["moe"], cfg, h, data_mean=data_mean,
                            tp=tp_of(sharded, f"blocks/l{pos}/moe"))
    else:
        h, aux = L.mlp(p["mlp"], h, cfg.ffn_chunks,
                       tp_of(sharded, f"blocks/l{pos}/mlp")), None
    return x + h, aux


# ------------------------------------------------------------------ forward
def _layer_forward(cfg: ModelConfig, kind: str, pos: int, sharded, p,
                   x: torch.Tensor):
    """One layer (mixer + FFN), full sequence.  Returns (x, aux f32)."""
    if sharded is not None:
        p = sharded.gather(p, f"blocks/l{pos}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind == "attn":
        h = L.attention(p["attn"], cfg, h, causal=True,
                        window=cfg.sliding_window,
                        tp=tp_of(sharded, f"blocks/l{pos}/attn"))
    else:
        h = ssm_layer(p["ssm"], cfg, h,
                      tp=tp_of(sharded, f"blocks/l{pos}/ssm"))
    x = x + h
    if _has_ffn(cfg):
        x, a = _ffn(cfg, p, x, pos, sharded, data_mean=(
            None if sharded is None else sharded.data_mean))
        if a is not None:
            aux = aux + a
    return x, aux


def run_blocks(cfg: ModelConfig, params, x: torch.Tensor, sharded=None):
    """The block stack, layer by layer (each under :func:`remat`).  Returns
    (x, total aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp in unbind_layers(params["blocks"]):
        for pos, kind in enumerate(cfg.pattern):
            f = functools.partial(_layer_forward, cfg, kind, pos, sharded)
            x, a = remat(cfg, f, bp[f"l{pos}"], x)
            aux = aux + a
    return x, aux


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, img_embeds=None,
            sharded=None):
    """tokens [B, S] -> (logits [B, n_img + S, V], aux); a VLM puts its
    projected image embeddings ahead of the tokens."""
    check_supported(cfg)
    x = embed_inputs(cfg, params, tokens, img_embeds,
                     tp_of(sharded, "tok_embed"))
    x, aux = run_blocks(cfg, params, x, sharded)
    return L.unembed(params, cfg, x, tp_of(sharded, "unembed")), aux


def lm_nll(logits: torch.Tensor, batch, tp=None):
    """Mean next-token negative log-likelihood in f32 over the ``mask``
    (all ones when the batch has none).  Returns (nll, token count).

    With ``tp`` the logits are vocab-local (``L.unembed``'s): the
    logsumexp's row max and sum, and the gold logit (from the rank that
    holds it), are each all-reduced over ``model``, so every ``model`` rank
    has the whole nll."""
    logits = logits.float()
    targets = batch["targets"].long()
    if tp is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    else:
        logz, gold = tp.logsumexp(logits), tp.pick(logits, targets)
    mask = batch.get("mask")
    mask = (torch.ones_like(logz) if mask is None
            else mask.to(device=logz.device, dtype=torch.float32))
    n = mask.sum()
    return ((logz - gold) * mask).sum() / torch.clamp(n, min=1.0), n


def loss_fn(cfg: ModelConfig, params, batch, sharded=None):
    """batch ``inputs``, ``targets`` [B, S] (+ ``mask``, ``img_embeds``)
    -> (loss, {"nll", "aux", "tokens"}); loss = nll + 0.01 aux."""
    logits, aux = forward(cfg, params, batch["inputs"],
                          img_embeds=batch.get("img_embeds"),
                          sharded=sharded)
    if cfg.n_img_tokens > 0:
        logits = logits[:, cfg.n_img_tokens:]
    nll, n = lm_nll(logits, batch, tp_of(sharded, "unembed"))
    return nll + 0.01 * aux, {"nll": nll, "aux": aux, "tokens": n}


# ------------------------------------------------------------ serving
def _block_prefill(cfg: ModelConfig, bp, x: torch.Tensor, s_max: int,
                   sharded=None):
    caches = {}
    for pos, kind in enumerate(cfg.pattern):
        p = bp[f"l{pos}"]
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        if kind == "attn":
            h, c = L.attention_prefill(
                p["attn"], cfg, h, s_max, window=cfg.sliding_window,
                tp=tp_of(sharded, f"blocks/l{pos}/attn"))
        else:
            h, c = ssm_prefill(p["ssm"], cfg, h,
                               tp=tp_of(sharded, f"blocks/l{pos}/ssm"))
        caches[f"l{pos}"] = c
        x = x + h
        if _has_ffn(cfg):
            x, _ = _ffn(cfg, p, x, pos, sharded)
    return x, caches


def seq_of(sharded, name: str):
    """The sequence block of the KV cache ``name`` when ``sharded`` cuts
    it (long decode), else None."""
    return None if sharded is None else sharded.cache_seq(name)


def _block_decode(cfg: ModelConfig, bp, x: torch.Tensor, caches,
                  sharded=None):
    new = {}
    for pos, kind in enumerate(cfg.pattern):
        p = bp[f"l{pos}"]
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        if kind == "attn":
            h, c = L.attention_decode(
                p["attn"], cfg, h, caches[f"l{pos}"],
                window=cfg.sliding_window,
                tp=tp_of(sharded, f"blocks/l{pos}/attn"),
                seq=seq_of(sharded, f"l{pos}"))
        else:
            h, c = ssm_decode(p["ssm"], cfg, h, caches[f"l{pos}"],
                              tp=tp_of(sharded, f"blocks/l{pos}/ssm"))
        new[f"l{pos}"] = c
        x = x + h
        if _has_ffn(cfg):
            x, _ = _ffn(cfg, p, x, pos, sharded)
    return x, new


Cache = Union[KVCache, SSMCache]


def _stack(cs) -> Cache:
    if isinstance(cs[0], SSMCache):
        return SSMCache(conv=torch.stack([c.conv for c in cs]),
                        state=torch.stack([c.state for c in cs]))
    return KVCache(k=torch.stack([c.k for c in cs]),
                   v=torch.stack([c.v for c in cs]), length=cs[0].length)


def _unstack(c: Cache, i: int) -> Cache:
    if isinstance(c, SSMCache):
        return SSMCache(conv=c.conv[i], state=c.state[i])
    return KVCache(k=c.k[i], v=c.v[i], length=c.length)


def _advance(c: Cache) -> Cache:
    if isinstance(c, SSMCache):
        return c
    return KVCache(k=c.k, v=c.v, length=c.length + 1)


def embed_inputs(cfg: ModelConfig, params, tokens: torch.Tensor,
                 img_embeds=None, tp=None) -> torch.Tensor:
    """Token embeddings [B,S,D] (``tp``: the embedding's, :func:`L.embed`),
    after the projected image embeddings [B,n_img,D] for a VLM
    (``einsum('bnd,de->bne')`` with ``mm_proj``)."""
    x = L.embed(params, cfg, tokens, tp)
    if cfg.n_img_tokens <= 0:
        return x
    want = [tokens.shape[0], cfg.n_img_tokens, cfg.d_model]
    got = None if img_embeds is None else list(img_embeds.shape)
    if got != want:
        raise ValueError(f"{cfg.name}: img_embeds {want} expected, got {got}")
    img = img_embeds.to(x.dtype) @ params["mm_proj"].to(x.dtype)
    return torch.cat([img, x], dim=1)


def _block_weights(params, i: int, sharded):
    bp = block_params(params, i)
    return bp if sharded is None else sharded.gather(bp, "blocks")


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, s_max: int,
            img_embeds=None, sharded=None):
    """tokens: [B, S] (after ``img_embeds`` [B, n_img, D] for a VLM) ->
    (last-token logits [B, V], caches over all n_img + S positions).  With
    a vocab-parallel unembed (``sharded``) the logits are this rank's
    ``[B, V / model]``."""
    check_supported(cfg)
    x = embed_inputs(cfg, params, tokens, img_embeds,
                     tp_of(sharded, "tok_embed"))
    per_block = []
    for i in range(cfg.n_blocks):
        x, c = _block_prefill(cfg, _block_weights(params, i, sharded), x,
                              s_max, sharded)
        if sharded is not None:
            # a tensor-parallel attention made this rank's part of its
            # cache already (local kv heads, or a head_dim slice)
            c = {name: sharded.cache_cut(
                cc, name, tp_of(sharded, f"blocks/{name}/attn") is not None)
                for name, cc in c.items()}
        per_block.append(c)
    caches: Dict[str, Cache] = {
        name: _stack([c[name] for c in per_block]) for name in per_block[0]}
    logits = L.unembed(params, cfg, x[:, -1:], tp_of(sharded, "unembed"))
    return logits[:, 0], caches


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, caches,
                sharded=None):
    """token: [B] -> (logits [B, V], or vocab-local as prefill's; caches
    advanced by one position)."""
    check_supported(cfg)
    x = L.embed(params, cfg, token[:, None], tp_of(sharded, "tok_embed"))
    for i in range(cfg.n_blocks):
        block_cache = {name: _unstack(c, i) for name, c in caches.items()}
        x, _ = _block_decode(cfg, _block_weights(params, i, sharded), x,
                             block_cache, sharded)
    new = {name: _advance(c) for name, c in caches.items()}
    logits = L.unembed(params, cfg, x, tp_of(sharded, "unembed"))
    return logits[:, 0], new
