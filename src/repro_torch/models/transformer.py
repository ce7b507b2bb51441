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
"""
from __future__ import annotations

from typing import Dict, Union

import torch

from . import layers as L
from .layers import KVCache
from .moe import moe_gather
from .spec import ModelConfig
from .ssd import SSMCache, ssm_decode, ssm_prefill


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


def block_params(params, i: int):
    """Block ``i`` of the stacked ``blocks`` tree (views, no copies)."""
    return layer_slice(params["blocks"], i)


def _ffn(cfg: ModelConfig, p, x: torch.Tensor, pos: int) -> torch.Tensor:
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if _layer_is_moe(cfg, pos):
        h, _ = moe_gather(p["moe"], cfg, h)
    else:
        h = L.mlp(p["mlp"], h)
    return x + h


def _block_prefill(cfg: ModelConfig, bp, x: torch.Tensor, s_max: int):
    caches = {}
    for pos, kind in enumerate(cfg.pattern):
        p = bp[f"l{pos}"]
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        if kind == "attn":
            h, c = L.attention_prefill(p["attn"], cfg, h, s_max,
                                       window=cfg.sliding_window)
        else:
            h, c = ssm_prefill(p["ssm"], cfg, h)
        caches[f"l{pos}"] = c
        x = x + h
        if _has_ffn(cfg):
            x = _ffn(cfg, p, x, pos)
    return x, caches


def _block_decode(cfg: ModelConfig, bp, x: torch.Tensor, caches):
    new = {}
    for pos, kind in enumerate(cfg.pattern):
        p = bp[f"l{pos}"]
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        if kind == "attn":
            h, c = L.attention_decode(p["attn"], cfg, h, caches[f"l{pos}"],
                                      window=cfg.sliding_window)
        else:
            h, c = ssm_decode(p["ssm"], cfg, h, caches[f"l{pos}"])
        new[f"l{pos}"] = c
        x = x + h
        if _has_ffn(cfg):
            x = _ffn(cfg, p, x, pos)
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
                 img_embeds=None) -> torch.Tensor:
    """Token embeddings [B,S,D], after the projected image embeddings
    [B,n_img,D] for a VLM (``einsum('bnd,de->bne')`` with ``mm_proj``)."""
    x = L.embed(params, cfg, tokens)
    if cfg.n_img_tokens <= 0:
        return x
    want = [tokens.shape[0], cfg.n_img_tokens, cfg.d_model]
    got = None if img_embeds is None else list(img_embeds.shape)
    if got != want:
        raise ValueError(f"{cfg.name}: img_embeds {want} expected, got {got}")
    img = img_embeds.to(x.dtype) @ params["mm_proj"].to(x.dtype)
    return torch.cat([img, x], dim=1)


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, s_max: int,
            img_embeds=None):
    """tokens: [B, S] (after ``img_embeds`` [B, n_img, D] for a VLM) ->
    (last-token logits [B, V], caches over all n_img + S positions)."""
    check_supported(cfg)
    x = embed_inputs(cfg, params, tokens, img_embeds)
    per_block = []
    for i in range(cfg.n_blocks):
        x, c = _block_prefill(cfg, block_params(params, i), x, s_max)
        per_block.append(c)
    caches: Dict[str, Cache] = {
        name: _stack([c[name] for c in per_block]) for name in per_block[0]}
    logits = L.unembed(params, cfg, x[:, -1:])
    return logits[:, 0], caches


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, caches):
    """token: [B] -> (logits [B, V], caches advanced by one position)."""
    check_supported(cfg)
    x = L.embed(params, cfg, token[:, None])
    for i in range(cfg.n_blocks):
        block_cache = {name: _unstack(c, i) for name, c in caches.items()}
        x, _ = _block_decode(cfg, block_params(params, i), x, block_cache)
    new = {name: _advance(c) for name, c in caches.items()}
    logits = L.unembed(params, cfg, x)
    return logits[:, 0], new
