"""Decoder-only LM assembly in PyTorch (counterpart of
``repro.models.transformer``), for the attention-only pattern of the dense
and MoE families.

Parameters keep the JAX tree: ``blocks`` holds every leaf stacked over the
blocks, so one loader maps a JAX params pytree onto the port.  The block
loop that JAX runs under ``lax.scan`` is a Python loop over those stacks.
Caches are ``{"l0": KVCache}`` with K/V stacked over blocks, as the JAX
``prefill`` returns them; ``decode_step`` writes each new K/V row into them
in place.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import layers as L
from .layers import KVCache
from .moe import moe_gather
from .spec import ModelConfig


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the families this slice of the port does not run."""
    if cfg.is_encoder_decoder or cfg.n_img_tokens > 0:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and VLM models are not ported yet "
            f"(ROADMAP.md, queue 1, item 4)")
    if cfg.pattern != ("attn",) or cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: SSM and hybrid layer patterns are not ported yet "
            f"(ROADMAP.md, queue 1, item 2)")


def _layer_is_moe(cfg: ModelConfig, global_idx: int) -> bool:
    if cfg.n_experts <= 0:
        return False
    return global_idx % cfg.moe_every == (cfg.moe_every - 1)


def _has_ffn(cfg: ModelConfig) -> bool:
    return cfg.d_ff > 0 or cfg.n_experts > 0


def block_params(params, i: int):
    """Block ``i`` of the stacked ``blocks`` tree (views, no copies)."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return take(params["blocks"])


def _ffn(cfg: ModelConfig, p, x: torch.Tensor, pos: int) -> torch.Tensor:
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if _layer_is_moe(cfg, pos):
        h, _ = moe_gather(p["moe"], cfg, h)
    else:
        h = L.mlp(p["mlp"], h)
    return x + h


def _block_prefill(cfg: ModelConfig, bp, x: torch.Tensor, s_max: int):
    caches = {}
    for pos, _ in enumerate(cfg.pattern):
        p = bp[f"l{pos}"]
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        h, c = L.attention_prefill(p["attn"], cfg, h, s_max,
                                   window=cfg.sliding_window)
        caches[f"l{pos}"] = c
        x = x + h
        if _has_ffn(cfg):
            x = _ffn(cfg, p, x, pos)
    return x, caches


def _block_decode(cfg: ModelConfig, bp, x: torch.Tensor, caches):
    new = {}
    for pos, _ in enumerate(cfg.pattern):
        p = bp[f"l{pos}"]
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        h, c = L.attention_decode(p["attn"], cfg, h, caches[f"l{pos}"],
                                  window=cfg.sliding_window)
        new[f"l{pos}"] = c
        x = x + h
        if _has_ffn(cfg):
            x = _ffn(cfg, p, x, pos)
    return x, new


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, s_max: int):
    """tokens: [B, S] -> (last-token logits [B, V], caches)."""
    check_supported(cfg)
    x = L.embed(params, cfg, tokens)
    per_block = []
    for i in range(cfg.n_blocks):
        x, c = _block_prefill(cfg, block_params(params, i), x, s_max)
        per_block.append(c)
    caches: Dict[str, KVCache] = {}
    for name in per_block[0]:
        cs = [c[name] for c in per_block]
        caches[name] = KVCache(k=torch.stack([c.k for c in cs]),
                               v=torch.stack([c.v for c in cs]),
                               length=cs[0].length)
    logits = L.unembed(params, cfg, x[:, -1:])
    return logits[:, 0], caches


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, caches):
    """token: [B] -> (logits [B, V], caches advanced by one position)."""
    check_supported(cfg)
    x = L.embed(params, cfg, token[:, None])
    for i in range(cfg.n_blocks):
        block_cache = {name: KVCache(k=c.k[i], v=c.v[i], length=c.length)
                       for name, c in caches.items()}
        x, _ = _block_decode(cfg, block_params(params, i), x, block_cache)
    new = {name: KVCache(k=c.k, v=c.v, length=c.length + 1)
           for name, c in caches.items()}
    logits = L.unembed(params, cfg, x)
    return logits[:, 0], new
