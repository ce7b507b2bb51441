"""Whisper-style encoder-decoder in PyTorch (counterpart of
``repro.models.encdec``): ``encode``, ``forward`` and ``loss_fn`` for
training, ``prefill`` and ``decode_step`` for serving.

As in the JAX package the audio frontend is a stub: ``enc_embeds``
[B, F, D] (precomputed frame embeddings) enter the encoder directly.  The
encoder is bidirectional attention with RoPE over frame positions; the
decoder is causal self-attention, then cross-attention to the encoder
output, then the SwiGLU FFN.  Parameters keep the JAX tree: ``enc`` and
``dec`` hold every leaf stacked over their layers, ``enc_norm`` ends the
encoder.  Prefill computes each decoder layer's cross-attention K/V once
and keeps them, stacked, for every decode step.  With ``cfg.remat`` each
encoder and decoder block runs under ``torch.utils.checkpoint`` when grad
is enabled, as JAX checkpoints each scanned block.  A sharded step's
``sharded`` (``parallel.fsdp.Sharded``) gathers each block's weights inside
its remat, and each sublayer (``enc/attn``, ``dec/attn``, ``dec/xattn``,
the MLPs, the embeddings) that ``sharded.tp`` names computes
tensor-parallel on its ``model``-local weights, ending in one sum over
``model``; the loss is :func:`.transformer.lm_nll`'s vocab-parallel one.
Prefill cuts each layer's caches to this rank's shard as it makes them,
and decode computes its self- and cross-attention on their head_dim
shards in place, as in :mod:`.transformer`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import layers as L
from .layers import KVCache
from .spec import ModelConfig, torch_dtype
from .transformer import (layer_slice, lm_nll, remat, seq_of, tp_of,
                          unbind_layers)


class EncDecCaches(NamedTuple):
    self_kv: KVCache          # stacked over decoder layers: [Ld,B,S_max,KV,Dh]
    cross_k: torch.Tensor     # [Ld, B, F, KV, Dh]
    cross_v: torch.Tensor


def _weights(bp, name: str, sharded):
    return bp if sharded is None else sharded.gather(bp, name)


def encode(cfg: ModelConfig, params, enc_embeds: torch.Tensor,
           sharded=None) -> torch.Tensor:
    """enc_embeds [B, F, D] (the stub frontend's output) -> encoder states."""
    if enc_embeds.ndim != 3 or enc_embeds.shape[-1] != cfg.d_model:
        raise ValueError(f"{cfg.name}: enc_embeds [B, F, {cfg.d_model}] "
                         f"expected, got {list(enc_embeds.shape)}")
    x = enc_embeds.to(torch_dtype(cfg.dtype))
    for bp in unbind_layers(params["enc"]):
        x = remat(cfg, _enc_block, cfg, bp, x, sharded)
    return L.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _enc_block(cfg: ModelConfig, bp, x: torch.Tensor,
               sharded=None) -> torch.Tensor:
    bp = _weights(bp, "enc", sharded)
    h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
    x = x + L.attention(bp["attn"], cfg, h, causal=False,
                        tp=tp_of(sharded, "enc/attn"))
    h = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
    return x + L.mlp(bp["mlp"], h, tp=tp_of(sharded, "enc/mlp"))


def _cross_input(enc: torch.Tensor, sharded) -> torch.Tensor:
    """The encoder states as every decoder layer's cross-attention reads
    them: through ``tp.enter`` once when that attention is
    tensor-parallel (``L.encode_kv``)."""
    xtp = tp_of(sharded, "dec/xattn")
    return enc if xtp is None else xtp.enter(enc)


def _dec_train_block(cfg: ModelConfig, bp, x: torch.Tensor,
                     enc: torch.Tensor, sharded=None) -> torch.Tensor:
    """One decoder layer over the whole sequence (training): causal
    self-attention, cross-attention to ``enc`` (:func:`_cross_input`'s),
    the FFN."""
    bp = _weights(bp, "dec", sharded)
    xtp = tp_of(sharded, "dec/xattn")
    enc_k, enc_v = L.encode_kv(bp["xattn"], cfg, enc, xtp)
    h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
    x = x + L.attention(bp["attn"], cfg, h, causal=True,
                        tp=tp_of(sharded, "dec/attn"))
    h = L.rmsnorm(x, bp["ln_x"], cfg.norm_eps)
    x = x + L.cross_attention(bp["xattn"], cfg, h, enc_k, enc_v, xtp)
    h = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
    return x + L.mlp(bp["mlp"], h, tp=tp_of(sharded, "dec/mlp"))


def forward(cfg: ModelConfig, params, tokens: torch.Tensor,
            enc_embeds: torch.Tensor, sharded=None):
    """Training forward: tokens [B, S], enc_embeds [B, F, D] -> (logits
    [B, S, V], aux 0)."""
    enc = _cross_input(encode(cfg, params, enc_embeds, sharded), sharded)
    x = L.embed(params, cfg, tokens, tp_of(sharded, "tok_embed"))
    for bp in unbind_layers(params["dec"]):
        x = remat(cfg, _dec_train_block, cfg, bp, x, enc, sharded)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.unembed(params, cfg, x, tp_of(sharded, "unembed")), aux


def loss_fn(cfg: ModelConfig, params, batch, sharded=None):
    """batch ``inputs``, ``targets`` [B, S], ``enc_embeds`` (+ ``mask``)
    -> (nll, {"nll", "aux", "tokens"}): no aux term."""
    logits, aux = forward(cfg, params, batch["inputs"], batch["enc_embeds"],
                          sharded)
    nll, n = lm_nll(logits, batch, tp_of(sharded, "unembed"))
    return nll, {"nll": nll, "aux": aux, "tokens": n}


def _dec_block(cfg: ModelConfig, bp, x: torch.Tensor, enc_k: torch.Tensor,
               enc_v: torch.Tensor, cache=None, s_max=None, sharded=None):
    """One decoder layer: prefill when ``cache`` is None (a cache padded to
    ``s_max`` comes back), else one decode step that writes into
    ``cache`` in place."""
    h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
    tp = tp_of(sharded, "dec/attn")
    if cache is None:
        h, cache = L.attention_prefill(bp["attn"], cfg, h, s_max, tp=tp)
        seq = None
    else:
        h, cache = L.attention_decode(bp["attn"], cfg, h, cache, tp=tp,
                                      seq=seq_of(sharded, "self_kv"))
        seq = seq_of(sharded, "cross_k")
    x = x + h
    h = L.rmsnorm(x, bp["ln_x"], cfg.norm_eps)
    x = x + L.cross_attention(bp["xattn"], cfg, h, enc_k, enc_v,
                              tp_of(sharded, "dec/xattn"), seq)
    h = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
    return x + L.mlp(bp["mlp"], h, tp=tp_of(sharded, "dec/mlp")), cache


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor,
            enc_embeds: torch.Tensor, s_max: int, sharded=None):
    """tokens [B, S], enc_embeds [B, F, D] -> (last-token logits [B, V],
    :class:`EncDecCaches`)."""
    enc = _cross_input(encode(cfg, params, enc_embeds, sharded), sharded)
    x = L.embed(params, cfg, tokens, tp_of(sharded, "tok_embed"))
    # each layer's cross K/V (this rank's shard of them) go straight into
    # the stacked buffers that decode reads, so they are never held twice
    kvs = []
    for i in range(cfg.n_layers):
        bp = _weights(layer_slice(params["dec"], i), "dec", sharded)
        xtp = tp_of(sharded, "dec/xattn")
        ck, cv = L.encode_kv(bp["xattn"], cfg, enc, xtp)
        x, kv = _dec_block(cfg, bp, x, ck, cv, s_max=s_max, sharded=sharded)
        if sharded is not None:
            ck, cv = L.kv_shard(xtp, ck), L.kv_shard(xtp, cv)
            ck, cv = (sharded.cache_cut(ck, "cross_k", xtp is not None),
                      sharded.cache_cut(cv, "cross_v", xtp is not None))
            kv = sharded.cache_cut(kv, "self_kv",
                                   tp_of(sharded, "dec/attn") is not None)
        if i == 0:
            cross_k = enc.new_empty((cfg.n_layers, *ck.shape))
            cross_v = enc.new_empty((cfg.n_layers, *cv.shape))
        cross_k[i], cross_v[i] = ck, cv
        kvs.append(kv)
    logits = L.unembed(params, cfg, x[:, -1:], tp_of(sharded, "unembed"))
    self_kv = KVCache(k=torch.stack([c.k for c in kvs]),
                      v=torch.stack([c.v for c in kvs]),
                      length=kvs[0].length)
    return logits[:, 0], EncDecCaches(self_kv=self_kv, cross_k=cross_k,
                                      cross_v=cross_v)


def decode_step(cfg: ModelConfig, params, token: torch.Tensor,
                caches: EncDecCaches, sharded=None):
    """token [B] -> (logits [B, V], caches advanced by one position; the
    self-attention caches are written in place)."""
    x = L.embed(params, cfg, token[:, None], tp_of(sharded, "tok_embed"))
    kv = caches.self_kv
    for i in range(cfg.n_layers):
        bp = _weights(layer_slice(params["dec"], i), "dec", sharded)
        self_kv = KVCache(k=kv.k[i], v=kv.v[i], length=kv.length)
        x, _ = _dec_block(cfg, bp, x, caches.cross_k[i], caches.cross_v[i],
                          cache=self_kv, sharded=sharded)
    logits = L.unembed(params, cfg, x, tp_of(sharded, "unembed"))
    return logits[:, 0], caches._replace(
        self_kv=KVCache(k=kv.k, v=kv.v, length=kv.length + 1))
