"""Shape-only stand-ins for the step builders' inputs and state
(counterpart of ``repro.launch.specs``): tensors on the meta device, which
have shapes and dtypes and no storage.

``batch_specs`` is a train or prefill batch, ``cache_specs_shapes`` the
decode caches of a shape cell (``s_max = seq_len + DECODE_MARGIN``), and
``state_shapes`` the params, their logical axes and the optimizer state.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.shapes import ShapeSpec
from ..models import api
from ..models.encdec import EncDecCaches
from ..models.layers import KVCache
from ..models.spec import ModelConfig, torch_dtype
from ..models.ssd import SSMCache, ssm_dims

DECODE_MARGIN = 128  # cache headroom beyond the prefilled seq_len
META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """A train or prefill batch: token ids and targets [B, text] int32,
    plus ``img_embeds`` or ``enc_embeds`` f32 (the stub frontends)."""
    B = shape.global_batch
    text = shape.seq_len - cfg.n_img_tokens
    out = {"inputs": _meta((B, text), torch.int32),
           "targets": _meta((B, text), torch.int32)}
    if cfg.n_img_tokens > 0:
        out["img_embeds"] = _meta((B, cfg.n_img_tokens, cfg.d_model),
                                  torch.float32)
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = _meta((B, cfg.enc_frames, cfg.d_model),
                                  torch.float32)
    return out


def empty_caches(cfg: ModelConfig, batch: int, s_max: int, device=META):
    """The decode caches that ``api.prefill`` returns, zero-filled (shapes
    only on the meta device): ``{"l{pos}": KVCache | SSMCache}`` stacked
    over the blocks, or :class:`EncDecCaches`."""
    dt = torch_dtype(cfg.dtype)

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    kv = (batch, s_max, cfg.n_kv_heads, cfg.d_head)
    if cfg.is_encoder_decoder:
        L = cfg.n_layers
        cross = (L, batch, cfg.enc_frames, cfg.n_kv_heads, cfg.d_head)
        return EncDecCaches(
            self_kv=KVCache(k=zeros((L, *kv)), v=zeros((L, *kv)), length=0),
            cross_k=zeros(cross), cross_v=zeros(cross))
    nb = cfg.n_blocks
    caches = {}
    for pos, kind in enumerate(cfg.pattern):
        if kind == "attn":
            caches[f"l{pos}"] = KVCache(k=zeros((nb, *kv)),
                                        v=zeros((nb, *kv)), length=0)
        else:
            d_inner, H, P, N = ssm_dims(cfg)
            caches[f"l{pos}"] = SSMCache(
                conv=zeros((nb, batch, cfg.ssm_conv - 1, d_inner + 2 * N)),
                state=zeros((nb, batch, H, P, N), torch.float32))
    return caches


def cache_specs_shapes(cfg: ModelConfig, shape: ShapeSpec):
    """The decode caches of a shape cell, on the meta device."""
    return empty_caches(cfg, shape.global_batch,
                        shape.seq_len + DECODE_MARGIN)


def state_shapes(cfg: ModelConfig, optimizer=None):
    """(params, logical axes, optimizer state or None): the tensors on the
    meta device, the axes from ``api.param_specs``."""
    params = api.init(cfg, torch.Generator(), META)
    opt = optimizer.init(params) if optimizer is not None else None
    return params, api.param_specs(cfg), opt
