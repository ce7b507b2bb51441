"""Shared smoke-config reduction: same family, tiny dimensions.

A copy of ``repro.configs._smoke.reduce_config``.
"""
from __future__ import annotations

from ..models.spec import ModelConfig


def reduce_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    period = cfg.block_size
    kw = dict(
        n_layers=period * 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=(128 if cfg.d_ff > 0 else 0),
        vocab_size=256,
        n_experts=(8 if cfg.n_experts > 0 else 0),
        top_k=(2 if cfg.n_experts > 0 else 0),
        d_ff_expert=(64 if cfg.n_experts > 0 else 0),
        ssm_state=(16 if cfg.ssm_state > 0 else 0),
        ssm_head_dim=8,
        ssm_chunk=16,
        n_enc_layers=(2 if cfg.is_encoder_decoder else 0),
        enc_frames=(32 if cfg.is_encoder_decoder else cfg.enc_frames),
        n_img_tokens=(8 if cfg.n_img_tokens > 0 else 0),
        sliding_window=(16 if cfg.sliding_window > 0 else 0),
        name=cfg.name + "-smoke",
    )
    kw.update(overrides)
    return cfg.replace(**kw)
