"""Mamba2 SSD layer in PyTorch (counterpart of ``repro.models.ssd``).

Per head, with scalar decay ``a_t = -exp(A_log) * dt_t``::

    S_t = exp(a_t) S_{t-1} + dt_t x_t B_t^T        (state [P, N])
    y_t = C_t S_t + D x_t

Prefill runs the chunked algorithm through :func:`..kernels.ops.ssd_scan`
(the ``ssd_chunk`` CUDA kernel within chunks, the recurrence across them);
decode runs one step of the recurrence in plain torch.  ``dt``, ``A_log``,
``D`` and the state stay f32 as in the JAX code; the gated norm goes through
the rmsnorm kernel.

The JAX ``_core`` has a second branch for ``ssm_scan_groups > 1``: it runs
the heads in groups so that a sharded model gathers one group's weights at a
time.  Its math is the one-group math, which one card needs no other way
to run, so the port runs the one-group branch for every config.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import rmsnorm
from .spec import ModelConfig, torch_dtype


class SSMCache(NamedTuple):
    conv: torch.Tensor   # [B, K-1, d_inner + 2N] raw conv inputs (x|B|C)
    state: torch.Tensor  # [B, H, P, N] SSM state, f32


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_inner // P
    N = cfg.ssm_state
    return d_inner, H, P, N


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def _proj_streams(p, x: torch.Tensor):
    """x: [B,S,D] -> (z, xs_raw, B_raw, C_raw, dt_raw) pre-conv streams."""
    return (_mm(x, p["z_proj"]), _mm(x, p["x_proj"]), _mm(x, p["b_proj"]),
            _mm(x, p["c_proj"]), _mm(x, p["dt_proj"]))


def _conv1d(seq: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
            prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal depthwise conv + SiLU.  seq: [B,S,C]; w: [K,C]; prev [B,K-1,C]."""
    K = w.shape[0]
    S = seq.shape[1]
    if prev is None:
        pad = seq.new_zeros((seq.shape[0], K - 1, seq.shape[2]))
    else:
        pad = prev.to(seq.dtype)
    xp = torch.cat([pad, seq], dim=1)
    wc = w.to(seq.dtype)
    out = xp[:, 0:S] * wc[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * wc[i]
    return F.silu(out + bias.to(seq.dtype))


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD scan.  x:[b,S,H,P] dt:[b,S,H] A:[H] B,C:[b,S,N] (single group).

    Returns y [b,S,H,P] and final state [b,H,P,N], both f32.
    """
    return ops.ssd_scan(x, dt, A, B, C, chunk=chunk)


def _core(p, cfg: ModelConfig, x: torch.Tensor, want_cache: bool):
    d_inner, H, P, N = ssm_dims(cfg)
    b, S, _ = x.shape
    f32 = torch.float32
    z, xs_raw, Br, Cr, dtr = _proj_streams(p, x)
    Bs = _conv1d(Br, p["conv_b"], p["conv_b_b"])
    Cs = _conv1d(Cr, p["conv_c"], p["conv_c_b"])
    dt = F.softplus(dtr.to(f32) + p["dt_bias"].to(f32))
    xs = _conv1d(xs_raw, p["conv_x"], p["conv_x_b"])
    xh = xs.reshape(b, S, H, P)
    y, state = ssd_chunked(xh, dt, p["A_log"], Bs, Cs, cfg.ssm_chunk)
    y = y + p["D"].to(f32)[None, None, :, None] * xh.to(f32)
    y = y.reshape(b, S, d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = _mm(y, p["out_proj"])
    if not want_cache:
        return out, None
    K = cfg.ssm_conv
    raw = torch.cat([xs_raw, Br, Cr], dim=-1)
    if S < K - 1:
        tail = F.pad(raw, (0, 0, K - 1 - S, 0))
    else:
        tail = raw[:, S - (K - 1):]
    cache = SSMCache(conv=tail.to(torch_dtype(cfg.dtype)).contiguous(),
                     state=state.to(f32))
    return out, cache


def ssm_layer(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba2 layer.  x: [B,S,D] -> [B,S,D]."""
    out, _ = _core(p, cfg, x, want_cache=False)
    return out


def ssm_prefill(p, cfg: ModelConfig, x: torch.Tensor):
    """Like :func:`ssm_layer` but also returns the decode cache."""
    return _core(p, cfg, x, want_cache=True)


def ssm_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: SSMCache):
    """Single-token decode.  x: [B,1,D].

    Advances ``cache`` *in place* (the JAX code returns a new one; updating
    in place keeps one state alive) and returns it with the output.
    """
    d_inner, H, P, N = ssm_dims(cfg)
    b = x.shape[0]
    K = cfg.ssm_conv
    f32 = torch.float32
    z, xs_raw, B_raw, C_raw, dt_raw = _proj_streams(p, x)
    raw = torch.cat([xs_raw, B_raw, C_raw], dim=-1)           # [B,1,di+2N]
    conv_in = torch.cat([cache.conv.to(x.dtype), raw], dim=1)  # [B,K,di+2N]

    def one(lo, hi, w, bias):
        wc = w.to(x.dtype)
        o = conv_in[:, 0:1, lo:hi] * wc[0]
        for i in range(1, K):
            o = o + conv_in[:, i:i + 1, lo:hi] * wc[i]
        return F.silu(o + bias.to(x.dtype))

    xs = one(0, d_inner, p["conv_x"], p["conv_x_b"])
    Bs = one(d_inner, d_inner + N, p["conv_b"], p["conv_b_b"])
    Cs = one(d_inner + N, d_inner + 2 * N, p["conv_c"], p["conv_c_b"])
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))[:, 0]  # [B,H]
    a = dt * (-torch.exp(p["A_log"].to(f32)))                     # [B,H]
    xh = xs.reshape(b, H, P).to(f32)
    Bf = Bs[:, 0].to(f32)                                         # [B,N]
    Cf = Cs[:, 0].to(f32)
    state = cache.state
    state.mul_(torch.exp(a)[..., None, None])
    state.add_((dt[..., None] * xh)[..., None] * Bf[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", Cf, state) \
        + p["D"].to(f32)[None, :, None] * xh
    y = y.reshape(b, 1, d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = _mm(y, p["out_proj"])
    cache.conv.copy_(conv_in[:, 1:])
    return out, cache
