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
time.  Its math is the one-group math, so the port runs the one-group
branch for every config; a sharded step splits the heads over ``model``
instead, as the reference's rules shard ``ssm_inner``.

With ``tp`` (a ``parallel.tp.ModelAxis``: a sharded step whose rules put
``model`` on ``ssm_inner`` and each rank holds whole heads) the mixer
computes on its ``ssm_inner`` shard.  ``z_proj``, ``x_proj``, ``conv_x``,
``conv_x_b``, ``norm`` and ``out_proj`` arrive ``model``-local; the
replicated ``b_proj``, ``c_proj``, ``dt_proj``, B and C convs, ``dt_bias``,
``A_log`` and ``D`` are read whole but feed only the local heads, so they
go through ``tp.enter`` with the layer's input.  Train and prefill run the
conv on the local channels and ``ops.ssd_scan`` on the local H / m heads;
the gated norm runs over the whole ``d_inner`` (``tp.rmsnorm``, one sum of
each row over ``model``), ``out_proj`` on the local rows, then one
``tp.exit``.  The cache stays the reference's, replicated over ``model``:
prefill gathers the local heads' final state and the conv tail's x
channels (tagged ``"cache"``).  Decode gathers the new ``xs_raw`` row
(and takes ``conv_x``, ``conv_x_b`` whole), so every rank advances the
whole conv tail and state with the same inputs and the same bits; it
forms ``y`` for the local heads only.
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


# the leaves of a mixer that every rank reads whole for its local heads
_REPLICATED = ("b_proj", "c_proj", "dt_proj", "conv_b", "conv_b_b", "conv_c",
               "conv_c_b", "dt_bias", "A_log", "D")


def _enter(p, x: torch.Tensor, tp):
    """(x, p) with x and the replicated leaves through ``tp.enter`` (their
    gradients on a rank are its heads' part), or as given without ``tp``."""
    if tp is None:
        return x, p
    x, *leaves = tp.enter(x, *(p[k] for k in _REPLICATED))
    return x, {**p, **dict(zip(_REPLICATED, leaves))}


def _heads(cfg: ModelConfig, tp) -> Tuple[int, int]:
    """This rank's heads ``[lo, hi)``: all of them without ``tp``."""
    H = ssm_dims(cfg)[1]
    return (0, H) if tp is None else tp.local_range(H)


def _gated_norm(p, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor, tp):
    """rmsnorm(y * silu(z)) over the whole d_inner, then ``out_proj``
    (with ``tp``: the local columns, normed over ``model``, then the
    local rows, summed over ``model``)."""
    g = y * F.silu(z)
    if tp is None:
        return _mm(rmsnorm(g, p["norm"], cfg.norm_eps), p["out_proj"])
    return tp.exit(_mm(tp.rmsnorm(g, p["norm"], cfg.norm_eps),
                       p["out_proj"]))


def _core(p, cfg: ModelConfig, x: torch.Tensor, want_cache: bool, tp=None):
    _, _, P, N = ssm_dims(cfg)
    b, S, _ = x.shape
    f32 = torch.float32
    lo, hi = _heads(cfg, tp)
    x, p = _enter(p, x, tp)
    z, xs_raw, Br, Cr = (_mm(x, p[k]) for k in ("z_proj", "x_proj",
                                                 "b_proj", "c_proj"))
    dtr = _mm(x, p["dt_proj"].narrow(-1, lo, hi - lo))
    Bs = _conv1d(Br, p["conv_b"], p["conv_b_b"])
    Cs = _conv1d(Cr, p["conv_c"], p["conv_c_b"])
    dt = F.softplus(dtr.to(f32) + p["dt_bias"][lo:hi].to(f32))
    xs = _conv1d(xs_raw, p["conv_x"], p["conv_x_b"])
    xh = xs.reshape(b, S, hi - lo, P)
    y, state = ssd_chunked(xh, dt, p["A_log"][lo:hi], Bs, Cs, cfg.ssm_chunk)
    y = y + p["D"][lo:hi].to(f32)[None, None, :, None] * xh.to(f32)
    y = y.reshape(b, S, (hi - lo) * P).to(x.dtype)
    out = _gated_norm(p, cfg, y, z, tp)
    if not want_cache:
        return out, None
    K = cfg.ssm_conv

    def tail(t):
        return (F.pad(t, (0, 0, K - 1 - S, 0)) if S < K - 1
                else t[:, S - (K - 1):])

    xt = tail(xs_raw)
    if tp is not None:
        # the cache is replicated over model: the local x channels and
        # heads' state, gathered whole
        xt = tp.gather(xt, -1, tag="cache")
        state = tp.gather(state, 1, tag="cache")
    conv = torch.cat([xt, tail(Br), tail(Cr)], dim=-1)
    cache = SSMCache(conv=conv.to(torch_dtype(cfg.dtype)).contiguous(),
                     state=state.to(f32))
    return out, cache


def ssm_layer(p, cfg: ModelConfig, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Full-sequence Mamba2 layer.  x: [B,S,D] -> [B,S,D]; ``tp``: on the
    ``ssm_inner`` shard (module docstring)."""
    out, _ = _core(p, cfg, x, want_cache=False, tp=tp)
    return out


def ssm_prefill(p, cfg: ModelConfig, x: torch.Tensor, tp=None):
    """Like :func:`ssm_layer` but also returns the decode cache (whole over
    ``model``)."""
    return _core(p, cfg, x, want_cache=True, tp=tp)


def ssm_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: SSMCache,
               tp=None):
    """Single-token decode.  x: [B,1,D].

    Advances ``cache`` *in place* (the JAX code returns a new one; updating
    in place keeps one state alive) and returns it with the output.  With
    ``tp``: ``conv_x`` and ``conv_x_b`` whole, the new ``xs_raw`` row
    gathered over ``model``, the whole conv tail and state advanced, ``y``
    of the local heads (module docstring).
    """
    d_inner, H, P, N = ssm_dims(cfg)
    b = x.shape[0]
    K = cfg.ssm_conv
    f32 = torch.float32
    lo, hi = _heads(cfg, tp)
    z, xs_raw, B_raw, C_raw, dt_raw = _proj_streams(p, x)
    if tp is not None:
        xs_raw = tp.gather(xs_raw, -1)
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
    y = torch.einsum("bn,bhpn->bhp", Cf, state[:, lo:hi]) \
        + p["D"][lo:hi].to(f32)[None, :, None] * xh[:, lo:hi]
    y = y.reshape(b, 1, (hi - lo) * P).to(x.dtype)
    out = _gated_norm(p, cfg, y, z, tp)
    cache.conv.copy_(conv_in[:, 1:])
    return out, cache
