"""Core transformer layers in PyTorch (counterpart of ``repro.models.layers``).

Every function takes the parameter sub-tree (a dict of tensors under the
JAX package's names) and casts weights to the activation dtype at use, as
the JAX code does; a weight already in that dtype is not copied.  RMSNorm
and every full-sequence attention (prefill, the encoder, cross-attention)
go through the port's CUDA kernels (:mod:`..kernels.ops`); the dense
projections stay plain ``torch.matmul``, as the JAX package leaves them to
XLA, and so does single-token decode attention over the cache.

``tp`` (a ``parallel.tp.ModelAxis``, which a sharded step's
``Sharded.tp`` gives a tensor-parallel sublayer) means the weights are this
rank's ``model``-local part: attention on the local heads (K/V on the kv
heads they read), the MLP on its local columns, the embeddings on the
local vocab rows.  The replicated input enters through ``tp.enter`` and
the partial output leaves through ``tp.exit``, one sum over ``model``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .spec import ModelConfig, torch_dtype

NEG_INF = -1e30


# ----------------------------------------------------------------- RMSNorm
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last dim through the kernel, on a ``[T, D]`` view."""
    shape = x.shape
    y = ops.rmsnorm(x.reshape(-1, shape[-1]).contiguous(), scale, eps=eps)
    return y.reshape(shape)


# -------------------------------------------------------------------- RoPE
def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split rotation.  x: [..., S, H, Dh]; positions: [..., S]."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    ang = positions[..., :, None, None].float() * freqs   # [..., S, 1, Dh/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- Attention
class KVCache(NamedTuple):
    k: torch.Tensor      # [B, S_max, KV, Dh]
    v: torch.Tensor      # [B, S_max, KV, Dh]
    length: int          # current fill


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matmul."""
    D = w.shape[0]
    y = x @ w.to(x.dtype).reshape(D, -1)
    return y.reshape(*x.shape[:-1], *w.shape[1:])


def _out_proj(out: torch.Tensor, wo: torch.Tensor, tp=None) -> torch.Tensor:
    """einsum('bshk,hkd->bsd') as one matmul; with ``tp``, over the local
    heads, then summed over ``model``."""
    H, Dh, D = wo.shape
    y = out.reshape(*out.shape[:-2], H * Dh) @ wo.to(out.dtype).reshape(
        H * Dh, D)
    return y if tp is None else tp.exit(y)


def _kv_heads(cfg: ModelConfig, tp) -> Tuple[int, int]:
    """The first kv head that this rank's q heads read (head ``h`` reads
    ``h // (H / KV)``) and their count.  Each must serve as many local q
    heads, as the kernel's GQA map wants: so it is where ``model`` and
    ``n_kv_heads`` are powers of two."""
    lo, hi = tp.local_range(cfg.n_heads)
    kv = [h // (cfg.n_heads // cfg.n_kv_heads) for h in range(lo, hi)]
    n = kv[-1] - kv[0] + 1
    if len(kv) % n or any(k != kv[0] + j * n // len(kv)
                          for j, k in enumerate(kv)):
        raise NotImplementedError(
            f"{cfg.name}: q heads {lo}..{hi - 1} read kv heads {kv}, "
            f"not the same number each")
    return kv[0], n


def _kv_params(p, cfg: ModelConfig, tp):
    """``wk``, ``wv`` (and ``bk``, ``bv`` with ``qkv_bias``): as given,
    whole or ``model``-local.  Where the kv heads do not split over
    ``model`` they are replicated, and a rank takes the kv heads its q
    heads read (:func:`_kv_heads`); its gradient of them is then its heads'
    part only, so they go through ``tp.enter``."""
    ws = [p[n] for n in (("wk", "wv", "bk", "bv") if cfg.qkv_bias
                         else ("wk", "wv"))]
    if tp is None or ws[0].shape[-2] * tp.size == cfg.n_kv_heads:
        return ws
    first, n = _kv_heads(cfg, tp)
    return [w.narrow(-2, first, n) for w in tp.enter(*ws)]


def _project_qkv(p, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, rope: bool = True, tp=None):
    if tp is not None:
        x = tp.enter(x)
    wk, wv, *bkv = _kv_params(p, cfg, tp)
    q = _proj(x, p["wq"])
    k = _proj(x, wk)
    v = _proj(x, wv)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + bkv[0].to(x.dtype)
        v = v + bkv[1].to(x.dtype)
    if cfg.qk_norm:
        # one scale for every head: a rank's gradient is its heads' part
        qn, kn = ((p["q_norm"], p["k_norm"]) if tp is None
                  else tp.enter(p["q_norm"], p["k_norm"]))
        q = rmsnorm(q, qn, cfg.norm_eps)
        k = rmsnorm(k, kn, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _self_attention(p, cfg: ModelConfig, x: torch.Tensor, *, causal: bool,
                    rope: bool, window: int, tp=None):
    """Attention of ``x`` [B,S,D] over itself through the kernel; returns
    (out [B,S,D], k, v), k and v of the heads computed."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, cfg, x, positions, rope, tp)
    out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, window=window)
    return _out_proj(out, p["wo"], tp), k, v


def attention(p, cfg: ModelConfig, x: torch.Tensor, *, causal: bool = True,
              rope: bool = True, window: int = 0, tp=None) -> torch.Tensor:
    """Full-sequence attention (the whisper encoder: ``causal=False``, RoPE
    over frame positions).  x: [B,S,D]."""
    out, _, _ = _self_attention(p, cfg, x, causal=causal, rope=rope,
                                window=window, tp=tp)
    return out


def attention_prefill(p, cfg: ModelConfig, x: torch.Tensor, s_max: int, *,
                      window: int = 0, tp=None
                      ) -> Tuple[torch.Tensor, KVCache]:
    """Causal prefill (Sq == Sk, through the flash-attention kernel) that
    also returns a KV cache padded to ``s_max``: with ``tp``, of the local
    kv heads."""
    B, S, _ = x.shape
    out, k, v = _self_attention(p, cfg, x, causal=True, rope=True,
                                window=window, tp=tp)
    kc = k.new_zeros((B, s_max) + k.shape[2:])
    vc = v.new_zeros((B, s_max) + v.shape[2:])
    kc[:, :S] = k
    vc[:, :S] = v
    return out, KVCache(k=kc, v=vc, length=S)


def _sdpa_masked(q, k, v, valid: torch.Tensor) -> torch.Tensor:
    """GQA attention with f32 logits masked to -1e30 where ``valid`` is
    False; the softmax weights are cast back to ``v.dtype`` (as the JAX
    ``_sdpa`` does).  q: [B,Sq,H,Dh]; k,v: [B,Sk,KV,Dh]; valid: [Sk]."""
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, Dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    logits = logits * (1.0 / math.sqrt(Dh))
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(B, Sq, H, Dh)


def attention_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: KVCache, *,
                     window: int = 0) -> Tuple[torch.Tensor, KVCache]:
    """Single-token decode.  x: [B,1,D].

    Writes the new K/V row into ``cache`` at ``length`` *in place* (the JAX
    code returns an updated copy; updating in place keeps one cache alive),
    then attends over all ``S_max`` slots with ``j <= length`` (and ``j >
    length - window`` for a window > 0).
    """
    B = x.shape[0]
    pos = torch.full((B, 1), cache.length, dtype=torch.long, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, pos)
    cache.k[:, cache.length] = k[:, 0].to(cache.k.dtype)
    cache.v[:, cache.length] = v[:, 0].to(cache.v.dtype)
    j = torch.arange(cache.k.shape[1], device=x.device)
    valid = j <= cache.length
    if window > 0:
        valid &= j > cache.length - window
    out = _sdpa_masked(q, cache.k, cache.v, valid)
    out = _out_proj(out, p["wo"])
    return out, KVCache(k=cache.k, v=cache.v, length=cache.length + 1)


def cross_attention(p, cfg: ModelConfig, x: torch.Tensor,
                    enc_k: torch.Tensor, enc_v: torch.Tensor,
                    tp=None) -> torch.Tensor:
    """Decoder-to-encoder attention (whisper), through the kernel: no RoPE,
    no mask.  x: [B,S,D]; enc_k, enc_v: [B,F,KV,Dh] (:func:`encode_kv`'s,
    of the same heads) -> [B,S,D]."""
    if tp is not None:
        x = tp.enter(x)
    q = _proj(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    out = ops.flash_attention(q.contiguous(), enc_k.contiguous(),
                              enc_v.contiguous(), causal=False)
    return _out_proj(out, p["wo"], tp)


def encode_kv(p, cfg: ModelConfig, enc_out: torch.Tensor, tp=None):
    """Cross-attention K and V of the encoder states: [B,F,KV,Dh] each;
    with ``tp``, of the kv heads the local q heads read, and ``enc_out``
    must have gone through ``tp.enter`` (once for all the layers that read
    it: their gradients add up before the one sum over ``model``)."""
    wk, wv, *bkv = _kv_params(p, cfg, tp)
    k = _proj(enc_out, wk)
    v = _proj(enc_out, wv)
    if cfg.qkv_bias:
        k = k + bkv[0].to(enc_out.dtype)
        v = v + bkv[1].to(enc_out.dtype)
    return k, v


# -------------------------------------------------------------- SwiGLU MLP
def mlp(p, x: torch.Tensor, n_chunks: int = 1, tp=None) -> torch.Tensor:
    """Dense SwiGLU FFN.  With ``n_chunks`` > 1 (``cfg.ffn_chunks``, which
    the sharded serve step sets for a wide FFN) the hidden dim is cut into
    that many chunks whose outputs are summed in order, as the reference's
    chunked FFN sums them.  With ``tp``, the local columns (chunked), then
    the sum over ``model``."""
    if tp is not None:
        x = tp.enter(x)
    wg, wu, wo = (p[k].to(x.dtype) for k in ("wi_gate", "wi_up", "wo"))
    if n_chunks <= 1:
        out = (F.silu(x @ wg) * (x @ wu)) @ wo
    else:
        out = torch.zeros_like(x)
        for g, u, o in zip(wg.chunk(n_chunks, 1), wu.chunk(n_chunks, 1),
                           wo.chunk(n_chunks, 0)):
            out = out + (F.silu(x @ g) * (x @ u)) @ o
    return out if tp is None else tp.exit(out)


# ------------------------------------------------------------- Embeddings
def embed(params, cfg: ModelConfig, tokens: torch.Tensor,
          tp=None) -> torch.Tensor:
    """The token embeddings; with ``tp``, of the local vocab rows, summed
    over ``model``."""
    table = params["tok_embed"].to(torch_dtype(cfg.dtype))
    return table[tokens] if tp is None else tp.lookup(table, tokens)


def unembed(params, cfg: ModelConfig, x: torch.Tensor,
            tp=None) -> torch.Tensor:
    """The final norm, then the logits: with ``tp``, of the local vocab
    columns ``[..., V / model]``, never gathered."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if tp is not None:
        x = tp.enter(x)
    return x @ params["unembed"].to(x.dtype)
