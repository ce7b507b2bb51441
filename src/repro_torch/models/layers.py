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

An attention's ``tp`` may be a ``parallel.tp.HeadDimAxis`` instead
(``tp.on_head_dim``): ``model`` cuts the K/V head_dim.  Decode then
computes on its head_dim shard of ``wk``, ``wv`` and the KV cache
(:func:`attention_decode`, :func:`cross_attention`): the new K row is
gathered whole for ``k_norm`` and RoPE, each rank's slice of q against its
slice of the cache gives partial logits that one all-reduce over
``model`` sums, and the weighted V slices are gathered back to whole heads;
no weight or cache crosses ``model``.  Prefill computes the K/V of every
kv head from whole ``wk``, ``wv``, attends on the local q heads and keeps
its slice of head_dim in the cache.  A cache whose sequence is cut over
the batch axes (``seq``, a ``parallel.tp.SeqShard``: long decode) merges
its softmax over them.
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
    """einsum('bshk,hkd->bsd') as one matmul; with ``tp`` on the local
    heads, over them, then summed over ``model``."""
    H, Dh, D = wo.shape
    y = out.reshape(*out.shape[:-2], H * Dh) @ wo.to(out.dtype).reshape(
        H * Dh, D)
    return y if tp is None or not tp.heads else tp.exit(y)


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
    whole, ``model``-local or head_dim slices (``tp.on_head_dim``).  Where
    the kv heads do not split over ``model`` under the train rules they
    are replicated, and a rank takes the kv heads its q heads read
    (:func:`_kv_heads`); its gradient of them is then its heads' part
    only, so they go through ``tp.enter``."""
    ws = [p[n] for n in (("wk", "wv", "bk", "bv") if cfg.qkv_bias
                         else ("wk", "wv"))]
    if tp is None or tp.on_head_dim or \
            ws[0].shape[-2] * tp.size == cfg.n_kv_heads:
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


def _read_heads(cfg: ModelConfig, tp, k: torch.Tensor, v: torch.Tensor):
    """The kv heads of whole ``k``, ``v`` [B,S,KV,Dh] that the local q
    heads read, where ``tp`` (a ``HeadDimAxis`` of prefill) holds local
    heads; else ``k``, ``v``."""
    if tp is None or not tp.on_head_dim or not tp.heads:
        return k, v
    first, n = _kv_heads(cfg, tp)
    return k.narrow(2, first, n), v.narrow(2, first, n)


def _self_attention(p, cfg: ModelConfig, x: torch.Tensor, *, causal: bool,
                    rope: bool, window: int, tp=None):
    """Attention of ``x`` [B,S,D] over itself through the kernel; returns
    (out [B,S,D], k, v), k and v of the kv heads computed (every kv head
    for a ``HeadDimAxis``)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, cfg, x, positions, rope, tp)
    kr, vr = _read_heads(cfg, tp, k, v)
    out = ops.flash_attention(q.contiguous(), kr.contiguous(),
                              vr.contiguous(), causal=causal, window=window)
    return _out_proj(out, p["wo"], tp), k, v


def kv_shard(tp, t: torch.Tensor) -> torch.Tensor:
    """What of whole K/V ``t`` [..., Dh] this rank's cache keeps: its
    head_dim slice under a ``HeadDimAxis``, else all of it."""
    return t if tp is None or not tp.on_head_dim else tp.dh_slice(t)


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
    kv heads, or this rank's head_dim slice of every kv head."""
    B, S, _ = x.shape
    out, k, v = _self_attention(p, cfg, x, causal=True, rope=True,
                                window=window, tp=tp)
    k, v = kv_shard(tp, k), kv_shard(tp, v)
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


def _valid(n: int, start: int, length: int, window: int, device):
    """The cache slots ``start .. start + n - 1`` that a query at
    ``length`` reads: ``j <= length`` (and ``j > length - window``)."""
    j = torch.arange(start, start + n, device=device)
    valid = j <= length
    if window > 0:
        valid &= j > length - window
    return valid


def attention_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: KVCache, *,
                     window: int = 0, tp=None,
                     seq=None) -> Tuple[torch.Tensor, KVCache]:
    """Single-token decode.  x: [B,1,D].

    Writes the new K/V row into ``cache`` at ``length`` *in place* (the JAX
    code returns an updated copy; updating in place keeps one cache alive),
    then attends over all ``S_max`` slots with ``j <= length`` (and ``j >
    length - window`` for a window > 0).  With ``tp`` (a ``HeadDimAxis``)
    ``cache`` is this rank's head_dim shard, and with ``seq`` its block of
    the sequence (:func:`_decode_on_shard`).
    """
    if tp is not None or seq is not None:
        return _decode_on_shard(p, cfg, x, cache, window, tp, seq)
    B = x.shape[0]
    pos = torch.full((B, 1), cache.length, dtype=torch.long, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, pos)
    cache.k[:, cache.length] = k[:, 0].to(cache.k.dtype)
    cache.v[:, cache.length] = v[:, 0].to(cache.v.dtype)
    valid = _valid(cache.k.shape[1], 0, cache.length, window, x.device)
    out = _sdpa_masked(q, cache.k, cache.v, valid)
    out = _out_proj(out, p["wo"])
    return out, KVCache(k=cache.k, v=cache.v, length=cache.length + 1)


def _check_shard_axis(tp) -> None:
    if tp is None or not tp.on_head_dim or tp.kv_whole:
        raise NotImplementedError(
            "sharded decode attention computes on its head_dim shard: the "
            "K/V head_dim must carry model")


def _q_slice(p, cfg: ModelConfig, x: torch.Tensor, tp, pos=None):
    """The query of every head at this rank's head_dim slice, [B,1,H,
    Dh/m]: the local heads' (or every head's where ``wq`` is whole) with
    ``bq``, ``q_norm`` and RoPE (at ``pos``) on the whole head_dim, then
    gathered over ``model``."""
    q = _proj(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    if cfg.qk_norm and pos is not None:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    if pos is not None:
        q = apply_rope(q, pos, cfg.rope_theta)
    if tp.heads:
        q = tp.gather(q, dim=2)
    return tp.dh_slice(q).contiguous()


def _attend_shard(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, valid, tp, seq,
                  in_f32: bool = False) -> torch.Tensor:
    """One query a sequence against a head_dim shard of K, V [B,S,KV,
    Dh/m] (and a block of the sequence with ``seq``): the partial f32
    logits of this rank's slice, summed over ``model``, scaled, masked
    where ``valid`` [S] is False (None: nowhere) and softmaxed (merged over
    ``seq``'s axes: the row max, then the exponentials' sums and the
    weighted V in one sum); the output of the local heads (every head
    where ``wo`` is whole) at the whole head_dim, [B,1,H',Dh].  It
    computes as the unsharded route it stands for, so that at ``model`` 1
    it gives that route's bits: :func:`_sdpa_masked` (the products in the
    operands' dtype, the weights cast to V's), or with ``in_f32`` the
    attention kernel's plain version (f32 operands and weights)."""
    B, _, H, dl = q.shape
    KV = k.shape[2]
    dtype = v.dtype
    if in_f32:
        q, k, v = q.float(), k.float(), v.float()
    qg = q.reshape(B, 1, KV, H // KV, dl)
    logits = tp.sum(torch.einsum("bqkgd,bskd->bkgqs", qg, k).float())
    logits = logits * (1.0 / math.sqrt(cfg.d_head))
    if valid is not None:
        logits = torch.where(valid, logits,
                             torch.full_like(logits, NEG_INF))
    if seq is None:
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    else:
        e = torch.exp(logits - seq.max(torch.amax(logits, -1, keepdim=True)))
        o = torch.einsum("bkgqs,bskd->bqkgd", e.to(v.dtype), v).float()
        s, o = seq.sum(e.sum(-1).permute(0, 3, 1, 2)[..., None], o)
        out = o / s
    out = tp.gather(out.reshape(B, 1, H, dl).to(dtype))
    if tp.heads:
        lo, hi = tp.local_range(H)
        out = out[:, :, lo:hi]
    return out


def _decode_on_shard(p, cfg: ModelConfig, x: torch.Tensor, cache: KVCache,
                     window: int, tp, seq) -> Tuple[torch.Tensor, KVCache]:
    """:func:`attention_decode` on this rank's head_dim shard of the
    weights and cache [B,S,KV,Dh/m] (``tp``, a ``HeadDimAxis``), and with
    ``seq`` on its block of the sequence.  The new K row of this slice is
    gathered whole (one all-gather over ``model``) for ``k_norm`` and
    RoPE, whose half-split pairs lie on two ranks; V's slice needs
    neither.  The rank whose block holds ``length`` writes its slices in
    place."""
    _check_shard_axis(tp)
    B = x.shape[0]
    length = cache.length
    pos = torch.full((B, 1), length, dtype=torch.long, device=x.device)
    q = _q_slice(p, cfg, x, tp, pos)
    wk, wv, *bkv = _kv_params(p, cfg, tp)
    k, v = _proj(x, wk), _proj(x, wv)
    if cfg.qkv_bias:
        k = k + bkv[0].to(x.dtype)
        v = v + bkv[1].to(x.dtype)
    k = tp.gather(k)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    k = apply_rope(k, pos, cfg.rope_theta)
    S = cache.k.shape[1]
    start, slots = (0, S) if seq is None else (seq.index * S, seq.count * S)
    if length >= slots:
        raise IndexError(f"decode at {length} past the cache's {slots} "
                         f"slots")
    if start <= length < start + S:
        cache.k[:, length - start] = tp.dh_slice(k[:, 0]).to(cache.k.dtype)
        cache.v[:, length - start] = v[:, 0].to(cache.v.dtype)
    valid = _valid(S, start, length, window, x.device)
    out = _attend_shard(cfg, q, cache.k, cache.v, valid, tp, seq)
    out = _out_proj(out, p["wo"], tp)
    return out, KVCache(k=cache.k, v=cache.v, length=length + 1)


def cross_attention(p, cfg: ModelConfig, x: torch.Tensor,
                    enc_k: torch.Tensor, enc_v: torch.Tensor,
                    tp=None, seq=None) -> torch.Tensor:
    """Decoder-to-encoder attention (whisper), through the kernel: no RoPE,
    no mask.  x: [B,S,D]; enc_k, enc_v: [B,F,KV,Dh] (:func:`encode_kv`'s,
    of the same heads) -> [B,S,D].  Under a decode ``HeadDimAxis`` they are
    this rank's head_dim shard [B,F,KV,Dh/m] (and with ``seq`` its block of
    the frames), and one query a sequence attends as
    :func:`attention_decode` does, unmasked."""
    if tp is not None and tp.on_head_dim and not tp.kv_whole or \
            seq is not None:
        _check_shard_axis(tp)
        out = _attend_shard(cfg, _q_slice(p, cfg, x, tp), enc_k, enc_v,
                            None, tp, seq, in_f32=True)
        return _out_proj(out, p["wo"], tp)
    if tp is not None:
        x = tp.enter(x)
    q = _proj(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    enc_k, enc_v = _read_heads(cfg, tp, enc_k, enc_v)
    out = ops.flash_attention(q.contiguous(), enc_k.contiguous(),
                              enc_v.contiguous(), causal=False)
    return _out_proj(out, p["wo"], tp)


def encode_kv(p, cfg: ModelConfig, enc_out: torch.Tensor, tp=None):
    """Cross-attention K and V of the encoder states: [B,F,KV,Dh] each;
    with ``tp``, of the kv heads the local q heads read (every kv head
    under a ``HeadDimAxis``), and ``enc_out`` must have gone through
    ``tp.enter`` (once for all the layers that read it: their gradients
    add up before the one sum over ``model``)."""
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
