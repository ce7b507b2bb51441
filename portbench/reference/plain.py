"""Plain PyTorch pieces that the reference models share.

Everything here computes in float32 on whatever device its operands are
on, with no kernel of the program under test: this package imports
nothing of ``repro_torch``.  ``PRECISIONS`` names how a reference rounds
the operands of its matrix products: ``float32`` leaves them as they are
(the reference), ``fp8`` rounds every weight that the program serves in
bfloat16 and every activation that enters a matrix product to float8
e4m3, one scale a tensor (the control: the step below bfloat16).
"""
from __future__ import annotations

import math

import torch

FP8_MAX = 448.0          # the largest finite float8 e4m3fn


def exact(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the whole tensor
    (its largest magnitude onto the format's largest), back in f32."""
    t = t.float()
    amax = t.abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


PRECISIONS = {"float32": exact, "fp8": fp8}


def set_exact_matmul() -> None:
    """f32 products in f32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * w over the last dim, in f32."""
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x [B, S, heads, Dh] at positions 0..S-1, the
    half-split form: the first half of each head pairs with the second."""
    S, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, device=x.device,
                                       dtype=torch.float64) / dh)
    ang = torch.arange(S, device=x.device, dtype=torch.float64)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q8) -> torch.Tensor:
    """Causal attention with grouped K/V heads: q [B,S,H,Dh], k and v
    [B,S,KV,Dh]; query head h reads K/V head h // (H / KV).  Scores and
    softmax in f32 at scale 1/sqrt(Dh); ``q8`` rounds the operands of
    both products.  -> [B,S,H,Dh]."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    qg = q8(q).reshape(B, S, KV, H // KV, dh).permute(0, 2, 3, 1, 4)
    kt = q8(k).permute(0, 2, 3, 1)[:, :, None]              # [B,KV,1,Dh,S]
    s = (qg @ kt) * (1.0 / math.sqrt(dh))                   # [B,KV,G,S,S]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = q8(p) @ q8(v).permute(0, 2, 1, 3)[:, :, None]       # [B,KV,G,S,Dh]
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, dh)


def causal_conv_silu(seq: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv1d over time, zeros before the first step,
    then SiLU.  seq [B,S,C]; w [K,C] (tap K-1 on the current step);
    bias [C]."""
    K, S = w.shape[0], seq.shape[1]
    pad = torch.nn.functional.pad(seq, (0, 0, K - 1, 0))
    out = bias.float().expand_as(seq).clone()
    for i in range(K):
        out = out + pad[:, i:i + S] * w[i].float()
    return torch.nn.functional.silu(out)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int):
    """The state-space recurrence, per head h with a scalar decay
    ``a_t = A_h dt_t``::

        S_t = exp(a_t) S_{t-1} + dt_t x_t B_t^T,   y_t = C_t . S_t

    computed by chunks of ``chunk`` steps: within a chunk the quadratic
    form, across chunks the state.  x [b,S,H,P], dt [b,S,H], A [H], B and
    C [b,S,N] (one group) -> (y [b,S,H,P], the final state [b,H,P,N]), f32.
    The decays' running sums are taken in f64."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = chunk
    pad = (-S) % Q
    if pad:
        # padded steps have dt 0: no decay, nothing added, no output kept
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    nc = (S + pad) // Q
    x = x.reshape(b, nc, Q, H, P).float()
    dt = dt.reshape(b, nc, Q, H).float()
    B = B.reshape(b, nc, Q, N).float()
    C = C.reshape(b, nc, Q, N).float()
    a = dt.double() * A.double()                             # [b,nc,Q,H]
    acs = torch.cumsum(a, dim=2)
    mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = (acs[:, :, :, None] - acs[:, :, None, :])          # [b,nc,t,s,H]
    L = torch.exp(seg.masked_fill(~mask[None, None, :, :, None],
                                  float("-inf"))).float()
    CB = C @ B.transpose(-1, -2)                             # [b,nc,t,s]
    M = (CB[..., None] * L * dt[:, :, None]).permute(0, 1, 4, 2, 3)
    y = (M @ x.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)  # [b,nc,Q,H,P]
    # each chunk's own contribution to the state at its end
    last = acs[:, :, -1:]                                    # [b,nc,1,H]
    wdec = (torch.exp(last - acs).float() * dt)              # [b,nc,Q,H]
    xw = (wdec[..., None] * x).permute(0, 1, 3, 4, 2)        # [b,nc,H,P,Q]
    states = (xw.reshape(b, nc, H * P, Q) @ B).reshape(b, nc, H, P, N)
    g = torch.exp(last[:, :, 0]).float()                     # [b,nc,H]
    state = torch.zeros(b, H, P, N, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = g[:, c, :, None, None] * state + states[:, c]
    prev = torch.stack(entering, dim=1)                      # [b,nc,H,P,N]
    y_in = (C @ prev.reshape(b, nc, H * P, N).transpose(-1, -2)
            ).reshape(b, nc, Q, H, P)
    y = y + y_in * torch.exp(acs).float()[..., None]
    return y.reshape(b, nc * Q, H, P)[:, :S], state
