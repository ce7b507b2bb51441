"""Plain PyTorch versions of the port's kernels.

Each computes what its CUDA kernel computes, by the kernel's contract:
the CPU tests hold these against the JAX package's kernels, and
``chip_smoke.py`` holds the CUDA kernels against these on the card.
Arithmetic is f32 and the result is rounded once to the input dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, *,
                eps: float = 1e-6) -> torch.Tensor:
    """x: [T, D]; w: [D] -> [T, D] in x.dtype."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,Sq,H,Dh]; k, v: [B,Sk,KV,Dh] -> [B,Sq,H,Dh] in q.dtype.

    The kernel's causal mask is ``kj <= qi`` with no ``Sk - Sq`` offset, so
    causal attention is only defined for ``Sq == Sk``; anything else raises.
    """
    B, Sq, H, Dh = q.shape
    _, Sk, KV, _ = k.shape
    check_attention_shapes(q, k, v, causal)
    group = H // KV
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(Dh)
    qf = q.float().reshape(B, Sq, KV, group, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * sm_scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None]
        kj = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(kj <= qi, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return o.reshape(B, Sq, H, Dh).to(q.dtype)


def check_attention_shapes(q, k, v, causal: bool) -> None:
    """Reject what the flash-attention kernel does not take."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q [B,Sq,H,Dh], k/v [B,Sk,KV,Dh] "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, Dh = q.shape
    Bk, Sk, KV, Dhk = k.shape
    if Bk != B or Dhk != Dh or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: incompatible q {tuple(q.shape)} "
                         f"and k {tuple(k.shape)}")
    if causal and Sq != Sk:
        raise ValueError(
            f"flash_attention: causal attention needs Sq == Sk (got Sq={Sq}, "
            f"Sk={Sk}); the kernel masks kj <= qi with no Sk-Sq offset")


def grouped_matmul_ref(lhs: torch.Tensor, rhs: torch.Tensor,
                       group_offsets: torch.Tensor) -> torch.Tensor:
    """lhs: [T,D] sorted by group; rhs: [E,D,F]; offsets: [E+1] -> [T,F].

    Rows that no group covers come out exactly zero (the kernel's contract,
    not the clip-to-last-expert of ``repro.kernels.ref``).
    """
    T = lhs.shape[0]
    E, _, F = rhs.shape
    out = torch.zeros((T, F), dtype=lhs.dtype, device=lhs.device)
    offs = [min(max(int(o), 0), T) for o in group_offsets.tolist()]
    lo = offs[0]
    for e in range(E):
        hi = max(lo, offs[e + 1])
        if hi > lo:
            out[lo:hi] = (lhs[lo:hi].float() @ rhs[e].float()).to(lhs.dtype)
        lo = hi
    return out
