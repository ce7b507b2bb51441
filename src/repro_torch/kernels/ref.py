"""Plain PyTorch versions of the port's kernels and of their backward
kernels.

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


def rmsnorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *,
                    eps: float = 1e-6):
    """Gradients (dx [T,D] in x.dtype, dw [D] in w.dtype) of
    :func:`rmsnorm_ref` given ``dy``, in f32: with ``r = rsqrt(mean(x^2) +
    eps)``, ``dx = w r dy - x r^3 mean(dy w x)`` and ``dw = sum_rows dy x
    r``."""
    xf, gf, wf = x.float(), dy.float(), w.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    dot = (gf * wf * xf).mean(dim=-1, keepdim=True)
    dx = wf * r * gf - xf * (r * r * r) * dot
    dw = (gf * xf * r).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,Sq,H,Dh]; k, v: [B,Sk,KV,Dh] -> [B,Sq,H,Dh] in q.dtype.

    The kernel's causal mask is ``kj <= qi`` with no ``Sk - Sq`` offset, so
    causal attention is only defined for ``Sq == Sk``; anything else raises.
    A ``window`` > 0 (causal only) also masks ``kj <= qi - window``, as
    ``repro.models.layers._causal_mask`` does.  Any head dim.
    """
    B, Sq, H, Dh = q.shape
    _, Sk, KV, _ = k.shape
    check_attention_shapes(q, k, v, causal, window)
    group = H // KV
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(Dh)
    qf = q.float().reshape(B, Sq, KV, group, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * sm_scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None]
        kj = torch.arange(Sk, device=q.device)[None, :]
        keep = kj <= qi
        if window > 0:
            keep &= kj > qi - window
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return o.reshape(B, Sq, H, Dh).to(q.dtype)


def _attention_keep(Sq: int, Sk: int, causal: bool, window: int, device):
    """[Sq, Sk] mask of the (query, key) pairs the kernel keeps, or None."""
    if not causal:
        return None
    qi = torch.arange(Sq, device=device)[:, None]
    kj = torch.arange(Sk, device=device)[None, :]
    keep = kj <= qi
    if window > 0:
        keep &= kj > qi - window
    return keep


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, *, causal: bool = True,
                            window: int = 0,
                            sm_scale: Optional[float] = None):
    """Gradients (dq, dk, dv) of :func:`flash_attention_ref` given its
    output ``o`` and the output's gradient ``do``, by FA2's formulas in f32:
    ``D = rowsum(do * o)``, ``P = exp(S scale - LSE)``, ``dv = P^T do``,
    ``dP = do v^T``, ``dS = P * (dP - D)``, ``dq = dS k scale``,
    ``dk = dS^T q scale``.  GQA sums dk and dv over each group's heads.
    Each is rounded once to its input's dtype."""
    B, Sq, H, Dh = q.shape
    _, Sk, KV, _ = k.shape
    check_attention_shapes(q, k, v, causal, window)
    G = H // KV
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(Dh)
    qf = q.float().reshape(B, Sq, KV, G, Dh)
    gf = do.float().reshape(B, Sq, KV, G, Dh)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * sm_scale
    keep = _attention_keep(Sq, Sk, causal, window, q.device)
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, -math.inf))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros_like(p))
    D = (gf * o.float().reshape(B, Sq, KV, G, Dh)).sum(-1)   # [b,q,k,g]
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, gf)
    dp = torch.einsum("bqkgd,bskd->bkgqs", gf, vf)
    ds = p * (dp - D.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * sm_scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * sm_scale
    return (dq.reshape(B, Sq, H, Dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def check_attention_shapes(q, k, v, causal: bool, window: int = 0) -> None:
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
    if window < 0 or (window > 0 and not causal):
        raise ValueError(f"flash_attention: a window ({window}) must be 0, "
                         f"or positive with causal=True")


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


def grouped_matmul_dw_ref(lhs: torch.Tensor, dout: torch.Tensor,
                          group_offsets: torch.Tensor, E: int) -> torch.Tensor:
    """dW [E,D,F] of :func:`grouped_matmul_ref` given ``dout`` [T,F], in
    f32: ``dW[e] = lhs[rows of e]^T dout[rows of e]``.  Rows no group covers
    add nothing; an expert with no rows gets zeros.  Rounded once to
    ``lhs.dtype``."""
    T, D = lhs.shape
    dw = torch.zeros((E, D, dout.shape[1]), dtype=torch.float32,
                     device=lhs.device)
    offs = [min(max(int(o), 0), T) for o in group_offsets.tolist()]
    lo = offs[0]
    for e in range(E):
        hi = max(lo, offs[e + 1])
        if hi > lo:
            dw[e] = lhs[lo:hi].float().T @ dout[lo:hi].float()
        lo = hi
    return dw.to(lhs.dtype)


def grouped_matmul_bwd_ref(lhs: torch.Tensor, rhs: torch.Tensor,
                           group_offsets: torch.Tensor, dout: torch.Tensor):
    """Gradients (dlhs [T,D], drhs [E,D,F]) of :func:`grouped_matmul_ref`
    given ``dout`` [T,F], in f32: ``dlhs[rows of e] = dout[rows] rhs[e]^T``
    (the forward on ``rhs`` transposed, so rows no group covers get zeros)
    and :func:`grouped_matmul_dw_ref`."""
    dlhs = grouped_matmul_ref(dout, rhs.transpose(1, 2), group_offsets)
    return dlhs, grouped_matmul_dw_ref(lhs, dout, group_offsets,
                                       rhs.shape[0]).to(rhs.dtype)


def expert_ffn_ref(p, recv: torch.Tensor,
                   recv_meta: torch.Tensor) -> torch.Tensor:
    """The EP block's local expert FFN as the reference writes it
    (``repro.models.moe.moe_block_ep``): a masked einsum over
    ``[E_loc, ep*C, D]``.  ``recv`` [ep, C, D], ``recv_meta`` [ep, C] the
    local expert id + 1 (0: an empty slot, which comes out zero); ``p``
    holds the ``E_loc`` experts' ``wi_gate``, ``wi_up``, ``wo``.  The plain
    version of ``models.moe.ep_expert_ffn``'s three ``grouped_matmul``
    launches."""
    ep, C, D = recv.shape
    E_loc = p["wi_gate"].shape[0]
    rows = recv.reshape(ep * C, D)
    eid = recv_meta.reshape(-1).long() - 1                # -1: empty
    sel = (torch.nn.functional.one_hot(eid.clamp(min=0), E_loc)
           * (eid >= 0)[:, None]).to(recv.dtype)          # [ep*C, E_loc]
    buf = torch.einsum("te,td->etd", sel, rows)
    g = torch.einsum("etd,edf->etf", buf, p["wi_gate"].to(recv.dtype))
    u = torch.einsum("etd,edf->etf", buf, p["wi_up"].to(recv.dtype))
    h = torch.nn.functional.silu(g) * u
    out = torch.einsum("etf,efd->etd", h, p["wo"].to(recv.dtype))
    return torch.einsum("etd,te->td", out, sel).view(ep, C, D)


def chunk_cumsum(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive cumsum of f32 decays, summed in f64 and rounded once.

    Over a 256-step chunk ``a_cum`` reaches about -180, where one f32 ulp
    is 1.5e-5: two f32 scans in different orders would then disagree by
    more than the kernel's tolerance in ``exp(a_cum[q] - a_cum[k])``.  The
    f64 sum of f32 terms is exact for these ranges in any order, so the
    CUDA kernel (which scans in f64 too) and this path get the same f32
    ``a_cum``.
    """
    return torch.cumsum(a.double(), dim=dim).float()


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor):
    """Intra-chunk SSD terms, in f32.

    Two layouts, the same math:

    * the JAX kernel's, with ``G = batch*chunks*heads`` cells: x [G,Q,P];
      dt, a [G,Q]; B, C [G,Q,N] -> (y [G,Q,P], state [G,P,N]);
    * the model's, heads kept minor and B, C shared by the heads of a
      (batch, chunk): x [BC,Q,H,P]; dt, a [BC,Q,H]; B, C [BC,Q,N] ->
      (y [BC,Q,H,P], state [BC,H,P,N]).

    ``y[q] = sum_{k<=q} (C_q . B_k) exp(a_cum[q]-a_cum[k]) dt_k x[k]`` and
    ``state = sum_k exp(a_cum[-1]-a_cum[k]) dt_k x[k] B_k^T``.
    """
    flat = x.ndim == 3
    if flat:
        x, dt, a = x[:, :, None], dt[..., None], a[..., None]
    check_ssd_shapes(x, dt, a, B, C)
    x, dt, B, C = x.float(), dt.float(), B.float(), C.float()
    Q = x.shape[1]
    cs = chunk_cumsum(a.float(), 1)                         # [BC,Q,H]
    diff = cs[:, :, None, :] - cs[:, None, :, :]            # [BC,Q,K,H]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(mask[None, :, :, None], diff,
                              torch.full_like(diff, -math.inf)))
    CB = torch.einsum("bqn,bkn->bqk", C, B)
    M = CB[..., None] * L * dt[:, None, :, :]               # [BC,Q,K,H]
    y = torch.einsum("bqkh,bkhp->bqhp", M, x)
    decay = torch.exp(cs[:, -1:] - cs)                      # [BC,Q,H]
    state = torch.einsum("bqh,bqhp,bqn->bhpn", decay * dt, x, B)
    if flat:
        return y[:, :, 0], state[:, 0]
    return y, state


def ssd_chunk_f64(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor):
    """:func:`ssd_chunk_ref` evaluated in f64, with the error bound an f32
    evaluation of it must meet.

    Takes the layouts of :func:`ssd_chunk_ref` and the same f32 ``a_cum``
    (:func:`chunk_cumsum`, the kernel's contract).  Returns ``(y, state,
    y_bound, state_bound)``: the f64 terms and, per output, ``(N + Q + 32)
    * 2**-24`` times the sum of the absolute values of the products summed
    into it (``|C_qn B_kn| L_qk |dt_k x_kp|`` for y, ``|w_k x_kp B_kn|``
    for the state).  That is the worst case of f32 rounding for sums of
    ``N + Q`` products in any order (Higham's gamma_n), with 32 units of
    slack for ``exp`` and the f32 exponent ``a_cum[q] - a_cum[k]``; a wrong
    or missing term exceeds it, f32 rounding does not.
    """
    flat = x.ndim == 3
    if flat:
        x, dt, a = x[:, :, None], dt[..., None], a[..., None]
    check_ssd_shapes(x, dt, a, B, C)
    f64 = torch.float64
    cs = chunk_cumsum(a.float(), 1).to(f64)                 # [BC,Q,H]
    x, dt, B, C = (t.to(f64) for t in (x, dt, B, C))
    Q, N = x.shape[1], B.shape[-1]
    diff = cs[:, :, None, :] - cs[:, None, :, :]            # [BC,Q,K,H]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(mask[None, :, :, None], diff,
                              torch.full_like(diff, -math.inf)))
    CB = torch.einsum("bqn,bkn->bqk", C, B)
    CBabs = torch.einsum("bqn,bkn->bqk", C.abs(), B.abs())
    y = torch.einsum("bqkh,bkhp->bqhp", CB[..., None] * L * dt[:, None], x)
    y_mag = torch.einsum("bqkh,bkhp->bqhp",
                         CBabs[..., None] * L * dt.abs()[:, None], x.abs())
    w = torch.exp(cs[:, -1:] - cs) * dt                     # [BC,Q,H]
    state = torch.einsum("bqh,bqhp,bqn->bhpn", w, x, B)
    s_mag = torch.einsum("bqh,bqhp,bqn->bhpn", w.abs(), x.abs(), B.abs())
    gamma = (N + Q + 32) * 2.0 ** -24
    y_bound, s_bound = gamma * y_mag, gamma * s_mag
    if flat:
        return y[:, :, 0], state[:, 0], y_bound[:, :, 0], s_bound[:, 0]
    return y, state, y_bound, s_bound


def check_ssd_shapes(x, dt, a, B, C) -> None:
    """Reject what the ssd_chunk kernel does not take (model layout)."""
    if x.ndim != 4:
        raise ValueError(f"ssd_chunk: x [G,Q,P] or [BC,Q,H,P] expected, got "
                         f"{tuple(x.shape)}")
    BC, Q, H, P = x.shape
    if (dt.shape != (BC, Q, H) or a.shape != (BC, Q, H) or B.ndim != 3
            or B.shape[:2] != (BC, Q) or C.shape != B.shape or Q == 0):
        raise ValueError(f"ssd_chunk: incompatible x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
