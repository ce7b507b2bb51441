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


def rmsnorm_part_ref(x: torch.Tensor) -> torch.Tensor:
    """x: [T, D] -> [T] f32: each row's sum of squares, the first half of
    a norm whose rows are split over ranks (their sum is the whole row's)."""
    xf = x.float()
    return (xf * xf).sum(dim=-1)


def rmsnorm_scale_ref(x: torch.Tensor, w: torch.Tensor, ss: torch.Tensor,
                      n: int, eps: float = 1e-6) -> torch.Tensor:
    """The second half: x [T, D] scaled by ``rsqrt(ss / n + eps)`` and
    ``w`` [D], in x.dtype, where ``ss`` [T] are the rows' sums of squares
    over all ``n`` columns.  With ``ss = rmsnorm_part_ref(x)`` and ``n =
    D`` it is :func:`rmsnorm_ref` (on the CPU its bits: a mean there is
    the sum divided by D)."""
    xf = x.float()
    y = xf * torch.rsqrt(ss[:, None] / n + eps)
    return (y * w.float()).to(x.dtype)


def rmsnorm_bwd_part_ref(x: torch.Tensor, w: torch.Tensor,
                         dy: torch.Tensor) -> torch.Tensor:
    """[T, 2] f32: each row's (sum x^2, sum w dy x) over its columns, the
    sums the backward of a split row takes over the ranks."""
    xf, gf, wf = x.float(), dy.float(), w.float()
    return torch.stack([(xf * xf).sum(dim=-1), (gf * wf * xf).sum(dim=-1)],
                       dim=-1)


def rmsnorm_bwd_scale_ref(x: torch.Tensor, w: torch.Tensor,
                          dy: torch.Tensor, sums: torch.Tensor, n: int,
                          eps: float = 1e-6):
    """(dx [T, D] in x.dtype, dw [D] f32) of the split row's columns from
    ``sums`` [T, 2], the rows' :func:`rmsnorm_bwd_part_ref` summed over all
    ``n`` columns: :func:`rmsnorm_bwd_ref`'s formula."""
    xf, gf, wf = x.float(), dy.float(), w.float()
    r = torch.rsqrt(sums[:, :1] / n + eps)
    dot = sums[:, 1:] / n
    dx = wf * r * gf - xf * (r * r * r) * dot
    return dx.to(x.dtype), (gf * xf * r).sum(dim=0)


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


def _ssd_bwd_terms(x, dt, cs, B, C, dy, ds, sign: float,
                   weigh_exp: bool = False):
    """The backward's terms in the model layout, in the operands' dtype,
    from the f32 ``a_cum`` ``cs`` (converted): (dx, ddt, d a_cum, dB, dC).
    ``sign`` multiplies the terms that enter d a_cum subtracted (-1; +1
    with absolute operands gives each output's sum of |terms|).  With
    ``weigh_exp`` each decay is weighed by the size of its exponent
    (``L |a_cum[q] - a_cum[k]|``, ``e |a_cum[-1] - a_cum[k]|``).

    With ``M[q,k] = (C_q.B_k) L[q,k] dt_k`` (k <= q), ``dM = dy x^T``,
    ``e_k = exp(a_cum[-1] - a_cum[k])``, ``w = e dt`` and
    ``dsB[k,p] = sum_n ds[p,n] B[k,n]``:

    * ``dx[k] = sum_{q>=k} M[q,k] dy[q] + w_k dsB[k]``;
    * ``ddt_k = sum_{q>=k} dM (C.B) L + e_k dw_k``, ``dw_k = x_k . dsB[k]``;
    * ``d a_cum[i] = sum_{k<i} G[i,k] - sum_{q>i} G[q,i]`` with ``G = dM
      M`` (the diagonal, where L is 1 whatever a_cum is, drops out), then
      the state's decay: ``+ sum_{k<Q-1} dw_k w_k`` at ``i = Q-1`` and
      ``- dw_i w_i`` below it;
    * ``dCB = sum_h dM L dt``, ``dC = dCB B``, ``dB = dCB^T C + sum_h w
      x^T ds``.
    """
    Q = x.shape[1]
    tril = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    diff = cs[:, :, None, :] - cs[:, None, :, :]            # [BC,Q,K,H]
    L = torch.exp(torch.where(tril[None, :, :, None], diff,
                              torch.full_like(diff, -math.inf)))
    e = torch.exp(cs[:, -1:] - cs)                          # [BC,Q,H]
    if weigh_exp:
        L = L * diff.abs()
        e = e * (cs[:, -1:] - cs).abs()
    w = e * dt
    dx, ddt, dcs = (torch.zeros_like(x), torch.zeros_like(dt),
                    torch.zeros_like(dt))
    dB, dC = torch.zeros_like(B), torch.zeros_like(C)
    if dy is not None:
        CB = torch.einsum("bqn,bkn->bqk", C, B)
        dM = torch.einsum("bqhp,bkhp->bqkh", dy, x)
        Ldt = L * dt[:, None]
        dx = torch.einsum("bqkh,bqhp->bkhp", CB[..., None] * Ldt, dy)
        E = dM * CB[..., None] * L
        ddt = E.sum(1)
        strict = tril.tril(-1)[None, :, :, None]
        G = torch.where(strict, E * dt[:, None], torch.zeros_like(E))
        dcs = G.sum(2) + sign * G.sum(1)
        dCB = (dM * Ldt).sum(-1)
        dC = torch.einsum("bqk,bkn->bqn", dCB, B)
        dB = torch.einsum("bqk,bqn->bkn", dCB, C)
    if ds is not None:
        dsB = torch.einsum("bhpn,bkn->bkhp", ds, B)
        dx = dx + w[..., None] * dsB
        dw = (x * dsB).sum(-1)                              # [BC,Q,H]
        ddt = ddt + dw * e
        T = (dw * w)[:, :-1]                  # the last step's decay is 1
        dcs = dcs + torch.cat([sign * T, T.sum(1, keepdim=True)], dim=1)
        dB = dB + torch.einsum("bkh,bkhp,bhpn->bkn", w, x, ds)
    return dx, ddt, dcs, dB, dC


def _reverse_cumsum(t: torch.Tensor, dtype) -> torch.Tensor:
    """``out[j] = sum_{i>=j} t[i]`` along dim 1, summed in f64."""
    return t.double().flip(1).cumsum(1).flip(1).to(dtype)


def ssd_bwd_operands(x, dt, a, B, C, dy, ds):
    """The model layout of the backward's operands (see ssd_chunk_bwd_ref),
    checked; returns them and whether they came in the flat layout."""
    flat = x.ndim == 3
    if flat:
        x, dt, a = x[:, :, None], dt[..., None], a[..., None]
        dy = None if dy is None else dy[:, :, None]
        ds = None if ds is None else ds[:, None]
    check_ssd_shapes(x, dt, a, B, C)
    BC, Q, H, P = x.shape
    if dy is not None and dy.shape != x.shape:
        raise ValueError(f"ssd_chunk_bwd: dy {tuple(dy.shape)} expected "
                         f"{tuple(x.shape)}")
    if ds is not None and ds.shape != (BC, H, P, B.shape[-1]):
        raise ValueError(f"ssd_chunk_bwd: ds {tuple(ds.shape)} expected "
                         f"{(BC, H, P, B.shape[-1])}")
    return flat, x, dt, a, B, C, dy, ds


def ssd_bwd_layout(flat: bool, outs):
    """(dx, ddt, da, dB, dC) back in the flat layout where it came so."""
    if not flat:
        return tuple(outs)
    dx, ddt, da, dB, dC = outs
    return dx[:, :, 0], ddt[..., 0], da[..., 0], dB, dC


def ssd_chunk_bwd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      B: torch.Tensor, C: torch.Tensor,
                      dy: Optional[torch.Tensor] = None,
                      ds: Optional[torch.Tensor] = None):
    """Gradients (dx, ddt, da, dB, dC), all f32, of :func:`ssd_chunk_ref`
    given the gradients ``dy`` of y and ``ds`` of the state, from explicit
    formulas in f32 (not autograd).  Either may be None, which counts as
    zero.  Layouts of :func:`ssd_chunk_ref`: in the model's, dB and dC sum
    the H heads that share B and C.  ``da`` is the reverse cumsum of d
    a_cum within the chunk, summed in f64 as :func:`chunk_cumsum` sums
    a_cum."""
    flat, x, dt, a, B, C, dy, ds = ssd_bwd_operands(x, dt, a, B, C, dy, ds)
    f32 = torch.float32
    cs = chunk_cumsum(a.float(), 1)
    dx, ddt, dcs, dB, dC = _ssd_bwd_terms(
        x.float(), dt.float(), cs, B.float(), C.float(),
        None if dy is None else dy.float(),
        None if ds is None else ds.float(), -1.0)
    return ssd_bwd_layout(flat, (dx, ddt, _reverse_cumsum(dcs, f32), dB,
                                 dC))


def ssd_chunk_bwd_f64(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      B: torch.Tensor, C: torch.Tensor,
                      dy: Optional[torch.Tensor] = None,
                      ds: Optional[torch.Tensor] = None):
    """:func:`ssd_chunk_bwd_ref` evaluated in f64, with the bound an f32
    evaluation of it must meet, as :func:`ssd_chunk_f64` bounds the
    forward.

    Returns ``((dx, ddt, da, dB, dC), (their bounds))``: the f64 gradients
    from the same f32 ``a_cum``, and per element ``gamma * 2**-24`` times
    the sum of the absolute values of the terms summed into it (the same
    formulas on absolute operands, every subtraction an addition).  gamma
    is the length of the longest chain of f32 roundings into the output,
    read off its sums, plus 32 units of slack for ``exp`` (Higham's
    gamma_n).  Two more terms: ``2**-24`` times the same sum with each
    decay weighed by its exponent's size (f32 rounds ``a_cum[q] -
    a_cum[k]`` to 2**-24 of it, and exp makes that relative error: at an
    early k, ``w_k dsB`` alone makes dx when dy is absent, with an exponent
    near -65 at Q 100); and ``gamma * 2**-126`` times the sum with every
    decay 1, for the decays that fall below f32's normal range:

    * dx: N (C.B) + Q (the sum over q);
    * ddt: P (dM) + N (C.B) + Q;
    * da: P + N + 2Q (a row and a column of G); the reverse cumsum is f64;
    * dC: P + H (dCB) + Q;
    * dB: P + H + Q, then the state's H P terms in one chain.

    da's terms cancel (the pairs with both ends at or after j, and da[0]
    is 0 exactly), so a bound taken from max |da| alone would not tell a
    wrong term from rounding; this one does.
    """
    flat, x, dt, a, B, C, dy, ds = ssd_bwd_operands(x, dt, a, B, C, dy, ds)
    f64 = torch.float64
    cs = chunk_cumsum(a.float(), 1).to(f64)
    ops = [t if t is None else t.to(f64) for t in (x, dt, B, C, dy, ds)]
    absx, absdt, *absrest = [t if t is None else t.abs() for t in ops]
    vals = list(_ssd_bwd_terms(ops[0], ops[1], cs, *ops[2:], -1.0))
    mags = list(_ssd_bwd_terms(absx, absdt, cs, *absrest, 1.0))
    # f32 rounds the exponent a_cum[q] - a_cum[k] to 2**-24 of its size,
    # which exp turns into as much relative error in the decay
    expw = list(_ssd_bwd_terms(absx, absdt, cs, *absrest, 1.0,
                               weigh_exp=True))
    # the same sums with every decay 1 (a_cum 0): what a term is worth
    # before its exp, which may fall below f32's normal range
    units = list(_ssd_bwd_terms(absx, absdt, torch.zeros_like(cs),
                                *absrest, 1.0))
    for m in (vals, mags, expw, units):
        m[2] = _reverse_cumsum(m[2], f64)
    _, Q, H, P = x.shape
    N = B.shape[-1]
    gammas = (N + Q, P + N + Q, P + N + 2 * Q, P + H + Q + H * P,
              P + H + Q)
    bounds = [2.0 ** -24 * ((g + 32) * m + x_) + 2.0 ** -126 * (g + 32) * u
              for g, m, x_, u in zip(gammas, mags, expw, units)]
    return ssd_bwd_layout(flat, vals), ssd_bwd_layout(flat, bounds)


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
