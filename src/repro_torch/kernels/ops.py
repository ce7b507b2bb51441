"""Entry points of the port's kernels (counterpart of ``repro.kernels.ops``).

A CUDA tensor goes to the hand-written CUDA kernel (built at first use by
:mod:`.build`); a CPU tensor, which only the tests pass, goes to the plain
version in :mod:`.ref`.  There is no fallback: a CUDA call that cannot
launch raises.  ``LAUNCHES`` counts each kernel's launches, one per call
that reached the GPU, so a run can show that it went through the kernels.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from . import build, ref

LAUNCHES: Dict[str, int] = {name: 0 for name in build.KERNELS}
SSD_MAX_Q = 1024     # csrc/ssd_chunk.cu: kMaxQ (its shared-memory plan)
ATTN_HEAD_DIMS = (64, 96, 128)   # csrc/flash_attention.cu: its dispatches


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _cuda_args(name: str, *tensors: torch.Tensor) -> int:
    """Validate CUDA operands; returns the kernel's dtype code."""
    dtype = tensors[0].dtype
    if dtype not in build.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: operands must share device and dtype, "
                             f"got {t.device}/{t.dtype} and {dev}/{dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return build.DTYPE_CODES[dtype]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: [T, D]; w: [D] -> [T, D] in x.dtype (reduction in f32)."""
    if x.ndim != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm: x [T,D] and w [D] expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not x.is_cuda:
        return ref.rmsnorm_ref(x, w, eps=eps)
    code = _cuda_args("rmsnorm", x)
    wf = w.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    T, D = x.shape
    rc = build.launcher("rmsnorm")(x.data_ptr(), wf.data_ptr(),
                                   out.data_ptr(), T, D, float(eps), code,
                                   _stream(x))
    build.check("rmsnorm", rc)
    LAUNCHES["rmsnorm"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,Sq,H,Dh]; k, v: [B,Sk,KV,Dh] -> [B,Sq,H,Dh] in q.dtype.

    Causal attention needs ``Sq == Sk`` (the kernel's mask has no offset);
    ``window`` > 0 (causal only) keeps the keys ``qi - window < kj <= qi``.
    The kernel is built for head dims ``ATTN_HEAD_DIMS``.
    """
    ref.check_attention_shapes(q, k, v, causal, window)
    if not q.is_cuda:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       sm_scale=sm_scale)
    B, Sq, H, Dh = q.shape
    _, Sk, KV, _ = k.shape
    if Dh not in ATTN_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {Dh} not built "
                         f"({ATTN_HEAD_DIMS})")
    code = _cuda_args("flash_attention", q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(Dh)
    out = torch.empty_like(q)
    rc = build.launcher("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        H, KV, Dh, float(sm_scale), int(causal), int(window), code,
        _stream(q))
    build.check("flash_attention", rc)
    LAUNCHES["flash_attention"] += 1
    return out


def check_gmm_bf16_shape(D: int, F: int) -> None:
    """The bf16 grouped_matmul kernels read rows of D and F elements with
    16-byte copies (TMA's stride rule and ``cp.async``), so both must be
    multiples of 8.  Raises ``ValueError`` otherwise: there is no other
    route for such a call."""
    if D % 8 or F % 8:
        raise ValueError(f"grouped_matmul: bf16 on the GPU needs D and F "
                         f"divisible by 8, got D={D}, F={F}")


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_offsets: torch.Tensor) -> torch.Tensor:
    """lhs: [T,D] sorted by group; rhs: [E,D,F]; offsets: [E+1] -> [T,F].

    Rows no group covers are zero.
    """
    if (lhs.ndim != 2 or rhs.ndim != 3 or rhs.shape[1] != lhs.shape[1]
            or group_offsets.shape != (rhs.shape[0] + 1,)):
        raise ValueError(f"grouped_matmul: lhs [T,D], rhs [E,D,F], offsets "
                         f"[E+1] expected, got {tuple(lhs.shape)}, "
                         f"{tuple(rhs.shape)}, {tuple(group_offsets.shape)}")
    if not lhs.is_cuda:
        return ref.grouped_matmul_ref(lhs, rhs, group_offsets)
    code = _cuda_args("grouped_matmul", lhs, rhs)
    offs = group_offsets.to(device=lhs.device, dtype=torch.int32).contiguous()
    T, D = lhs.shape
    E, _, F = rhs.shape
    if lhs.dtype == torch.bfloat16:
        check_gmm_bf16_shape(D, F)
    out = torch.empty((T, F), dtype=lhs.dtype, device=lhs.device)
    rc = build.launcher("grouped_matmul")(
        lhs.data_ptr(), rhs.data_ptr(), offs.data_ptr(), out.data_ptr(), T, D,
        F, E, code, _stream(lhs))
    build.check("grouped_matmul", rc)
    LAUNCHES["grouped_matmul"] += 1
    return out


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD terms in f32 (layouts of :func:`ref.ssd_chunk_ref`).

    x [G,Q,P]; dt, a [G,Q]; B, C [G,Q,N] -> (y [G,Q,P], state [G,P,N]),
    or the model's layout with B, C shared by the H heads of a cell:
    x [BC,Q,H,P]; dt, a [BC,Q,H]; B, C [BC,Q,N] -> (y [BC,Q,H,P],
    state [BC,H,P,N]).  Any Q from 1 to ``SSD_MAX_Q``; operands are read
    as f32.
    """
    if x.ndim > 1 and x.shape[1] > SSD_MAX_Q:
        raise ValueError(f"ssd_chunk: chunk length {x.shape[1]} above "
                         f"{SSD_MAX_Q} is not built")
    if not x.is_cuda:
        return ref.ssd_chunk_ref(x, dt, a, B, C)
    flat = x.ndim == 3
    if flat:
        x, dt, a = x[:, :, None], dt[..., None], a[..., None]
    ref.check_ssd_shapes(x, dt, a, B, C)
    x, dt, a, B, C = (t.float().contiguous() for t in (x, dt, a, B, C))
    _cuda_args("ssd_chunk", x, dt, a, B, C)
    BC, Q, H, P = x.shape
    N = B.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((BC, H, P, N), dtype=torch.float32, device=x.device)
    rc = build.launcher("ssd_chunk")(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), state.data_ptr(), BC, Q, H, P, N,
        _stream(x))
    build.check("ssd_chunk", rc)
    LAUNCHES["ssd_chunk"] += 1
    if flat:
        return y[:, :, 0], state[:, 0]
    return y, state


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full SSD scan around the intra-chunk kernel (``repro.kernels.ops.
    ssd_scan``).  x [b,S,H,P]; dt [b,S,H] (post-softplus); A_log [H];
    B, C [b,S,N] -> (y [b,S,H,P] f32, final state [b,H,P,N] f32).

    The chunk shrinks until it divides S.  The kernel reads x, dt and a
    as ``[b*nc, Q, H, ...]`` views and B, C un-broadcast, so no operand is
    copied per head.  The cross-chunk recurrence ``S_c = g_c S_{c-1} +
    states_c`` is a loop over the ``nc`` chunks in plain torch, and the
    off-diagonal term ``y += C_t exp(a_cum_t) S_prev`` one batched matmul.
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    nc = S // Q
    f32 = torch.float32
    x, dt, B, C = (t.to(f32).contiguous() for t in (x, dt, B, C))
    a = dt * (-torch.exp(A_log.to(f32)))                      # [b,S,H]
    y, states = ssd_chunk(x.view(b * nc, Q, H, P), dt.view(b * nc, Q, H),
                          a.view(b * nc, Q, H), B.view(b * nc, Q, N),
                          C.view(b * nc, Q, N))
    y = y.reshape(b, nc, Q, H, P)
    states = states.reshape(b, nc, H, P, N)

    a_cum = ref.chunk_cumsum(a.view(b, nc, Q, H), 2)          # [b,nc,Q,H]
    g = torch.exp(a_cum[:, :, -1])                            # [b,nc,H]
    prev = torch.zeros_like(states)                 # state entering chunk c
    for c in range(1, nc):
        prev[:, c] = g[:, c - 1, :, None, None] * prev[:, c - 1] \
            + states[:, c - 1]
    final = g[:, -1, :, None, None] * prev[:, -1] + states[:, -1]
    if nc > 1:
        Cc = C.view(b, nc, Q, N)
        y_off = Cc @ prev.reshape(b, nc, H * P, N).transpose(-1, -2)
        y += y_off.view(b, nc, Q, H, P) * torch.exp(a_cum)[..., None]
    return y.reshape(b, S, H, P), final
