"""Entry points of the port's kernels (counterpart of ``repro.kernels.ops``).

A CUDA tensor goes to the hand-written CUDA kernel (built at first use by
:mod:`.build`); a CPU tensor, which only the tests pass, goes to the plain
version in :mod:`.ref`, which autograd follows.  There is no fallback: a
CUDA call that cannot launch raises.  ``LAUNCHES`` counts each kernel's
launches, one per call that reached the GPU, so a run can show that it
went through the kernels.

Gradients on the card: when grad is enabled and an operand requires it,
``rmsnorm``, ``flash_attention`` and ``grouped_matmul`` run as
``torch.autograd.Function``s whose forward is the forward kernel and whose
backward is a CUDA kernel too (``rmsnorm_bwd``; ``flash_attention_bwd``,
from the row logsumexp the forward then also writes; ``grouped_matmul_dx``,
which reads W^T in place, and ``grouped_matmul_dw``).
``ssd_chunk`` has no backward kernel yet: on the card it raises rather than
return an output with no ``grad_fn``.  Serving (no grad) launches the
forward kernels alone, with no logsumexp.

Counting (``launch.roofline.Counter``): while a counter is active every
entry of ``KERNEL_NAMES`` records its formula once a launch, whichever
route runs it, and the aten ops inside its wrapper count nothing.  On CPU
and meta tensors the kernels then take the card's route through the same
``autograd.Function``s, so a step records the backward kernels the card
would launch: the plain version on CPU tensors (its temporaries not
tracked as memory), outputs of the kernel's shapes on meta tensors (the
dry-run).  ``ssd_chunk`` under grad, which has no kernel, runs its plain
version and counts as aten ops.  With no counter, a launch only tests
``roofline.ACTIVE``.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from ..launch import roofline
from . import build, ref

KERNEL_NAMES = build.KERNELS + ("rmsnorm_bwd", "flash_attention_bwd",
                                "grouped_matmul_dx", "grouped_matmul_dw")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_NAMES}
SSD_MAX_Q = 1024     # csrc/ssd_chunk.cu: kMaxQ (its shared-memory plan)
ATTN_HEAD_DIMS = (64, 96, 128)   # csrc/flash_attention.cu: its dispatches
RMS_DW_PARTS = 256   # csrc/rmsnorm.cu: kMaxParts, dw partials at most


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


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _launch(name: str, entry: str, *args, cost=None) -> None:
    """Call a kernel's C entry point, raise on its error code, count it;
    under a counter, record ``cost()`` (``_record``'s arguments)."""
    build.check(name, build.launcher(entry)(*args))
    LAUNCHES[name] += 1
    if roofline.ACTIVE is not None:
        _record(name, *cost())


def _record(name: str, nbytes: int, flops: int, dtype: str,
            rows: Optional[int] = None) -> None:
    roofline.ACTIVE.kernel(name, nbytes, flops, dtype, rows)


def _counting() -> bool:
    return roofline.ACTIVE is not None


def _plain(name: str, cost, fn, meta):
    """A kernel's call on CPU or meta operands under a counter: records
    ``cost`` and returns ``meta()``, outputs of the kernel's shapes, when
    ``fn`` is None (meta operands), else the plain version ``fn()``, whose
    aten ops and temporaries count nothing and whose outputs are tracked
    as the kernel's."""
    _record(name, *cost)
    if fn is None:
        with roofline.quiet():
            return meta()
    with roofline.quiet(untracked=True):
        out = fn()
    for t in roofline.tensors(out):
        roofline.ACTIVE.track(t)
    return out


def _dt(t: torch.Tensor) -> str:
    return roofline.dtype_name(t.dtype)


def _kernel_call(fn):
    """A kernel's wrapper, whose own aten ops (operand copies, the outputs'
    allocation) count no FLOPs or bytes under a counter: the kernel's
    formula is its cost, on every route."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        if roofline.ACTIVE is None:
            return fn(*args, **kwargs)
        with roofline.quiet():
            return fn(*args, **kwargs)
    return call


# ------------------------------------------------------------------ rmsnorm
def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: [T, D]; w: [D] -> [T, D] in x.dtype (reduction in f32)."""
    if x.ndim != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm: x [T,D] and w [D] expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not x.is_cuda and not _counting():
        return ref.rmsnorm_ref(x, w, eps=eps)
    if _needs_grad(x, w):
        return _RmsNorm.apply(x, w, eps)
    return _rmsnorm_fwd(x, w, eps)


@_kernel_call
def _rmsnorm_fwd(x: torch.Tensor, w: torch.Tensor, eps: float):
    T, D = x.shape
    if not x.is_cuda:
        return _plain("rmsnorm", (*roofline.rmsnorm_cost(
            T, D, x.element_size()), _dt(x)),
            None if x.is_meta else lambda: ref.rmsnorm_ref(x, w, eps=eps),
            lambda: torch.empty_like(x))
    code = _cuda_args("rmsnorm", x)
    wf = w.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    _launch("rmsnorm", "rmsnorm", x.data_ptr(), wf.data_ptr(),
            out.data_ptr(), T, D, float(eps), code, _stream(x),
            cost=lambda: (*roofline.rmsnorm_cost(T, D, x.element_size()),
                          _dt(x)))
    return out


@_kernel_call
def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                 eps: float):
    """(dx in x.dtype, dw f32) through the backward kernel: one pass over
    the rows that writes dx and one f32 partial of dw for each block of
    rows, then a launch that sums the partials in order (skipped when one
    block holds every row).  The scratch for the partials is
    ``[min(T, RMS_DW_PARTS), D]`` f32: the kernel makes at most that many
    blocks."""
    T, D = x.shape
    if not x.is_cuda:
        return _plain("rmsnorm_bwd", (*roofline.rmsnorm_bwd_cost(
            T, D, x.element_size()), _dt(x)),
            None if x.is_meta else
            lambda: ref.rmsnorm_bwd_ref(x, w.float(), dy, eps=eps),
            lambda: (torch.empty_like(x),
                     x.new_empty(D, dtype=torch.float32)))
    code = _cuda_args("rmsnorm_bwd", x, dy)
    wf = w.to(device=x.device, dtype=torch.float32).contiguous()
    dx = torch.empty_like(x)
    dw = torch.empty(D, dtype=torch.float32, device=x.device)
    if T == 0:
        return dx, dw.zero_()
    partial = torch.empty((min(T, RMS_DW_PARTS), D), dtype=torch.float32,
                          device=x.device)
    _launch("rmsnorm_bwd", "rmsnorm_bwd", x.data_ptr(), wf.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), dw.data_ptr(), partial.data_ptr(),
            T, D, float(eps), code, _stream(x),
            cost=lambda: (*roofline.rmsnorm_bwd_cost(T, D, x.element_size()),
                          _dt(x)))
    return dx, dw


class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rmsnorm_fwd(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, dy.contiguous(), ctx.eps)
        return dx, dw.to(w.dtype), None


# ---------------------------------------------------------- flash attention
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,Sq,H,Dh]; k, v: [B,Sk,KV,Dh] -> [B,Sq,H,Dh] in q.dtype.

    Causal attention needs ``Sq == Sk`` (the kernel's mask has no offset);
    ``window`` > 0 (causal only) keeps the keys ``qi - window < kj <= qi``.
    The kernel is built for head dims ``ATTN_HEAD_DIMS``.
    """
    ref.check_attention_shapes(q, k, v, causal, window)
    if not q.is_cuda and not _counting():
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       sm_scale=sm_scale)
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, sm_scale)
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               sm_scale=sm_scale)[0]


def _attn_scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    Dh = q.shape[-1]
    if Dh not in ATTN_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {Dh} not built "
                         f"({ATTN_HEAD_DIMS})")
    return 1.0 / math.sqrt(Dh) if sm_scale is None else float(sm_scale)


@_kernel_call
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        sm_scale: Optional[float] = None,
                        with_lse: bool = False):
    """The forward kernel on CUDA operands: (out, lse), where ``lse``
    [B,H,Sq] f32 is each row's logsumexp of the scaled, masked scores when
    ``with_lse`` (the backward's input), else None."""
    ref.check_attention_shapes(q, k, v, causal, window)
    B, Sq, H, Dh = q.shape
    _, Sk, KV, _ = k.shape

    def cost():
        return (*roofline.attention_cost(B, Sq, Sk, H, KV, Dh, causal, window,
                                         q.element_size()), _dt(q))

    if not q.is_cuda:
        def lse_like():
            return (q.new_empty((B, H, Sq), dtype=torch.float32)
                    if with_lse else None)
        return _plain(
            "flash_attention", cost(),
            None if q.is_meta else lambda: (ref.flash_attention_ref(
                q, k, v, causal=causal, window=window, sm_scale=sm_scale),
                lse_like()),
            lambda: (torch.empty_like(q), lse_like()))
    scale = _attn_scale(q, sm_scale)
    code = _cuda_args("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    _launch("flash_attention", "flash_attention", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Sq, Sk, H, KV, Dh,
            scale, int(causal), int(window), code, _stream(q), cost=cost)
    return out, lse


@_kernel_call
def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0, sm_scale: Optional[float] = None):
    """(dq, dk, dv) through the backward kernels, from the forward's
    ``out`` and ``lse`` (:func:`flash_attention_fwd` with ``with_lse``)."""
    ref.check_attention_shapes(q, k, v, causal, window)
    B, Sq, H, Dh = q.shape
    _, Sk, KV, _ = k.shape

    def cost():
        return (*roofline.attention_bwd_cost(B, Sq, Sk, H, KV, Dh, causal,
                                             window, q.element_size()),
                _dt(q))

    if not q.is_cuda:
        return _plain(
            "flash_attention_bwd", cost(),
            None if q.is_meta else lambda: ref.flash_attention_bwd_ref(
                q, k, v, out, dout, causal=causal, window=window,
                sm_scale=sm_scale),
            lambda: tuple(torch.empty_like(t) for t in (q, k, v)))
    scale = _attn_scale(q, sm_scale)
    code = _cuda_args("flash_attention_bwd", q, k, v, out, dout)
    _cuda_args("flash_attention_bwd", lse)
    if lse.shape != (B, H, Sq):
        raise ValueError(f"flash_attention_bwd: lse {(B, H, Sq)} expected, "
                         f"got {tuple(lse.shape)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    Dd = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _launch("flash_attention_bwd", "flash_attention_bwd", q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            Dd.data_ptr(), B, Sq, Sk, H, KV, Dh, scale, int(causal),
            int(window), code, _stream(q), cost=cost)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       sm_scale=sm_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, sm_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, sm_scale = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), causal=causal,
                                         window=window, sm_scale=sm_scale)
        return dq, dk, dv, None, None, None


# ----------------------------------------------------------- grouped matmul
def check_gmm_bf16_shape(D: int, F: int) -> None:
    """The bf16 grouped_matmul kernels (forward, dX and dW) read rows of D
    and F elements with 16-byte copies (TMA's stride rule and
    ``cp.async``), so both must be multiples of 8.  Raises ``ValueError``
    otherwise: there is no other route for such a call."""
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
    if not lhs.is_cuda and not _counting():
        return ref.grouped_matmul_ref(lhs, rhs, group_offsets)
    if _needs_grad(lhs, rhs):
        return _GroupedMatmul.apply(lhs, rhs, group_offsets)
    return _gmm(lhs, rhs, group_offsets, "grouped_matmul")


def _offsets(group_offsets: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return group_offsets.to(device=like.device,
                            dtype=torch.int32).contiguous()


def _covered(offs: torch.Tensor, T: int, E: int):
    """(the rows the group offsets cover, the groups that have rows): read
    from the offsets (one host read, under a counter only), or every row
    and group on meta, whose values are unknown (the dry-run keeps the
    rows it covers, ``models.moe.moe_gather``)."""
    if offs.is_meta:
        return T, E
    o = [min(max(int(v), 0), T) for v in offs.tolist()]
    return o[-1] - o[0], sum(1 for a, b in zip(o, o[1:]) if b > a)


@_kernel_call
def _gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_offsets: torch.Tensor,
         name: str) -> torch.Tensor:
    """The kernel named ``name``, counted under it: ``grouped_matmul``
    (lhs [T,D] -> [T,F]) or ``grouped_matmul_dx`` (dX = dY W^T per group:
    lhs is dY [T,F], rhs W [E,D,F] read in place -> [T,D])."""
    offs = _offsets(group_offsets, lhs)
    T, K = lhs.shape
    E, D, F = rhs.shape
    dx = name == "grouped_matmul_dx"

    def cost():
        rows, used = _covered(offs, T, E)
        return (*roofline.gmm_cost(T, K, D if dx else F, E, rows, used,
                                   lhs.element_size()), _dt(lhs), rows)

    if not lhs.is_cuda:
        w = rhs.transpose(1, 2) if dx else rhs
        return _plain(name, cost(),
                      None if lhs.is_meta else
                      lambda: ref.grouped_matmul_ref(lhs, w, offs),
                      lambda: lhs.new_empty((T, D if dx else F)))
    code = _cuda_args(name, lhs, rhs)
    if K != (F if dx else D) or offs.shape != (E + 1,):
        raise ValueError(f"{name}: lhs [T,{'F' if dx else 'D'}], rhs "
                         f"[E,D,F], offsets [E+1] expected, got "
                         f"{tuple(lhs.shape)}, {tuple(rhs.shape)}, "
                         f"{tuple(offs.shape)}")
    if lhs.dtype == torch.bfloat16:
        check_gmm_bf16_shape(D, F)
    out = torch.empty((T, D if dx else F), dtype=lhs.dtype,
                      device=lhs.device)
    _launch(name, name, lhs.data_ptr(), rhs.data_ptr(), offs.data_ptr(),
            out.data_ptr(), T, D, F, E, code, _stream(lhs), cost=cost)
    return out


@_kernel_call
def grouped_matmul_dw(lhs: torch.Tensor, dout: torch.Tensor,
                      group_offsets: torch.Tensor, E: int) -> torch.Tensor:
    """dW [E,D,F] = per group, lhs[rows]^T dout[rows], through its kernel
    (an expert with no rows gets zeros; uncovered rows add nothing).  bf16
    needs D and F divisible by 8 (:func:`check_gmm_bf16_shape`)."""
    offs = _offsets(group_offsets, lhs)
    T, D = lhs.shape
    F = dout.shape[1]

    def cost():
        rows, _ = _covered(offs, T, E)
        return (*roofline.gmm_dw_cost(D, F, E, rows, lhs.element_size()),
                _dt(lhs), rows)

    if not lhs.is_cuda:
        return _plain("grouped_matmul_dw", cost(),
                      None if lhs.is_meta else
                      lambda: ref.grouped_matmul_dw_ref(lhs, dout, offs, E),
                      lambda: lhs.new_empty((E, D, F)))
    code = _cuda_args("grouped_matmul_dw", lhs, dout)
    if offs.shape != (E + 1,):
        raise ValueError(f"grouped_matmul_dw: offsets [{E + 1}] expected, "
                         f"got {tuple(offs.shape)}")
    if lhs.dtype == torch.bfloat16:
        check_gmm_bf16_shape(D, F)
    dw = torch.empty((E, D, F), dtype=lhs.dtype, device=lhs.device)
    _launch("grouped_matmul_dw", "grouped_matmul_dw", lhs.data_ptr(),
            dout.data_ptr(), offs.data_ptr(), dw.data_ptr(), T, D, F, E, code,
            _stream(lhs), cost=cost)
    return dw


def grouped_matmul_bwd(lhs: torch.Tensor, rhs: torch.Tensor,
                       group_offsets: torch.Tensor, dout: torch.Tensor,
                       need_dx: bool = True, need_dw: bool = True):
    """(dlhs, drhs) on CUDA operands: dX = dY W^T per group through
    ``grouped_matmul_dx``, which reads ``rhs`` in place (no copy of W^T),
    and dW through ``grouped_matmul_dw``."""
    dx = dw = None
    if need_dx:
        dx = _gmm(dout, rhs, group_offsets, "grouped_matmul_dx")
    if need_dw:
        dw = grouped_matmul_dw(lhs, dout, group_offsets, rhs.shape[0])
    return dx, dw


class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs, group_offsets):
        offs = _offsets(group_offsets, lhs)
        ctx.save_for_backward(lhs, rhs, offs)
        return _gmm(lhs, rhs, offs, "grouped_matmul")

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, offs = ctx.saved_tensors
        dx, dw = grouped_matmul_bwd(lhs, rhs, offs, dout.contiguous(),
                                    ctx.needs_input_grad[0],
                                    ctx.needs_input_grad[1])
        return dx, dw, None


# ---------------------------------------------------------------- ssd_chunk
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
        if not _counting() or _needs_grad(x, dt, a, B, C):
            return ref.ssd_chunk_ref(x, dt, a, B, C)
        BC, Q, H, P = x.shape if x.ndim == 4 else (*x.shape[:2], 1,
                                                     x.shape[2])
        N = B.shape[-1]
        state = (BC, H, P, N) if x.ndim == 4 else (BC, P, N)
        return _plain("ssd_chunk", (*roofline.ssd_cost(BC, Q, H, P, N),
                                    "float32"),
                      None if x.is_meta else
                      lambda: ref.ssd_chunk_ref(x, dt, a, B, C),
                      lambda: (x.new_empty(x.shape, dtype=torch.float32),
                               x.new_empty(state, dtype=torch.float32)))
    if _needs_grad(x, dt, a, B, C):
        raise RuntimeError(
            "ssd_chunk: the CUDA kernel has no backward yet (ROADMAP queue 2, "
            "part A), so on the card it runs only without grad; its output "
            "would carry no gradient.  Train SSM layers on the CPU (the plain "
            "version) or under torch.no_grad() on the card")
    return _ssd_chunk_cuda(x, dt, a, B, C)


@_kernel_call
def _ssd_chunk_cuda(x, dt, a, B, C):
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
    _launch("ssd_chunk", "ssd_chunk", x.data_ptr(), dt.data_ptr(),
            a.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
            state.data_ptr(), BC, Q, H, P, N, _stream(x),
            cost=lambda: (*roofline.ssd_cost(BC, Q, H, P, N), "float32"))
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
    # the state entering each chunk, built out of place so that autograd
    # can follow it (the plain version trains on the CPU)
    prevs = [torch.zeros_like(states[:, 0])]
    for c in range(1, nc):
        prevs.append(g[:, c - 1, :, None, None] * prevs[-1]
                     + states[:, c - 1])
    final = g[:, -1, :, None, None] * prevs[-1] + states[:, -1]
    if nc > 1:
        prev = torch.stack(prevs, dim=1)
        Cc = C.view(b, nc, Q, N)
        y_off = Cc @ prev.reshape(b, nc, H * P, N).transpose(-1, -2)
        y = y + y_off.view(b, nc, Q, H, P) * torch.exp(a_cum)[..., None]
    return y.reshape(b, S, H, P), final
