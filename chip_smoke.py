#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its own lines; any mismatch raises and the script
exits non-zero:

(a) the card's name and power limit (``nvidia-smi``), then the build of the
    CUDA kernels from ``src/repro_torch/kernels/csrc`` and its time;
(b) each kernel against its plain PyTorch version on the card, in f32
    (tolerance 2e-5) and bf16 (2e-2; ssd_chunk is f32 only), at the main
    paths' shapes, the kernel tests' shapes and the tile edges of the
    tensor-core grouped_matmul and flash_attention, and the routes and tiles
    of the warp-per-row rmsnorm and the grouped ssd_chunk; a bf16
    grouped_matmul with D % 8 != 0 must raise.  Every ssd_chunk output is
    also held to an f64 evaluation of the plain version, within f32's
    worst-case rounding of its terms.  qwen3-1.7b's serving shapes and
    the calibration harness's slices are checked too, and the harness's
    ssd_scan against the same function on the CPU.  Then times for the
    kernel, the plain version, the nearest single PyTorch call and the
    least time the card could take;
(c) the three serving paths, each at full width and full depth, bf16,
    seeded random weights, prefill of 8 prompts of 512 tokens then 32
    greedy tokens: granite-moe-1b-a400m (rmsnorm, flash_attention,
    grouped_matmul), mamba2-780m (rmsnorm, ssd_chunk) and the dense
    qwen3-1.7b (rmsnorm with qk-norm, flash_attention; its FFN is
    ``torch.matmul``).  Each path's launch counts are set to 0 just before
    it and checked against the config just after; each gets one profiled
    prefill and decode window (top device ops, device idle share);
(d) whole-model checks in f32 for the three models: the card against the
    plain path on the CPU (2-layer full-width cut), and decode against
    prefill over the prompt plus generated tokens at full depth.  For
    granite and qwen3 the bound holds the logits; for mamba2 it holds
    every layer on the same inputs, and the end-to-end logit error is
    printed as a measurement (48 random layers amplify f32 rounding past
    the bound; PERF.md).  mamba2 also prefills 2 tokens, so its conv-tail
    padding (S < K-1) runs on the card;
(e) the calibration harness (``repro_torch.workloads.calibrate``) at
    decode_32k on 16 GPUs for granite-moe-1b-a400m and qwen3-moe-235b-a22b
    (fig13cal's pair), mamba2-780m (ssm_mixer) and qwen3-1.7b (dense_ffn),
    20 timed calls a kernel.  Each profile must say ``interpret`` False,
    hold the roofline anchor within 1e-9, round-trip through its JSON
    (written under ``build/calibration/``), and each measured phase must
    have launched its kernels 21 times.  A window is device time (events
    queued behind a spin kernel): 2 ms of host time before an empty launch
    must stay out of it.  The time of an empty launch, taken the same way,
    gives each window's launch share.

The last two lines are a ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data-sheet peaks (NVIDIA H100 Tensor Core GPU datasheet, dense,
# no sparsity): HBM3 3.35 TB/s, 989 TFLOP/s bf16 tensor core, 67 TFLOP/s
# f32 outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

ARCH, SSM_ARCH, DENSE_ARCH = ("granite-moe-1b-a400m", "mamba2-780m",
                              "qwen3-1.7b")
CAL_ARCHS = ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b", "mamba2-780m",
             "qwen3-1.7b")
CAL_SHAPE, CAL_GPUS, CAL_REPS = "decode_32k", 16, 20
BATCH, PROMPT, TOKENS = 8, 512, 32
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm.py:18",
    "flash_attention": "src/repro/kernels/flash_attention.py:27",
    "grouped_matmul": "src/repro/kernels/grouped_matmul.py:25",
    "ssd_chunk": "src/repro/kernels/ssd_scan.py:28",
}
# mamba2-780m's SSD at the main path's prefill: b 8, S 512, chunk 256,
# 48 heads of P 64, N 128 -> 16 (batch, chunk) cells of 48 heads each
SSD_MAIN = (BATCH * PROMPT // 256, 256, 48, 64, 128)
# test_kernels.py's shapes
ATTN_SHAPES = [(1, 128, 128, 4, 4, 64, True), (2, 256, 256, 8, 2, 64, True),
               (1, 256, 256, 4, 1, 128, True), (2, 128, 128, 4, 4, 128, False),
               (1, 512, 512, 2, 2, 64, True)]
# the tensor-core attention's tile edges: Sq 61, 100, 128, 129, 512 about
# its 64-key tiles and 16-row warp tiles, both head dims, causal, and
# non-causal with Sk != Sq
ATTN_EDGES = [(2, 61, 61, 16, 8, 64, True), (1, 100, 300, 4, 2, 64, False),
              (1, 100, 100, 4, 2, 128, True), (2, 129, 129, 16, 8, 64, True),
              (1, 129, 129, 4, 2, 128, True), (2, 129, 77, 6, 3, 64, False),
              (1, 61, 200, 8, 1, 128, False), (1, 512, 512, 4, 2, 128, True)]
GMM_SHAPES = [(256, 64, 128, 4), (512, 128, 256, 8), (128, 256, 128, 2),
              (384, 64, 128, 6)]
# the grouped matmul's tile edges: an uncovered head of 5 rows, an empty
# first expert, groups of 1, 15, 17, 127, 128 and 129 rows (each after the
# first starts mid-tile), an uncovered tail of 7; and a decode-sized case
# (T <= 16 E) with a 17-row group, empty groups and K, F past a tile
GMM_EDGE_SIZES = (0, 1, 15, 17, 127, 128, 129)
GMM_DECODE_EDGE = (64, 136, 200, 8, [3, 4, 4, 21, 30, 40, 41, 41, 60])
# ssd_chunk as (BC, Q, H, P, N): test_kernels.SSD_SHAPES cut into chunks,
# its intra-chunk test (JAX layout, H = 1), an odd Q, one step, and P, N
# past one tile
SSD_SHAPES = [(4, 16, 2, 16, 16), (8, 32, 4, 32, 64), (4, 64, 2, 64, 128),
              (6, 32, 1, 16, 24), (3, 13, 48, 64, 128), (2, 1, 3, 8, 16),
              (1, 200, 2, 130, 300)]
# rmsnorm's routes about its warp-per-row design: a row held in registers
# (D 1536), one walked in pieces (D 12288), the scalar route (D 1001); then
# x as a contiguous view that starts one element in (not 16-byte aligned,
# so the scalar route too)
RMS_EDGES = [(37, 1001), (300, 1536), (64, 12288)]
RMS_UNALIGNED = [(300, 1024), (64, 3072)]
# ssd_chunk about its tiling: groups of up to 16 heads (H 1, 3, 13, 50), its
# 64-row q-tiles (Q 1, 13, 64, 65, 256), its panel of 4 k-tiles and groups
# of 8 past Q 512 (Q 1024), P and N past one tile (P 130, N 300), and rows
# that cp.async cannot copy (P 30, N 18)
SSD_EDGES = [(2, 256, 1, 64, 128), (2, 256, 3, 64, 128), (2, 65, 13, 64, 128),
             (1, 64, 50, 64, 128), (3, 1, 13, 64, 128), (2, 13, 50, 130, 300),
             (1, 1024, 13, 64, 128), (1, 1024, 3, 130, 300),
             (2, 100, 9, 30, 18)]


def log(phase: str, msg: str) -> None:
    print(f"({phase}) {msg}", flush=True)


# ----------------------------------------------------------------- helpers
def timed_ms(torch, fn, flush, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around each call,
    with L2 flushed before each (the main path meets its weights cold)."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got, want, dtype: str, tol=None) -> float:
    tol = TOL[dtype] if tol is None else tol
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    limit = tol + tol * want.float().abs()
    if not bool((diff <= limit).all()):
        raise AssertionError(f"{name} {dtype}: max_abs_err {err:.3e} "
                             f"exceeds tolerance {tol}")
    return err


def compare_f64(name: str, got, want, bound) -> float:
    """``got`` against an f64 evaluation ``want`` within ``bound`` (both
    from ``ref.ssd_chunk_f64``); returns max |got - want| / bound."""
    diff = (got.double() - want).abs()
    if not bool((diff <= bound).all()):
        raise AssertionError(f"{name}: exceeds its f64 bound")
    if not diff.numel():
        return 0.0
    return float((diff / bound.clamp_min(1e-300)).max())


def random_offsets(torch, gen, T: int, E: int, top_k: int = 8):
    """Group offsets of T rows routed like the MoE layer: T/top_k tokens,
    each to top_k distinct experts drawn at random."""
    n_tok = max(1, T // top_k)
    scores = torch.rand(n_tok, E, generator=gen, device=gen.device)
    idx = scores.topk(min(top_k, E), dim=-1).indices.reshape(-1)[:T]
    counts = torch.bincount(idx, minlength=E)
    return torch.nn.functional.pad(torch.cumsum(counts, 0),
                                   (1, 0)).to(torch.int32)


def expected_launches(cfg, n_tokens: int):
    """Kernel launches for one prefill and n_tokens - 1 decode steps."""
    from repro_torch.models.transformer import _has_ffn, _layer_is_moe
    want = {"rmsnorm": n_tokens, "flash_attention": 0, "grouped_matmul": 0,
            "ssd_chunk": 0}                           # final norm each token
    for i in range(cfg.n_layers):
        kind = cfg.pattern[i % cfg.block_size]
        norms = 1                                     # ln1
        if kind == "attn":
            norms += 2 if cfg.qk_norm else 0
            want["flash_attention"] += 1              # prefill only
        else:
            norms += 1                                # gated norm
            want["ssd_chunk"] += 1                    # prefill only
        if _has_ffn(cfg):
            norms += 1                                # ln2
            if _layer_is_moe(cfg, i % cfg.block_size):
                want["grouped_matmul"] += 3 * n_tokens
        want["rmsnorm"] += norms * n_tokens
    return want


def ssd_inputs(torch, gen, BC: int, Q: int, H: int, P: int, N: int):
    """SSD operands distributed as in mamba2: dt = softplus(.), a =
    -exp(A_log) dt with A_log ~ N(0, 0.1), conv outputs of unit scale."""
    dev = gen.device
    F = torch.nn.functional
    x = torch.randn(BC, Q, H, P, generator=gen, device=dev)
    dt = F.softplus(torch.randn(BC, Q, H, generator=gen, device=dev))
    a = -dt * torch.exp(0.1 * torch.randn(H, generator=gen, device=dev))
    B = torch.randn(BC, Q, N, generator=gen, device=dev)
    C = torch.randn(BC, Q, N, generator=gen, device=dev)
    if H == 1:                                        # the JAX layout
        x, dt, a = x[:, :, 0], dt[..., 0], a[..., 0]
    return x, dt, a, B, C


def ssd_cost(BC: int, Q: int, H: int, P: int, N: int):
    """(bytes, flops) the SSD function needs: each f32 operand read once
    and each output written once; C.B^T once per (batch, chunk) cell (it
    is the same for every head) and only for k <= q, as are the y terms."""
    pairs = Q * (Q + 1) // 2
    nbytes = 4 * (2 * BC * Q * H * P + 2 * BC * Q * H + 2 * BC * Q * N
                  + BC * H * P * N)
    flops = 2 * BC * pairs * N + 2 * BC * H * (pairs * P + Q * P * N)
    return nbytes, flops


def dense_and_slice_shapes():
    """Kernel shapes of the qwen3-1.7b serving path and of the calibration
    harness's slices for CAL_ARCHS (``calibrate.slice_shape``): rmsnorm
    [T,D], flash_attention (B,Sq,Sk,H,KV,Dh,causal), grouped_matmul
    (T,D,F,E) and ssd_scan (S,chunk,H,P,N), each without repeats."""
    from repro_torch import configs
    from repro_torch.workloads.calibrate import (ffn_phase, mixer_phase,
                                                 slice_shape)
    cfg = configs.get_config(DENSE_ARCH)
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    # ln1, ln2 and the final norm at prefill and decode, then the qk-norm
    # rows of q and k at prefill and decode
    rms = [(BATCH * PROMPT, D), (BATCH, D), (BATCH * PROMPT * H, Dh),
           (BATCH * PROMPT * KV, Dh), (BATCH * H, Dh), (BATCH * KV, Dh)]
    attn = [(BATCH, PROMPT, PROMPT, H, KV, Dh, True)]
    gmm, scan = [], []
    for arch in CAL_ARCHS:
        cfg = configs.get_config(arch)
        phases = {f(cfg, i) for i in range(cfg.n_layers)
                  for f in (mixer_phase, ffn_phase)}
        for phase in sorted(phases):
            shape = slice_shape(cfg, phase)
            if phase == "attn_mixer":
                T, D, S, H, KV, Dh = shape
                rms.append((T, D))
                attn.append((1, S, S, H, KV, Dh, True))
            elif phase == "ssm_mixer":
                scan.append(shape)
            else:
                gmm.append(shape)
    return tuple(list(dict.fromkeys(xs)) for xs in (rms, attn, gmm, scan))


# ------------------------------------------------------------ phase (b)
def check_kernels(torch, ops, ref, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    # The tile-edge cases draw from a generator of their own, so that the
    # other checks see the same inputs as before they were added.
    edge_gen = torch.Generator(device=dev).manual_seed(3)
    # and the checks of the warp-per-row rmsnorm and the grouped ssd_chunk
    # from another, so that the earlier checks keep their inputs too
    new_gen = torch.Generator(device=dev).manual_seed(4)
    errs = {}          # kernel -> max err at the main path's bf16 shapes

    def randn(*shape, dtype, g=None):
        return torch.randn(*shape, generator=g or gen, device=dev).to(dtype)

    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for T, D in [(BATCH * PROMPT, 1024), (BATCH, 1024),
                     (BATCH * PROMPT, 1536), (BATCH * PROMPT, 3072),
                     (256, 64), (512, 1024), (256, 3072), (37, 1001)]:
            x, w = randn(T, D, dtype=dt), randn(D, dtype=torch.float32)
            e = compare("rmsnorm", ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w),
                        dname)
            log("b", f"rmsnorm [{T},{D}] {dname}: max_abs_err {e:.3e} "
                f"(tol {TOL[dname]})")
            if dname == "bfloat16" and D == 1024 and T in (BATCH * PROMPT,
                                                           BATCH):
                errs["rmsnorm"] = max(errs.get("rmsnorm", 0.0), e)
        for (T, D), unaligned in ([(td, False) for td in RMS_EDGES]
                                  + [(td, True) for td in RMS_UNALIGNED]):
            w = randn(D, dtype=torch.float32, g=new_gen)
            if unaligned:
                x = randn(T * D + 1, dtype=dt, g=new_gen)[1:].view(T, D)
                if x.data_ptr() % 16 == 0 or not x.is_contiguous():
                    raise AssertionError("rmsnorm: the view is not offset")
            else:
                x = randn(T, D, dtype=dt, g=new_gen)
            e = compare("rmsnorm", ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w),
                        dname)
            where = " one element in" if unaligned else ""
            log("b", f"rmsnorm [{T},{D}]{where} {dname}: max_abs_err "
                f"{e:.3e} (tol {TOL[dname]})")
        for i, (B, Sq, Sk, H, KV, Dh, causal) in enumerate(
                [(BATCH, PROMPT, PROMPT, 16, 8, 64, True)] + ATTN_EDGES
                + ATTN_SHAPES):
            g = edge_gen if 3 <= i < 1 + len(ATTN_EDGES) else None
            q, k, v = (randn(B, Sq, H, Dh, dtype=dt, g=g),
                       randn(B, Sk, KV, Dh, dtype=dt, g=g),
                       randn(B, Sk, KV, Dh, dtype=dt, g=g))
            e = compare("flash_attention",
                        ops.flash_attention(q, k, v, causal=causal),
                        ref.flash_attention_ref(q, k, v, causal=causal),
                        dname)
            log("b", f"flash_attention {(B, Sq, Sk, H, KV, Dh, causal)} "
                f"{dname}: max_abs_err {e:.3e} (tol {TOL[dname]})")
            if dname == "bfloat16" and Sq == PROMPT and H == 16:
                errs["flash_attention"] = e
        gmm_cases = []
        for T, D, Fo, E in [(BATCH * PROMPT * 8, 1024, 512, 32),
                            (BATCH * PROMPT * 8, 512, 1024, 32),
                            (BATCH * 8, 1024, 512, 32),
                            (BATCH * 8, 512, 1024, 32)]:
            kind = "prefill" if T > 64 else "decode"
            gmm_cases.append((f"{kind} [{T},{D}]x[{E},{D},{Fo}]", T, D, Fo, E,
                              random_offsets(torch, gen, T, E), True))
        for T, D, Fo, E in GMM_SHAPES:
            cuts = torch.sort(torch.randint(0, T + 1, (E - 1,), generator=gen,
                                            device=dev)).values
            offs = torch.cat([cuts.new_zeros(1), cuts,
                              cuts.new_full((1,), T)]).to(torch.int32)
            gmm_cases.append((f"[{T},{D}]x[{E},{D},{Fo}]", T, D, Fo, E, offs,
                              False))
        for label, offs in [("empty groups", [0, 0, 256, 256, 256]),
                            ("all groups empty", [0, 0, 0, 0, 0]),
                            ("uncovered tail", [0, 64, 64, 64, 64]),
                            ("uncovered head+tail", [32, 64, 100, 100, 200])]:
            gmm_cases.append((label, 256, 64, 128, 4,
                              torch.tensor(offs, dtype=torch.int32,
                                           device=dev), False))
        edge = [5]
        for n in GMM_EDGE_SIZES:
            edge.append(edge[-1] + n)
        for D in (64, 128, 1024):
            gmm_cases.append((f"groups {GMM_EDGE_SIZES} D {D}", edge[-1] + 7,
                              D, 192, len(GMM_EDGE_SIZES),
                              torch.tensor(edge, dtype=torch.int32,
                                           device=dev), False))
        T, D, Fo, E, offs = GMM_DECODE_EDGE
        gmm_cases.append((f"decode groups {offs}", T, D, Fo, E,
                          torch.tensor(offs, dtype=torch.int32, device=dev),
                          False))
        for i, (label, T, D, Fo, E, offs, main) in enumerate(gmm_cases):
            g = edge_gen if i >= len(gmm_cases) - 4 else None
            lhs = randn(T, D, dtype=dt, g=g)
            rhs = (randn(E, D, Fo, dtype=torch.float32, g=g)
                   / math.sqrt(D)).to(dt)
            got = ops.grouped_matmul(lhs, rhs, offs)
            e = compare("grouped_matmul", got,
                        ref.grouped_matmul_ref(lhs, rhs, offs), dname)
            lo, hi = int(offs[0]), int(offs[-1])
            if bool((got[:lo] != 0).any()) or bool((got[hi:] != 0).any()):
                raise AssertionError(f"grouped_matmul {label}: uncovered "
                                     f"rows are not zero")
            log("b", f"grouped_matmul {label} {dname}: max_abs_err {e:.3e} "
                f"(tol {TOL[dname]})")
            if dname == "bfloat16" and main:
                errs["grouped_matmul"] = max(errs.get("grouped_matmul", 0.0),
                                             e)
    # the bf16 kernels read rows with 16-byte copies: D % 8 != 0 is refused
    lhs = torch.zeros(300, 100, dtype=torch.bfloat16, device=dev)
    rhs = torch.zeros(4, 100, 64, dtype=torch.bfloat16, device=dev)
    try:
        ops.grouped_matmul(lhs, rhs, torch.tensor([0, 1, 2, 3, 300],
                                                  dtype=torch.int32,
                                                  device=dev))
    except ValueError as err:
        log("b", f"grouped_matmul bf16 D 100: raises ValueError ({err})")
    else:
        raise AssertionError("grouped_matmul bf16 with D % 8 != 0 did not "
                             "raise")
    ssd_cases = []
    for i, shape in enumerate([SSD_MAIN] + SSD_SHAPES + SSD_EDGES):
        args = ssd_inputs(torch, gen if i <= len(SSD_SHAPES) else new_gen,
                          *shape)
        got = ops.ssd_chunk(*args)
        want = ref.ssd_chunk_ref(*args)
        e = max(compare(f"ssd_chunk {name}", g, w, "float32")
                for name, g, w in zip(("y", "state"), got, want))
        log("b", f"ssd_chunk (BC,Q,H,P,N)={shape} float32: max_abs_err "
            f"{e:.3e} (tol {TOL['float32']})")
        if shape == SSD_MAIN:
            errs["ssd_chunk"] = e
        ssd_cases.append((shape, args, got))
    # the same outputs against the plain version evaluated in f64, within
    # f32's worst-case rounding of their terms (ref.ssd_chunk_f64)
    for shape, args, got in ssd_cases:
        y64, s64, y_bound, s_bound = ref.ssd_chunk_f64(*args)
        r = max(compare_f64(f"ssd_chunk {shape} y", got[0], y64, y_bound),
                compare_f64(f"ssd_chunk {shape} state", got[1], s64, s_bound))
        log("b", f"ssd_chunk (BC,Q,H,P,N)={shape} against f64: max "
            f"err/bound {r:.3e} (bound (N+Q+32) 2^-24 sum |terms|)")
    del ssd_cases
    check_dense_and_slices(torch, ops, ref, dev)
    torch.cuda.synchronize()
    return errs


def check_dense_and_slices(torch, ops, ref, dev) -> None:
    """qwen3-1.7b's serving shapes and the calibration harness's slices
    (``dense_and_slice_shapes``), in f32 and bf16, against the plain
    versions; ssd_scan, f32 only, against the same function on the CPU
    (its ssd_chunk the plain version), and its kernel's operands against
    the f64 evaluation.  From a generator of their own, so that every
    earlier check keeps its inputs."""
    from repro_torch.workloads.calibrate import ffn_offsets
    gen = torch.Generator(device=dev).manual_seed(5)
    rms, attn, gmm, scan = dense_and_slice_shapes()

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for T, D in rms:
            x, w = randn(T, D, dtype=dt), randn(D)
            e = compare("rmsnorm", ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w),
                        dname)
            log("b", f"rmsnorm [{T},{D}] {dname} (qwen3-1.7b / harness): "
                f"max_abs_err {e:.3e} (tol {TOL[dname]})")
        for shape in attn:
            B, Sq, Sk, H, KV, Dh, causal = shape
            q, k, v = (randn(B, Sq, H, Dh, dtype=dt),
                       randn(B, Sk, KV, Dh, dtype=dt),
                       randn(B, Sk, KV, Dh, dtype=dt))
            e = compare("flash_attention",
                        ops.flash_attention(q, k, v, causal=causal),
                        ref.flash_attention_ref(q, k, v, causal=causal),
                        dname)
            log("b", f"flash_attention {shape} {dname} (qwen3-1.7b / "
                f"harness): max_abs_err {e:.3e} (tol {TOL[dname]})")
        for T, D, Fo, E in gmm:
            offs = ffn_offsets(T, E).to(dev)
            lhs = randn(T, D, dtype=dt)
            rhs = (randn(E, D, Fo) / math.sqrt(D)).to(dt)
            e = compare("grouped_matmul", ops.grouped_matmul(lhs, rhs, offs),
                        ref.grouped_matmul_ref(lhs, rhs, offs), dname)
            log("b", f"grouped_matmul [{T},{D}]x[{E},{D},{Fo}] {dname} "
                f"(harness): max_abs_err {e:.3e} (tol {TOL[dname]})")
    for S, Q, H, P, N in scan:
        x = randn(1, S, H, P)
        dt = torch.nn.functional.softplus(randn(1, S, H))
        A_log = randn(H) * 0.5
        B, C = randn(1, S, N) / math.sqrt(N), randn(1, S, N) / math.sqrt(N)
        got = ops.ssd_scan(x, dt, A_log, B, C, chunk=Q)
        want = ops.ssd_scan(*(t.cpu() for t in (x, dt, A_log, B, C)),
                            chunk=Q)
        e = max(compare(f"ssd_scan {name}", g.cpu(), w, "float32")
                for name, g, w in zip(("y", "state"), got, want))
        args = ssd_inputs(torch, gen, S // Q, Q, H, P, N)
        y, st = ops.ssd_chunk(*args)
        y64, s64, y_bound, s_bound = ref.ssd_chunk_f64(*args)
        r = max(compare_f64("ssd_chunk y", y, y64, y_bound),
                compare_f64("ssd_chunk state", st, s64, s_bound))
        log("b", f"ssd_scan (S,chunk,H,P,N)={(S, Q, H, P, N)} float32 "
            f"(harness): max_abs_err {e:.3e} against the CPU (tol "
            f"{TOL['float32']}); its ssd_chunk {(S // Q, Q, H, P, N)} "
            f"against f64: max err/bound {r:.3e}")


def time_kernels(torch, ops, ref, dev):
    """Times at the main path's shapes, bf16; returns per-kernel records."""
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    bf = torch.bfloat16
    es = 2
    out = {}

    def record(name, shape, fn, plain, lib, nbytes, flops,
               dtype="bfloat16"):
        ms = timed_ms(torch, fn, flush)
        plain_ms = timed_ms(torch, plain, flush)
        lib_ms = timed_ms(torch, lib, flush) if lib is not None else None
        b_ms, b_by = bound(nbytes, flops, dtype)
        log("b", f"time {name} {shape} {dtype}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b_ms:.4g} ms ({b_by})")
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": b_ms, "bound_by": b_by, "shape": shape}

    # rmsnorm: granite's prefill and decode rows (the summary's record),
    # then mamba2's ln1 and gated-norm rows
    for T, D in ((BATCH * PROMPT, 1024), (BATCH, 1024), (BATCH * PROMPT, 1536),
                 (BATCH * PROMPT, 3072), (BATCH, 3072)):
        x = torch.randn(T, D, generator=gen, device=dev).to(bf)
        w = torch.ones(D, device=dev)
        wb = w.to(bf)
        rec = record("rmsnorm", f"[{T},{D}]", lambda: ops.rmsnorm(x, w),
                     lambda: ref.rmsnorm_ref(x, w),
                     lambda: F.rms_norm(x, (D,), wb, 1e-6),
                     2 * T * D * es + 4 * D, 4 * T * D)
        out.setdefault("rmsnorm", rec)

    # flash attention at prefill; SDPA gets K/V expanded to all heads
    B, S, H, KV, Dh = BATCH, PROMPT, 16, 8, 64
    q = torch.randn(B, S, H, Dh, generator=gen, device=dev).to(bf)
    k = torch.randn(B, S, KV, Dh, generator=gen, device=dev).to(bf)
    v = torch.randn(B, S, KV, Dh, generator=gen, device=dev).to(bf)
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    pairs = S * (S + 1) // 2
    out["flash_attention"] = record(
        "flash_attention", f"q[{B},{S},{H},{Dh}] causal",
        lambda: ops.flash_attention(q, k, v, causal=True),
        lambda: ref.flash_attention_ref(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        (2 * B * S * H * Dh + 2 * B * S * KV * Dh) * es,
        4 * B * H * Dh * pairs)

    # grouped matmul: the gate/up and the down shape at prefill and decode
    for T, D, Fo in ((BATCH * PROMPT * 8, 1024, 512),
                     (BATCH * PROMPT * 8, 512, 1024),
                     (BATCH * 8, 1024, 512), (BATCH * 8, 512, 1024)):
        E = 32
        offs = random_offsets(torch, gen, T, E)
        lhs = torch.randn(T, D, generator=gen, device=dev).to(bf)
        rhs = (torch.randn(E, D, Fo, generator=gen, device=dev)
               / math.sqrt(D)).to(bf)
        counts = (offs[1:] - offs[:-1]).tolist()
        cmax = max(counts)
        padded = lhs.new_zeros(E, cmax, D)
        for e, (lo, n) in enumerate(zip(offs[:-1].tolist(), counts)):
            padded[e, :n] = lhs[lo:lo + n]
        used = sum(1 for n in counts if n)
        rows = int(offs[-1] - offs[0])
        kind = "prefill" if T > 64 else "decode"
        rec = record("grouped_matmul", f"{kind} [{T},{D}]x[{E},{D},{Fo}]",
                     lambda: ops.grouped_matmul(lhs, rhs, offs),
                     lambda: ref.grouped_matmul_ref(lhs, rhs, offs),
                     lambda: torch.bmm(padded, rhs),
                     (rows * D + used * D * Fo + rows * Fo) * es
                     + 4 * (E + 1),
                     2 * rows * D * Fo)
        out.setdefault("grouped_matmul", rec)

    # ssd_chunk at mamba2's prefill, f32; no single PyTorch call computes it
    BC, Q, H, P, N = SSD_MAIN
    args = ssd_inputs(torch, gen, *SSD_MAIN)
    out["ssd_chunk"] = record(
        "ssd_chunk", f"x[{BC},{Q},{H},{P}] N {N}",
        lambda: ops.ssd_chunk(*args), lambda: ref.ssd_chunk_ref(*args), None,
        *ssd_cost(*SSD_MAIN), dtype="float32")
    del flush
    return out


# ------------------------------------------------------------ phase (c)
def profile_window(torch, fn, wall_ms: float, label: str) -> None:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    rows = []
    for evt in prof.key_averages():
        # kernels only: an operator row would count its kernels again
        if evt.device_type != DeviceType.CUDA:
            continue
        t = getattr(evt, "self_device_time_total",
                    getattr(evt, "self_cuda_time_total", 0.0))
        if t > 0:
            rows.append((t / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        log("c", f"profile {label}: wall {wall_ms:.3f} ms (unprofiled), "
            f"device time not measured (the profiler saw no kernel)")
        return
    log("c", f"profile {label}: wall {wall_ms:.3f} ms (unprofiled), kernels "
        f"{busy:.3f} ms in {sum(r[1] for r in rows)} launches (profiled "
        f"run), device idle {max(0.0, 1 - busy / wall_ms) * 100:.1f}%")
    for t, n, key in rows[:12]:
        log("c", f"  {t:10.3f} ms {n:6d}x {key[:90]}")


def main_path(torch, dev, arch: str):
    """Serve ``arch`` at full width; returns the path's launch counts."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models.api import CausalLM

    cfg = configs.get_config(arch)
    model = CausalLM.random(cfg, seed=0, device=dev)
    prompts = make_prompts(cfg, BATCH, PROMPT, seed=1, device=dev)
    generate(model, prompts[:, :16], 2)            # warm-up: cuBLAS, caches
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    res = generate(model, prompts, TOKENS)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    rate = BATCH * (TOKENS - 1) / res.decode_s
    log("c", f"{arch} bf16 batch {BATCH} prompt {PROMPT} tokens {TOKENS}: "
        f"prefill {res.prefill_s * 1e3:.3f} ms, decode {rate:.1f} tok/s, "
        f"peak memory {peak:.2f} GiB")
    want = expected_launches(cfg, TOKENS)
    log("c", f"{arch} launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"{arch}: launch counts {launches} != {want}")
    toks = res.tokens
    if toks.shape != (BATCH, TOKENS) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"bad generated tokens {tuple(toks.shape)}")
    log("c", f"sequence 0: {toks[0].tolist()}")
    logits, _ = model.prefill(prompts, PROMPT)
    if logits.shape != (BATCH, cfg.vocab_size) or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError("prefill logits not finite or misshapen")

    # profiled windows: one prefill, then 8 decode steps
    s_max = PROMPT + 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, caches = model.prefill(prompts, s_max)
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    profile_window(torch, lambda: model.prefill(prompts, s_max), pre_ms,
                   f"{arch} prefill [{BATCH},{PROMPT}]")
    tok = prompts[:, -1]

    def decode8():
        nonlocal caches
        for _ in range(8):
            _, caches = model.decode_step(tok, caches)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode8()
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) * 1e3
    _, caches = model.prefill(prompts, s_max)
    profile_window(torch, decode8, dec_ms,
                   f"{arch} 8 decode steps, batch {BATCH}")
    del model, caches
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase (d)
def whole_model_checks(torch, dev, arch: str, cut_lens, start: int) -> None:
    """f32: a 2-layer full-width cut on the card against the plain path on
    the CPU, from prompts of each length in ``cut_lens`` plus 3 decode
    steps; then at full depth, decode logits against prefill of the
    sequence so far, from a prompt of ``start`` tokens."""
    from repro_torch import configs
    from repro_torch.models import api

    cfg = configs.get_config(arch).replace(dtype="float32")
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)

    cut = cfg.replace(n_layers=2 * cfg.block_size)
    params = api.init(cut, torch.Generator().manual_seed(3), device="cpu")
    cpu_model = api.CausalLM(cut, params)
    gpu_model = api.CausalLM(cut, params).to(dev)
    err = 0.0
    for n in cut_lens:
        lc, cc = cpu_model.prefill(prompt[:, :n], n + 8)
        lg, cg = gpu_model.prefill(prompt[:, :n].to(dev), n + 8)
        err = max(err, float((lg.cpu() - lc).abs().max()))
        for _ in range(3):
            tok = torch.argmax(lc, dim=-1)
            lc, cc = cpu_model.decode_step(tok, cc)
            lg, cg = gpu_model.decode_step(tok.to(dev), cg)
            err = max(err, float((lg.cpu() - lc).abs().max()))
    log("d", f"{arch} {cut.n_layers}-layer f32, prompts of {cut_lens} "
        f"tokens, card vs plain path on the CPU: max abs logit err "
        f"{err:.3e} (bound 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"{arch}: card and CPU paths disagree")
    del cpu_model, gpu_model, params

    # granite: at 8 tokens or fewer no expert can pass the capacity floor
    # of 8, so neither path drops an assignment.
    model = api.CausalLM.random(cfg, seed=5, device=dev)
    seq = prompt[:, :start].to(dev)
    logits, caches = model.prefill(seq, 16)
    err = 0.0
    for _ in range(4):
        tok = torch.argmax(logits, dim=-1)
        logits, caches = model.decode_step(tok, caches)
        seq = torch.cat([seq, tok[:, None]], dim=1)
        full, _ = model.prefill(seq, seq.shape[1])
        err = max(err, float((logits - full).abs().max()))
    label = (f"{arch} {cfg.n_layers}-layer f32, prefill over prompt+generated "
             f"vs decode logits from a {start}-token prompt: max abs err "
             f"{err:.3e}")
    if cfg.family == "ssm":
        # Through 48 random mamba2 layers, f32 rounding is amplified past
        # 1e-4 at the logits: the JAX reference misses 1e-4 on the same
        # weights as well (PERF.md, section 6).  So the bound holds each
        # layer, on the same inputs, instead.
        log("d", f"{label} (measured; the bound is per layer, below)")
        layerwise_decode_vs_prefill(torch, cfg, model.params, seq, start)
    else:
        log("d", f"{label} (bound 1e-4)")
        if not err <= 1e-4:
            raise AssertionError(f"{arch}: decode disagrees with prefill")
    del model, caches
    torch.cuda.empty_cache()


def layerwise_decode_vs_prefill(torch, cfg, params, seq, start: int) -> None:
    """Every SSM layer of the full-depth model: prefill of the first
    ``start`` tokens, then one decode step per further token, against the
    layer's prefill over the whole sequence, on the same layer inputs (the
    prefill path's), within 1e-4 + 1e-4 |out|."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssd
    from repro_torch.models.transformer import block_params

    x = L.embed(params, cfg, seq)
    err = 0.0
    with torch.no_grad():
        for i in range(cfg.n_blocks):
            p = block_params(params, i)["l0"]
            h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
            out, _ = ssd.ssm_prefill(p["ssm"], cfg, h)
            _, cache = ssd.ssm_prefill(p["ssm"], cfg, h[:, :start])
            for t in range(start, seq.shape[1]):
                o, cache = ssd.ssm_decode(p["ssm"], cfg, h[:, t:t + 1], cache)
                err = max(err, compare(f"layer {i} decode step {t}", o[:, 0],
                                       out[:, t], "float32", tol=1e-4))
            x = x + out
    log("d", f"{cfg.name} each of {cfg.n_blocks} layers, decode steps "
        f"{start}..{seq.shape[1] - 1} from a {start}-token prefill vs the "
        f"layer's prefill on the same inputs: max abs err {err:.3e} "
        f"(bound 1e-4 + 1e-4 |out|)")


# ------------------------------------------------------------ phase (e)
def calibration_profiles(torch, dev):
    """The calibration harness on the card for CAL_ARCHS; returns the
    launch counts of its runs, by kernel."""
    from repro_torch.kernels import ops
    from repro_torch.workloads.calibrate import (
        ComputeProfile, _time_call, calibrate, default_cache_path)

    root = ROOT / "build" / "calibration"
    # one empty launch, timed as the windows are (torch.cuda._sleep(0) is a
    # kernel that spins for 0 cycles)
    empty_ns = _time_call(lambda: torch.cuda._sleep(0), CAL_REPS, dev)
    log("e", f"empty launch: {empty_ns:.0f} ns (best of {CAL_REPS}, device "
        f"time by CUDA events behind a spin kernel)")
    # a window is device time: 2 ms on the host ahead of that empty launch
    # must stay out of it
    host_ns = _time_call(lambda: (time.sleep(2e-3), torch.cuda._sleep(0)),
                         CAL_REPS, dev)
    log("e", f"2 ms of host time, then an empty launch: {host_ns:.0f} ns")
    if not host_ns < 2e5:
        raise AssertionError("calibration windows hold host time")
    total = {name: 0 for name in ops.LAUNCHES}
    for arch in CAL_ARCHS:
        path = default_cache_path(arch, CAL_SHAPE, CAL_GPUS, root=root)
        ops.reset_launches()
        prof = calibrate(arch, CAL_SHAPE, n_gpus=CAL_GPUS, reps=CAL_REPS,
                         cache_path=path, force=True, device=dev)
        launches = dict(ops.LAUNCHES)
        want = {name: 0 for name in ops.LAUNCHES}
        for w in prof.phases.values():
            for k in w.kernels:
                # ssd_scan launches the ssd_chunk kernel once a call
                want[{"ssd_scan": "ssd_chunk"}.get(k, k)] += CAL_REPS + 1
        log("e", f"{arch} {CAL_SHAPE} g{CAL_GPUS} (ep={prof.ep} tp={prof.tp} "
            f"dp={prof.dp}) -> {path.relative_to(ROOT)}: launches "
            f"{launches}, expected {want}")
        if launches != want:
            raise AssertionError(f"{arch}: calibration launches {launches} "
                                 f"!= {want}")
        if prof.interpret:
            raise AssertionError(f"{arch}: profile says interpret=True")
        for name, w in sorted(prof.phases.items()):
            log("e", f"  {name:<11s} x{w.layers:3d} layers: roofline "
                f"{w.roofline_ns:.3f} ns, measured {w.measured_wall_ns:.0f} "
                f"ns over {len(w.kernels)} call(s) ({'+'.join(w.kernels)}), "
                f"calibrated {w.calibrated_ns:.3f} ns; one empty launch is "
                f"{100 * empty_ns / w.measured_wall_ns:.1f}% of the window")
            if not w.measured_wall_ns > 0 or (
                    w.roofline_ns > 0 and not w.calibrated_ns > 0):
                raise AssertionError(f"{arch} {name}: empty window")
        roof = sum(w.layers * w.roofline_ns for w in prof.phases.values())
        calib = sum(w.layers * w.calibrated_ns for w in prof.phases.values())
        if not math.isclose(calib, roof, rel_tol=1e-9):
            raise AssertionError(f"{arch}: anchor broken, {calib} != {roof}")
        if ComputeProfile.load(path) != prof:
            raise AssertionError(f"{arch}: the JSON does not round-trip")
        log("e", f"  anchor: sum layers*calibrated {calib:.6f} ns, sum "
            f"layers*roofline {roof:.6f} ns")
        for name in total:
            total[name] += launches[name]
    return total


# ------------------------------------------------------------------ main
def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script measures the "
              "port on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device("cuda")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    build.build_all()
    log("a", f"kernels built in {build.BUILD_SECONDS:.2f} s")
    for name, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("a", f"ptxas {name}: {line.strip()}")

    errs = check_kernels(torch, ops, ref, dev)
    times = time_kernels(torch, ops, ref, dev)
    serving = (ARCH, SSM_ARCH, DENSE_ARCH)
    by_path = {arch: main_path(torch, dev, arch) for arch in serving}
    whole_model_checks(torch, dev, ARCH, (16,), 4)
    whole_model_checks(torch, dev, SSM_ARCH, (16, 2), 2)
    whole_model_checks(torch, dev, DENSE_ARCH, (16,), 4)
    by_path["calibrate"] = calibration_profiles(torch, dev)
    for name in build.KERNELS:
        if not any(by_path[arch][name] for arch in serving):
            raise AssertionError(f"{name}: no serving path launched it")

    kernels = []
    for name in build.KERNELS:
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {a: c[name] for a, c in by_path.items()},
            "max_abs_err": errs[name], **times[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
