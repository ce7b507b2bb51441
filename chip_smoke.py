#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its own lines; any mismatch raises and the script
exits non-zero:

(a) the card's name and power limit (``nvidia-smi``), then the build of the
    CUDA kernels from ``src/repro_torch/kernels/csrc`` and its time;
(b) each kernel against its plain PyTorch version on the card, in f32
    (tolerance 2e-5) and bf16 (2e-2), at the main path's shapes and the
    kernel tests' shapes, with times for the kernel, the plain version, the
    nearest single PyTorch call and the least time the card could take;
(c) the main path: granite-moe-1b-a400m at full width, bf16, seeded random
    weights, prefill of 8 prompts of 512 tokens then 32 greedy tokens, with
    the kernels' launch counts checked against the config, and one profiled
    prefill and decode window (top device ops, device idle share);
(d) whole-model checks in f32: the card against the plain path on the CPU
    (2-layer full-width cut), and decode logits against prefill over the
    prompt plus generated tokens (24 layers).

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

ARCH = "granite-moe-1b-a400m"
BATCH, PROMPT, TOKENS = 8, 512, 32
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm.py:18",
    "flash_attention": "src/repro/kernels/flash_attention.py:27",
    "grouped_matmul": "src/repro/kernels/grouped_matmul.py:25",
}
# test_kernels.py's shapes
ATTN_SHAPES = [(1, 128, 128, 4, 4, 64, True), (2, 256, 256, 8, 2, 64, True),
               (1, 256, 256, 4, 1, 128, True), (2, 128, 128, 4, 4, 128, False),
               (1, 512, 512, 2, 2, 64, True)]
GMM_SHAPES = [(256, 64, 128, 4), (512, 128, 256, 8), (128, 256, 128, 2),
              (384, 64, 128, 6)]


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


def compare(name: str, got, want, dtype: str) -> float:
    tol = TOL[dtype]
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    limit = tol + tol * want.float().abs()
    if not bool((diff <= limit).all()):
        raise AssertionError(f"{name} {dtype}: max_abs_err {err:.3e} "
                             f"exceeds tolerance {tol}")
    return err


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
    from repro_torch.models.transformer import _layer_is_moe
    moe_layers = sum(1 for i in range(cfg.n_layers) if _layer_is_moe(cfg, i))
    return {"rmsnorm": (2 * cfg.n_layers + 1) * n_tokens,
            "flash_attention": cfg.n_layers,
            "grouped_matmul": 3 * moe_layers * n_tokens}


# ------------------------------------------------------------ phase (b)
def check_kernels(torch, ops, ref, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {}          # kernel -> max err at the main path's bf16 shapes

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for T, D in [(BATCH * PROMPT, 1024), (BATCH, 1024), (256, 64),
                     (512, 1024), (256, 3072), (37, 1001)]:
            x, w = randn(T, D, dtype=dt), randn(D, dtype=torch.float32)
            e = compare("rmsnorm", ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w),
                        dname)
            log("b", f"rmsnorm [{T},{D}] {dname}: max_abs_err {e:.3e} "
                f"(tol {TOL[dname]})")
            if dname == "bfloat16" and D == 1024 and T in (BATCH * PROMPT,
                                                           BATCH):
                errs["rmsnorm"] = max(errs.get("rmsnorm", 0.0), e)
        for B, Sq, Sk, H, KV, Dh, causal in (
                [(BATCH, PROMPT, PROMPT, 16, 8, 64, True),
                 (2, 61, 61, 16, 8, 64, True), (1, 100, 300, 4, 2, 64, False)]
                + ATTN_SHAPES):
            q, k, v = (randn(B, Sq, H, Dh, dtype=dt),
                       randn(B, Sk, KV, Dh, dtype=dt),
                       randn(B, Sk, KV, Dh, dtype=dt))
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
        for label, T, D, Fo, E, offs, main in gmm_cases:
            lhs = randn(T, D, dtype=dt)
            rhs = (randn(E, D, Fo, dtype=torch.float32) / math.sqrt(D)).to(dt)
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
    torch.cuda.synchronize()
    return errs


def time_kernels(torch, ops, ref, dev):
    """Times at the main path's shapes, bf16; returns per-kernel records."""
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    bf = torch.bfloat16
    es = 2
    out = {}

    def record(name, shape, fn, plain, lib, nbytes, flops):
        ms = timed_ms(torch, fn, flush)
        plain_ms = timed_ms(torch, plain, flush)
        lib_ms = timed_ms(torch, lib, flush) if lib is not None else None
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        log("b", f"time {name} {shape} bf16: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b_ms:.4f} ms ({b_by})")
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": b_ms, "bound_by": b_by, "shape": shape}

    # rmsnorm: prefill rows and decode rows
    for T in (BATCH * PROMPT, BATCH):
        D = 1024
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

    # grouped matmul: the gate/up shape at prefill and at decode
    for T, D, Fo in ((BATCH * PROMPT * 8, 1024, 512),
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
        f"{busy:.3f} ms (profiled run), device idle "
        f"{max(0.0, 1 - busy / wall_ms) * 100:.1f}%")
    for t, n, key in rows[:12]:
        log("c", f"  {t:10.3f} ms {n:6d}x {key[:90]}")


def main_path(torch, dev):
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models.api import CausalLM

    cfg = configs.get_config(ARCH)
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
    log("c", f"{ARCH} bf16 batch {BATCH} prompt {PROMPT} tokens {TOKENS}: "
        f"prefill {res.prefill_s * 1e3:.3f} ms, decode {rate:.1f} tok/s, "
        f"peak memory {peak:.2f} GiB")
    want = expected_launches(cfg, TOKENS)
    log("c", f"launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
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
                   f"prefill [{BATCH},{PROMPT}]")
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
    profile_window(torch, decode8, dec_ms, f"8 decode steps, batch {BATCH}")
    del model, caches
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase (d)
def whole_model_checks(torch, dev) -> None:
    from repro_torch import configs
    from repro_torch.models import api

    cfg = configs.get_config(ARCH).replace(dtype="float32")
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)

    # 2-layer full-width cut: card (kernels) against CPU (plain versions)
    cut = cfg.replace(n_layers=2)
    params = api.init(cut, torch.Generator().manual_seed(3), device="cpu")
    cpu_model = api.CausalLM(cut, params)
    gpu_model = api.CausalLM(cut, params).to(dev)
    lc, cc = cpu_model.prefill(prompt, 24)
    lg, cg = gpu_model.prefill(prompt.to(dev), 24)
    err = float((lg.cpu() - lc).abs().max())
    for _ in range(3):
        tok = torch.argmax(lc, dim=-1)
        lc, cc = cpu_model.decode_step(tok, cc)
        lg, cg = gpu_model.decode_step(tok.to(dev), cg)
        err = max(err, float((lg.cpu() - lc).abs().max()))
    log("d", f"2-layer f32, card vs plain path on the CPU: max abs logit "
        f"err {err:.3e} (bound 1e-4)")
    if not err <= 1e-4:
        raise AssertionError("card and CPU paths disagree")
    del cpu_model, gpu_model, params

    # 24 layers: decode logits against prefill of the sequence so far.  At
    # 8 tokens or fewer no expert can pass the capacity floor of 8, so
    # neither path drops an assignment.
    model = api.CausalLM.random(cfg, seed=5, device=dev)
    seq = prompt[:, :4].to(dev)
    logits, caches = model.prefill(seq, 16)
    err = 0.0
    for _ in range(4):
        tok = torch.argmax(logits, dim=-1)
        logits, caches = model.decode_step(tok, caches)
        seq = torch.cat([seq, tok[:, None]], dim=1)
        full, _ = model.prefill(seq, seq.shape[1])
        err = max(err, float((logits - full).abs().max()))
    log("d", f"24-layer f32, prefill over prompt+generated vs decode "
        f"logits: max abs err {err:.3e} (bound 1e-4)")
    if not err <= 1e-4:
        raise AssertionError("decode disagrees with prefill")
    del model, caches
    torch.cuda.empty_cache()


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
    launches = main_path(torch, dev)
    whole_model_checks(torch, dev)

    kernels = []
    for name in build.KERNELS:
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], **times[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
