#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its own lines; any mismatch raises and the script
exits non-zero:

(a) the card's name and power limit (``nvidia-smi``) and the host CPU
    (``host_cpu``, which every timed line of the run shares), then the
    build of the CUDA kernels from ``src/repro_torch/kernels/csrc`` and its
    time, each kernel's registers and spills (``-Xptxas -v``), and the
    tensor-core instructions in the SASS (``cuobjdump``) of the bf16
    grouped_matmul kernel in both of its B layouts (the forward's MN-major
    and dX's K-major), the bf16 dW kernel and the attention forward's and
    backward's wgmma kernels (HGMMA), and of the attention backward's
    mma.sync kernels and the split decode kernel (HMMA), each of which must
    hold some; ptxas must
    report no serialized wgmma (notes C7510 to C7520) in the attention
    kernels;
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
    least time the card could take.  flash_attention is also held, and
    timed, at the new paths' shapes (its own generator, seed 6): the
    whisper encoder (q[8,1500,16,64], not causal), its cross-attention at
    prefill and decode (Sq 224 and 1 against 1500 frames), phi-3-vision
    (q[8,768,32,96], causal), a sliding window at jamba's head layout (64
    heads, 8 KV heads, Dh 128, S 8192, window 4096, so key tiles are
    skipped), Dh 96 tile edges, and windows of 1, past the sequence (which
    must equal no window, bit for bit) and not a multiple of a tile; and at
    the split decode route's edges (``ATTN_DECODE_EDGES``, seed 12), where
    the forward's LSE is held to a plain logsumexp too.  Every
    flash_attention and flash_attention_bwd line names the kernels
    ``ops.attention_plan`` and ``ops.attention_bwd_plan`` chose, and every
    timed window opens behind a spin kernel.  The split decode route is also
    timed at every split size it takes against the plan's and SDPA
    (``ATTN_SPLIT_SWEEP``);
(c) the five serving paths, each at full width and full depth, bf16,
    seeded random weights, prefill of 8 prompts of 512 tokens (whisper:
    224, after 1500 frames of ``enc_embeds``; phi-3-vision: after 256
    image tokens of ``img_embeds``) then 32 greedy tokens:
    granite-moe-1b-a400m (rmsnorm, flash_attention, grouped_matmul),
    mamba2-780m (rmsnorm, ssd_chunk), the dense qwen3-1.7b (rmsnorm with
    qk-norm, flash_attention; its FFN is ``torch.matmul``), whisper-medium
    (rmsnorm; flash_attention for the encoder, the decoder's prefill and
    every cross-attention) and phi-3-vision-4.2b (rmsnorm, flash_attention
    at Dh 96).  Each path's launch counts are set to 0 just before it and
    checked against the config just after; each gets one profiled prefill
    and decode window (top device ops, device idle share);
(d) whole-model checks in f32 for the five models and a windowed
    qwen3-1.7b (sliding_window 20, prompts of 200 and 80 tokens, decode
    past the window): the card against the plain path on the CPU (2-layer
    full-width cut; whisper 2 + 2 layers on 1500 frames), and decode
    against prefill over the prompt plus generated tokens at full depth.
    For all but mamba2 the bound holds the logits; for mamba2 it holds
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
    gives each window's launch share;
(k) run right after (e): the port's simulator (``repro_torch.core``,
    ``repro_torch.workloads.derive`` and ``.replay``; host code in numpy,
    no torch) on the card's windows.  Each of (e)'s four profiles is
    derived into 4 decode steps and replayed through persistent Link TLBs
    on both engines, whose ``StepStats`` must be the same bits: each
    step's comm, ideal and compute us, degradation, walks and requests,
    and the cold and steady degradation (granite: cold above steady, no
    walk from token 1 on).  The Fig. 4/5 points (1 MB at 8, 16 and 64
    GPUs) and Fig. 14's single-Clos rows, on both engines, must equal the
    reference's golden numbers (``SIM_FIG45``, ``SIM_FIG14``).  Then both
    engines are timed on the host at the largest replay (host time, on the
    CPU named from ``/proc/cpuinfo``);
(l) run right after (k): the port's serving layer (``repro_torch.serving``,
    host code in numpy, no torch) on (e)'s granite profile.  Fig. 15's
    bursty point (12 requests in bursts of 4, 50 us retention) on
    roofline windows must equal the reference's golden numbers
    (``SERVE_GOLDEN``) on both engines; the same point on the card's
    windows at no retention and at 50 us, a fleet of 2 autoscaled
    replicas (``SERVE_FLEET``) and a 1:1 disaggregated deployment (each of
    the first 8 requests) must give the same bits on both engines, and the
    calibrated points the same bits on a pool of 2 spawned workers.  Each
    prints TTFT p50/p95/p99, the inter-token p50, the mean and p99 TTFT
    degradation, cold steps, cold and warm comm and walks; then the
    largest compute window a single call passes to the session (roofline
    and calibrated, at 1 and 544 tokens) against the retention, whether
    the p99 degradation clears the mean (a finding, not a check), each
    run's host time, the host CPU and the phase's time;
(f) training on the card.  The backward kernels (rmsnorm_bwd,
    flash_attention_bwd from the forward's row logsumexp, grouped_matmul_dx
    reading W^T in place and grouped_matmul_dw) against
    their plain versions (f32: 2e-5, attention 1e-4; bf16 2e-2; each
    relative to max|ref|) at granite's training shapes, qwen3-1.7b's Dh
    128, phi-3's Dh 96, the whisper encoder and its cross-attention, a
    window at jamba's head layout and tile edges (S off the tiles, experts
    with no rows, uncovered rows: zero dX, nothing in dW), and the edges of
    the tensor-core tiles (Sq 65 and 127 at each head dim, a window of 1,
    Sk 0 where no row keeps a key; the wgmma backward's edges,
    ``ATTN_BWD_WGMMA_EDGES``, its route on every line; dW groups of 1 to
    129 rows off the 64-row slices with D and F off the 128 x 256 tile, a
    hot expert, an empty expert between full ones; dX on the decode route,
    T <= 16 E;
    rmsnorm_bwd on each of its routes: a row group of 4, 8, 16 or 32
    lanes, 1 to 8 vectors a lane, the wide route (rows staged in shared
    memory) and the scalar route, one block or many); each twice, bit for
    bit, attention finite; the forward
    with the logsumexp equal to the forward without it, bit for bit; dX
    at granite's training shape allocating no more than its output (no
    copy of W^T); a bf16 dW with D % 8 != 0 raises.  ssd_chunk_bwd
    against its plain version (f32, 1e-4 of max|ref|) and within
    ``ref.ssd_chunk_bwd_f64``'s bound, finite, twice bit for bit, at
    mamba2's training shape (x[16,256,48,64], N 128), the forward's
    tiling edges (``SSD_EDGES``), its own (``SSD_BWD_EDGES``: head groups,
    state splits, rows copied without cp.async), with ds absent, with dy
    absent, and with a of both signs (``SSD_SIGNED``).
    Times of each backward kernel, its plain version, one PyTorch call
    (SDPA's backward, F.rms_norm's backward, a padded bmm; none for
    ssd_chunk_bwd) and its bound, with each kernel's share of rmsnorm_bwd
    (at granite's rows, D 1001 and mamba2's gate rows [4096,3072]), dX,
    flash_attention_bwd (D, dK/dV and dQ at each timed row) and
    ssd_chunk_bwd from the profiler; flash_attention_bwd also at
    qwen3-1.7b's Dh 128 and phi-3's Dh 96, rmsnorm_bwd at every
    ``RMS_BWD`` shape.  Then gradients in f32, the card against the CPU
    (granite and mamba2 cut to 2 layers at full width, mamba2 at 2 x 512
    tokens so that two chunks pass the state; whisper to 2 + 2): the loss
    and every parameter leaf within 1e-4 of its max |g|, each finite and
    not all zero; jamba at smoke size (head dim 64), whose gap is printed
    as a measurement.  Then mamba2-780m and granite-moe-1b-a400m train at
    full width and depth through ``repro_torch.runtime.Trainer`` (bf16
    working params, f32 master, AdamW, batch 8 x 512, remat on) for 6
    steps, the first untimed: step time, tokens/s, peak memory, the
    losses, launches per kernel against the config (mamba2: 96 ssd_chunk
    and 48 ssd_chunk_bwd a step, the ``train_ssm`` path), and one
    profiled step; between them jamba at smoke size trains 3 steps of 4 x
    64 tokens (``train_hybrid``): finite losses, launches against the
    config, ssd_chunk_bwd, flash_attention_bwd and grouped_matmul's dX
    and dW among them;
(g) checkpoints on the card (``repro_torch.checkpoint``, under
    ``build/ckpt``, deleted at the end).  First the state after (f)'s 6
    steps, all 24 layers (about 19 GB): the free space of the directory, a
    synchronous save and a load onto the card, every leaf bit for bit
    (bf16 included), with GB, seconds and GB/s each way; then an async
    save with two training steps running while it writes, their step time
    beside two steps before and two after with no save in flight, and the
    host snapshot's time; that checkpoint loaded must hold the snapshot's
    bits.  Then kill and resume: granite at full width cut to 2 of its 24
    layers, bf16 params, f32 master, AdamW, batch 8 x 512, 8 steps, a
    checkpoint every 4: (A) uninterrupted, (B) the same again, (C) async
    save and a failure injected at step 4, (D) a new Trainer resuming from
    C's directory.  D's data step must equal A's, its losses for steps 4
    to 7 lie within 1e-4 of A's, and the largest |delta| of its final
    params and optimizer state against A's be no larger than B's (both are
    printed).  D's launch counts, set to 0 just before it, must equal the
    config's for 4 steps; they are the ``resume`` path of the kernels line;
(h) expert parallelism on the card: granite-moe-1b-a400m's MoE block at
    full width (d 1024, 32 experts, top-8, F 512, capacity factor 1.25,
    bf16, seeded random weights) through ``moe_block_ep`` on an NCCL group
    of one rank (``launch.mesh``), at one prefill of 8 x 512 tokens (C
    40,960: a [1, 40960, 1024] send buffer) and one decode step of 8 (C
    256).  Each output is held against the same block with the plain
    expert FFN on the card (bf16 2e-2), in f32 against the block on the
    CPU over gloo (2e-5; a token whose top-k set the two devices' f32
    routers choose differently must be a near tie, and is left out), the
    same bits twice, and the same bits under three plans (warm-up, 4
    chunks, both) with flash_attention at q[8,512,16,64] beside the
    dispatch, whose output must equal the attention alone.  grouped_matmul
    is held to its plain version at the receive buffer's shapes (a tail of
    empty slots) and timed there.  Launch counts, set to 0 before the
    drive: grouped_matmul 3 a block call (the ``ep`` path of the kernels
    line).  CUDA-event windows of routing and packing, the dispatch,
    metadata and combine all-to-alls, the expert FFN and the unpack, and
    the dispatch then the attention against the warm-up route; at world
    size 1 an all-to-all is NCCL's self-copy on one card, not a fabric;
(i) sharding on the card: granite-moe-1b-a400m at full width and depth
    through the sharded steps of ``launch.steps`` on a mesh (data 1,
    model 1) of one NCCL rank (``launch.mesh.init_mesh``, a HashStore),
    every gather and reduction of ``parallel.fsdp`` a self-copy.  The
    steps run their tensor-parallel code (``parallel.tp``: attention on
    the local heads, the MoE on the local experts, the vocab-parallel
    embedding, logits and loss, each sublayer ending in one all-reduce
    over ``model``), which at model 1 is the unsharded arithmetic.  The
    sharded Trainer's state is built once alone, for its peak memory.  Three
    train steps of the sharded ``Trainer`` (bf16 params, f32 master,
    AdamW, batch 8 x 512) against three of the unsharded one from the
    same seed, whose losses must be (f)'s first three: the losses within
    1e-4 and the params and optimizer state within 1e-4 (the largest
    |delta| is printed; at one rank they are the same bits), the launch
    counts the config's; the NCCL collectives a step (by kind, and those
    over ``model``), the peak memory of
    each, and the step time of both in four rounds of (unsharded,
    sharded, sharded, unsharded) on one state and batch.  Then the
    sharded prefill of 8 x 512 prompts and 8 greedy decode steps (the
    caches resharded into the serve step's layout between), timed beside
    the unsharded model's: the decode attention computes on its head_dim
    shard of the weights and the cache (``models.layers``; at model 1 the
    whole head_dim, the unsharded arithmetic), so the logits must be the
    unsharded model's bits at the step's cache length (prompt + 128), and
    the greedy tokens (``parallel.tp.greedy_tokens`` over the vocab-local
    logits) ``serve.generate``'s first at that length (its s_max counts
    the tokens it generates, so it generates 120).  The decode's
    collectives a token, by axis and kind, must be the route's: over
    ``model`` three all-gathers (query, new K row, output) and two
    all-reduces (partial logits, the sublayer's sum) an attention layer,
    one all-reduce an MoE layer and one for the embedding.  Then
    whisper-medium, cut to 4 encoder and 4 decoder layers, f32, through
    the sharded prefill and 8 decode steps, its self- and cross-attention
    on their head_dim shards: logits within 1e-4 of the unsharded
    model's, its launches (no kernel in decode's cross-attention on the
    shard) and collectives a token, decode ms of both.  Launch counts, set
    to 0 before the sharded train and serve runs, are the ``sharded``
    path of the kernels line, whisper's its ``sharded_encdec`` path.
    Then mamba2-780m at full width and depth on the same mesh, its SSM
    mixers on their ``ssm_inner`` shard (``models.ssd``; at model 1 every
    head) and its gated norm through the split launches
    (``parallel.tp.ModelAxis.rmsnorm``): 2 sharded train steps against 2
    unsharded ones (params and optimizer state the same bits, launches
    the config's), then the sharded prefill of 8 x 512 and 8 decode steps
    against the unsharded model (the same bits; over ``model`` a token,
    each mixer gathers its new ``xs_raw`` row and ``conv_x`` and sums its
    norm's rows and its output; the ``sharded_ssm`` path, which must
    launch each split launch).  Then each kernel at the ``model``-local
    shapes that model 2, 4 and 16 give granite and qwen3-1.7b, f32 and
    bf16, against its plain version: flash_attention forward and backward
    with 8 q heads over 4 kv heads, 4 over 2 and 1 over 1 (kv replicated),
    at Dh 64 and 128; grouped_matmul with its dX and dW over 16 and 8
    experts; the split norm's four launches at mamba2's d_inner (3072)
    over model 1 to 16 on 4096 and 8 rows, and its scalar and wide routes
    (``SPLIT_RMS``, ``SPLIT_EDGES``): each against its plain version, the
    whole rows against rmsnorm's and rmsnorm_bwd's plain versions, and
    over one rank the one-pass kernels' bits; each timed at 4096 rows over
    model 1 and 16, and the kernels of rmsnorm_part, rmsnorm_bwd_part and
    rmsnorm_bwd_scale there profiled; ssd_chunk and ssd_chunk_bwd on 24, 12, 6 and 3 of
    mamba2's 48 heads (``SSD_LOCAL``) against their plain versions and f64
    bounds, and timed;
(j) the count of a real step against the dry-run's: granite-moe-1b-a400m
    and qwen3-1.7b at full width and depth on the (1, 1) NCCL mesh of (i),
    one sharded train step (bf16, f32 master, AdamW, batch 8 x 512) and one
    prefill of 8 x 512, and mamba2-780m's train step (ssd_chunk and
    ssd_chunk_bwd), each built by ``launch.dryrun.build_cell`` from
    seeded random weights and run once under a ``launch.roofline.Counter``:
    FLOPs by kernel and for aten, HBM bytes, collectives by kind and axis
    with bytes, the peak (``torch.cuda.max_memory_allocated`` above what
    was held before the step's inputs).  The same five cells' dry-run
    (``dryrun.run_cell`` over a fake world at (1, 1) on the meta device,
    in a subprocess that sees no GPU) must count the same aten FLOPs,
    kernel records and collective bytes (granite's grouped matmuls: the
    same launches, their rows, FLOPs and bytes at most the dry-run's
    capacity bound, the difference printed), and a peak within 10% of the
    card's; every launch must be recorded.  Then each step is timed 3
    times with no counter: MFU (model FLOPs over the time at 989 TFLOP/s)
    and the roofline's t_bound over the time.  The counted runs' launches
    are the ``counted`` path of the kernels line.  Phase (a) prints the
    card's memory, which ``launch.roofline.HBM_BYTES`` holds.

``python3 chip_smoke.py --train-ab PARENT`` runs only granite's training
step: ``train_path`` of the checkout at PARENT (an unpacked ``git
archive`` of the parent commit) against this checkout's, each in a fresh
process, in turns parent, change, change, parent.  ``--split-ab PARENT``
does the same with the split norm's times (``time_split_rmsnorm``), and
``--rms-ab PARENT`` with ``RMS_AB``: digests (crc32 of the output bytes)
of rmsnorm_bwd at every ``RMS_BWD`` and ``RMS_BWD_EDGES`` shape and of
rmsnorm_bwd_part and rmsnorm_bwd_scale on the shards of ``SPLIT_RMS`` and
``SPLIT_EDGES``, f32 and bf16, which must be alike in all four runs, then
rmsnorm_bwd's time at every ``RMS_BWD`` shape in bf16, its kernels' device
time at [4096,3072], the
same windows behind a read of the flush buffer rather than its zero fill,
and the split launches' times.  ``--attn-ab PARENT`` with ``ATTN_AB``:
flash_attention's bf16 forward at its six timed rows (``ATTN_ROWS``), then
flash_attention_bwd at its three (``ATTN_BWD_TIMED``) with its launches'
device times, each line with the route it took and the host CPU; no
digest, since the wgmma routes round in another order than the mma.sync
routes.

The last two lines are a ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ARCH, SSM_ARCH, DENSE_ARCH = ("granite-moe-1b-a400m", "mamba2-780m",
                              "qwen3-1.7b")
ENCDEC_ARCH, VLM_ARCH = "whisper-medium", "phi-3-vision-4.2b"
SERVING = (ARCH, SSM_ARCH, DENSE_ARCH, ENCDEC_ARCH, VLM_ARCH)
CAL_ARCHS = ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b", "mamba2-780m",
             "qwen3-1.7b")
CAL_SHAPE, CAL_GPUS, CAL_REPS = "decode_32k", 16, 20
# phase (k): decode steps replayed per profile, and the simulator's golden
# numbers (the reference's tests/test_golden_figs.py): Fig. 4/5 at 1 MB,
# (n_gpus) -> (baseline ns, ideal ns, requests, walks), and Fig. 14's
# single-Clos rows at 1 MB, two iterations, (n_gpus) -> (cold ns, warm ns,
# ideal cold ns, ideal warm ns, walks)
SIM_STEPS = 4
SIM_FIG45 = {8: (3890.0, 2762.32, 3584, 1), 16: (3890.0, 2802.0, 3840, 1),
             64: (3890.0, 2825.04, 4032, 1)}
SIM_FIG14 = {16: (3890.0, 2852.0, 2802.0, 2802.0, 1),
             64: (3890.0, 2875.04, 2825.04, 2825.04, 1)}
# phase (l): Fig. 15's bursty serving point and its golden numbers (the
# reference's tests/test_golden_figs.py, FIG15_POINT and FIG15_GOLDEN), the
# retentions its calibrated run takes (none, and fig15's 50 us), and the
# fleet (2 replicas, autoscaled) and disaggregated (1:1) points, which
# serve the first 8 requests of that stream
SERVE_POINT = dict(arch=ARCH, rps=16.0, arrival="bursty", n_requests=12,
                   seed=7, retention_ns=50_000.0, steps_cap=60, burst_size=4,
                   burstiness=24.0, prompt_mean=128, output_mean=8)
SERVE_GOLDEN = dict(p50=2432782.6667737663, p95=3432839.485653756,
                    p99=3478109.9026029403, mean_deg=1.0583494148024755,
                    p99_deg=1.1010624819242405,
                    cold_comm_ns=7072922.8800069485,
                    warm_comm_ns=66063141.120014586, cold_steps=4, steps=42,
                    walks=288, served=12)
SERVE_RETENTIONS = (None, 50_000.0)
SERVE_SMALL = dict(n_requests=8, steps_cap=40)
# the fleet spins a cold replica up at each queued arrival (a live cap of
# 2, 0.1 ms after the decision) and retires one idle for 50 ms: the
# stream's gaps between bursts are about 240 ms, so replicas churn
SERVE_FLEET = dict(replicas=2, router="least_loaded", autoscale=True,
                   scale_up_queued=0, scale_down_idle_ns=5e7,
                   spinup_latency_ns=1e5)
BATCH, PROMPT, TOKENS = 8, 512, 32
PROMPTS = {ENCDEC_ARCH: 224}          # whisper's decoder prompt; else PROMPT
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm.py:18",
    "flash_attention": "src/repro/kernels/flash_attention.py:27",
    "grouped_matmul": "src/repro/kernels/grouped_matmul.py:25",
    "ssd_chunk": "src/repro/kernels/ssd_scan.py:28",
    # a backward kernel computes the gradient of the TPU kernel's function
    # (the TPU package has none: its models train through plain jnp)
    "rmsnorm_bwd": "src/repro/kernels/rmsnorm.py:18",
    "flash_attention_bwd": "src/repro/kernels/flash_attention.py:27",
    "grouped_matmul_dx": "src/repro/kernels/grouped_matmul.py:25",
    "grouped_matmul_dw": "src/repro/kernels/grouped_matmul.py:25",
    "ssd_chunk_bwd": "src/repro/kernels/ssd_scan.py:28",
    # the two halves each way of a norm whose rows are split over ranks
    "rmsnorm_part": "src/repro/kernels/rmsnorm.py:18",
    "rmsnorm_scale": "src/repro/kernels/rmsnorm.py:18",
    "rmsnorm_bwd_part": "src/repro/kernels/rmsnorm.py:18",
    "rmsnorm_bwd_scale": "src/repro/kernels/rmsnorm.py:18",
}
# the split norm's launches (``parallel.tp.ModelAxis.rmsnorm``)
SPLIT_NAMES = ("rmsnorm_part", "rmsnorm_scale", "rmsnorm_bwd_part",
               "rmsnorm_bwd_scale")
# kernel that is not its own file's name -> that file
SOURCES = {"rmsnorm_bwd": "rmsnorm", "flash_attention_bwd": "flash_attention",
           "grouped_matmul_dx": "grouped_matmul",
           "grouped_matmul_dw": "grouped_matmul", "ssd_chunk_bwd": "ssd_chunk",
           **{n: "rmsnorm" for n in SPLIT_NAMES}}
# the backward kernels, then those of granite's layers (no SSM)
BACKWARD = ("rmsnorm_bwd", "flash_attention_bwd", "grouped_matmul_dx",
            "grouped_matmul_dw", "ssd_chunk_bwd")
GRANITE_BWD = BACKWARD[:4]
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 6
# phase (f): jamba at smoke size (head dim 64, which the attention kernel
# is built for), bf16 params and an f32 master, 3 steps of 4 x 64 tokens
# (4 chunks of its 16-step SSD chunk)
HYBRID_ARCH, HYBRID_STEPS, HYBRID_BATCH, HYBRID_SEQ = (
    "jamba-1.5-large-398b", 3, 4, 64)
# ssd_chunk_bwd at mamba2's training shape: 8 x 512 tokens in chunks of
# 256 -> 16 (batch, chunk) cells of 48 heads of P 64, N 128; its checks
# hold every output within SSD_BWD_TOL of max |ref| in f32
SSD_TRAIN = (TRAIN_BATCH * TRAIN_SEQ // 256, 256, 48, 64, 128)
SSD_BWD_TOL = 1e-4
# phase (g): granite cut to 2 of its 24 layers (checkpoints near 3 GB; 4
# until mamba2's sharded phase joined (i)), 8 steps, a checkpoint every 4;
# checkpoints go under build/ckpt
RESUME_LAYERS, RESUME_STEPS, RESUME_EVERY = 2, 8, 4
# phase (h): granite's MoE block through moe_block_ep at one prefill of
# 8 x 512 tokens and one decode step of 8
EP_TOKENS = (BATCH * PROMPT, BATCH)
CKPT_ROOT = ROOT / "build" / "ckpt"
# phase (i): granite sharded over a (data, model) mesh of one NCCL rank:
# train steps, decode steps after the prefill, rounds of the step A/B
SHARD_STEPS, SHARD_DECODE, SHARD_AB = 3, 8, 4
# phase (i): whisper-medium's sharded serving cut to 4 encoder and 4
# decoder layers
SHARD_ENCDEC_LAYERS = 4
# phase (i): the kernels at the model-local shapes of tensor-parallel
# compute.  flash_attention as (B, S, q heads, kv heads, Dh), causal: the 16
# q heads and 8 kv heads of granite (Dh 64) and qwen3-1.7b (Dh 128) over
# model 2 and 4, and over 16, where the kv heads are replicated and a rank
# reads the one its q head maps to.  grouped_matmul with its dX and dW as
# (T, D, F, groups): granite's 32 experts over model 2 and 4, each rank
# the local experts' share of a training step's 32,768 assignments
# phase (j): the counted steps at full width and depth on a (1, 1) NCCL
# mesh, as (name, kind, seq_len, global batch); each counted once, then
# timed COUNT_TIMED times with no counter
COUNT_SHAPES = (("count_train", "train", TRAIN_SEQ, TRAIN_BATCH),
                ("count_prefill", "prefill", PROMPT, BATCH))
# (arch, shape): granite's and qwen3-1.7b's train step and prefill, and
# mamba2's train step (ssd_chunk and ssd_chunk_bwd)
COUNT_CELLS = tuple((a, s) for a in (ARCH, DENSE_ARCH) for s in COUNT_SHAPES
                    ) + ((SSM_ARCH, COUNT_SHAPES[0]),)
COUNT_TIMED = 3
COUNT_PEAK_TOL = 0.10
TP_ATTN = [(TRAIN_BATCH, TRAIN_SEQ, hq, kv, dh) for dh in (64, 128)
           for hq, kv in ((8, 4), (4, 2), (1, 1))]
TP_GMM = [(TRAIN_BATCH * TRAIN_SEQ * 8 // m, d, f, 32 // m)
          for m in (2, 4) for d, f in ((1024, 512), (512, 1024))]
# phase (i): the split gated norm as (T, D): mamba2's d_inner at training's
# and prefill's 8 x 512 rows and at decode's 8, its columns split over
# model 1 to 16 (SPLIT_MODELS); then its routes over model 1 and 2: rows
# off the vectors (D 1001, the scalar route; model 1 only) and wide rows
# (D 12288); the record of the kernels line is mamba2's rows over model 16
SPLIT_RMS = ((TRAIN_BATCH * TRAIN_SEQ, 3072), (BATCH, 3072))
SPLIT_MODELS = (1, 2, 4, 8, 16)
SPLIT_EDGES = ((37, 1001), (64, 12288))
SPLIT_TIMED = (TRAIN_BATCH * TRAIN_SEQ, 3072, 16)
# phase (i): ssd_chunk and ssd_chunk_bwd on a model rank's heads of
# mamba2's training shape, its 48 heads over model 2, 4, 8 and 16
SSD_LOCAL = [(SSD_TRAIN[0], SSD_TRAIN[1], SSD_TRAIN[2] // m, SSD_TRAIN[3],
              SSD_TRAIN[4]) for m in (2, 4, 8, 16)]
# phase (i): mamba2-780m's sharded train steps (at full depth) and, after
# its prefill, decode steps
SHARD_SSM_STEPS = 2
SPIN_CYCLES = 2_000_000      # about 1 ms of spin at the H100's clocks
BWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ATTN_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# flash_attention_bwd checks as (B, Sq, Sk, H, KV, Dh, causal, window):
# granite's training shape, qwen3-1.7b (Dh 128), phi-3-vision (Dh 96), the
# whisper encoder (not causal, S 1500) and its cross-attention (224 queries
# against 1500 frames), a window at jamba's head layout (S cut to 1024), and
# tile edges: S off the 64- and 32-row tiles, causal and not
ATTN_BWD = [(TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 8, 64, True, 0),
            (2, 512, 512, 16, 8, 128, True, 0),
            (2, 768, 768, 32, 32, 96, True, 0),
            (2, 1500, 1500, 16, 16, 64, False, 0),
            (2, 224, 1500, 16, 16, 64, False, 0),
            (1, 1024, 1024, 64, 8, 128, True, 256),
            (2, 61, 61, 8, 2, 64, True, 0),
            (1, 129, 77, 6, 3, 96, False, 0),
            (1, 200, 200, 4, 1, 128, True, 33)]
# the tensor-core backward's tiles: Sq 65 and 127 about its 64-key
# and 64- or 32-row tiles at each head dim, causal and not; a window of 1
# with GQA (each row keeps its own key only, so dq and dk are 0 up to
# rounding and are held against the size of the terms that cancel); and
# Sk 0, where no row keeps a key (LSE +inf): zero dq, no NaN
ATTN_BWD_EDGES = [(2, 65, 65, 8, 2, 64, True, 0),
                  (2, 127, 127, 8, 4, 64, False, 0),
                  (2, 65, 65, 8, 8, 96, False, 0),
                  (1, 127, 127, 8, 2, 96, True, 0),
                  (1, 65, 65, 4, 4, 128, True, 0),
                  (2, 127, 127, 8, 2, 128, False, 0),
                  (2, 300, 300, 8, 2, 64, True, 1),
                  (1, 65, 0, 4, 2, 64, False, 0)]
# the wgmma backward's edges (bf16; taken where a (b, kv head) has 64 rows
# or more, G <= 64): exactly 64 rows (Sq 32, G 2) and 63 (mma.sync); 65
# rows with G 1; G 8 with Sq 17; Dh 96 at Sq 129, causal and not; Dh 128
# with Sk off the key tiles, not causal, Sq != Sk (100 against 300), and
# below a dK/dV block (77 keys); groups that do not divide a 64-row step (G
# 3: 63 rows; G 12: 60), whose last rows are zeros; a window of 65 crossing
# a tile with GQA at Dh 64 and 128; a window of 1 with GQA at Dh 128, held
# against the cancelled terms
ATTN_BWD_WGMMA_EDGES = [(2, 32, 32, 4, 2, 64, True, 0),
                        (1, 63, 63, 4, 4, 64, True, 0),
                        (2, 65, 65, 4, 4, 64, True, 0),
                        (2, 17, 17, 16, 2, 128, True, 0),
                        (1, 129, 129, 4, 4, 96, False, 0),
                        (2, 129, 129, 4, 2, 96, True, 0),
                        (2, 100, 300, 8, 4, 128, False, 0),
                        (1, 200, 77, 4, 1, 128, False, 0),
                        (1, 100, 100, 6, 2, 64, True, 0),
                        (1, 50, 50, 12, 1, 128, False, 0),
                        (1, 300, 300, 8, 2, 64, True, 65),
                        (2, 300, 300, 8, 2, 128, True, 65),
                        (1, 150, 150, 8, 4, 128, True, 1)]
# flash_attention_bwd also timed at qwen3-1.7b's Dh 128 and phi-3's Dh 96,
# as (B, S, H, KV, Dh), causal
ATTN_BWD_TIMED = [(TRAIN_BATCH, TRAIN_SEQ, 16, 8, 64),
                  (TRAIN_BATCH, TRAIN_SEQ, 16, 8, 128),
                  (TRAIN_BATCH, 768, 32, 32, 96)]
# grouped_matmul_dw about its wgmma tiles, as (label, T, D, F,
# offsets): groups of 1, 63, 64, 65, 127, 128 and 129 rows, each starting
# off a 64-row slice, with D and F off the 128 x 256 tile; one hot expert
# with most of T; an empty expert between two full ones
_SIZES = (1, 63, 64, 65, 127, 128, 129)
GMM_DW_EDGES = [
    (f"groups {list(_SIZES)} from row 3, D 200, F 328", 591, 200, 328,
     [3 + sum(_SIZES[:i]) for i in range(len(_SIZES) + 1)]),
    ("a hot expert", 4096, 256, 512, [0, 10, 20, 3900, 3950, 4000, 4030,
                                      4060, 4096]),
    ("an empty expert between two full ones", 700, 136, 200,
     [0, 300, 300, 700])]
# rmsnorm_bwd as [T, D]: granite's training rows, qwen3-1.7b's, mamba2's,
# qwen3's qk-norm rows, edges (D off the vectors, few rows), and mamba2's
# gate norm unsplit (its wide route)
RMS_BWD = [(TRAIN_BATCH * TRAIN_SEQ, 1024), (4096, 2048), (4096, 1536),
           (4096 * 16, 128), (37, 1001), (5, 64), (4096, 3072)]
# rmsnorm_bwd about its routes: rows not a multiple of a block's (D 1001 off
# the vectors, T 4097), row groups of 16 and 4 lanes (D 128, 24), 2 vectors
# a lane (D 512), the wide route with aligned rows (D 3072 in bf16; 2048 in
# f32), one row; then RMS_UNALIGNED's x, one element in (not 16-byte
# aligned)
RMS_BWD_EDGES = [(300, 1001), (129, 128), (5, 3072), (4097, 1024),
                 (70, 24), (33, 512), (600, 2048), (1, 1024)]
# grouped_matmul_dx on its decode route (T <= 16 E), as (T, D, F, E):
# dY[T,F] W^T with W [E,D,F], granite's two expert shapes and D, F off the
# 64-column tiles, with an uncovered head and tail
GMM_DX_DECODE = [(64, 1024, 512, 32), (64, 512, 1024, 32), (48, 136, 200, 6)]
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
# flash_attention at the new paths' shapes, as (B, Sq, Sk, H, KV, Dh, causal,
# window): the whisper encoder, its cross-attention at prefill and decode,
# phi-3-vision's prefill, and a sliding window at jamba's head layout; each
# is timed too
ATTN_NEW = [(8, 1500, 1500, 16, 16, 64, False, 0),
            (8, 224, 1500, 16, 16, 64, False, 0),
            (8, 1, 1500, 16, 16, 64, False, 0),
            (8, 768, 768, 32, 32, 96, True, 0),
            (1, 8192, 8192, 64, 8, 128, True, 4096)]
# Dh 96 about the 64-key and 16-row tiles, causal and not (Sq != Sk); then
# windows of 1, not a multiple of a tile (65, 100), equal to S and past it
ATTN_NEW_EDGES = [(2, 61, 61, 8, 8, 96, True, 0),
                  (2, 129, 129, 8, 4, 96, True, 0),
                  (2, 129, 77, 8, 4, 96, False, 0),
                  (1, 128, 128, 4, 4, 96, True, 0),
                  (2, 300, 300, 8, 2, 64, True, 1),
                  (1, 1000, 1000, 4, 2, 96, True, 100),
                  (1, 257, 257, 8, 1, 128, True, 65),
                  (2, 300, 300, 8, 2, 64, True, 300),
                  (1, 200, 200, 4, 4, 96, True, 1000)]
# flash_wgmma_kernel's edges (bf16; rows = Sq x G, taken when a (b, kv head)
# has 64 or more): 64 and 128 rows exactly, at Dh 64, 96 and 128; rows one
# past (65, 66, 129); G 8 with Sq 17 (136 rows: 16 queries a block) and with
# a window; Dh 96 with Sq 129; Sk off the 128-key tile, and below one tile;
# causal rows whose queries straddle a key tile; a window of 65 at Dh 128;
# groups that do not divide 128 rows (G 3: 126 rows a block; G 12: 120);
# 63 rows (flash_mma_kernel), beside them
ATTN_WGMMA_EDGES = [(2, 32, 32, 4, 2, 64, True, 0),
                    (1, 64, 64, 8, 8, 128, False, 0),
                    (2, 64, 64, 4, 2, 64, True, 0),
                    (1, 128, 128, 4, 4, 96, False, 0),
                    (2, 65, 65, 4, 4, 64, True, 0),
                    (2, 33, 33, 8, 4, 128, False, 0),
                    (1, 129, 129, 4, 4, 64, True, 0),
                    (2, 17, 17, 16, 2, 128, True, 0),
                    (1, 300, 300, 8, 1, 64, True, 100),
                    (1, 129, 129, 4, 4, 96, False, 0),
                    (2, 129, 129, 4, 2, 96, True, 0),
                    (2, 100, 300, 8, 4, 96, False, 0),
                    (1, 200, 77, 4, 1, 128, False, 0),
                    (1, 200, 200, 4, 2, 64, True, 0),
                    (2, 300, 300, 8, 2, 128, True, 65),
                    (1, 100, 100, 6, 2, 64, True, 0),
                    (1, 50, 50, 12, 1, 128, False, 0),
                    (1, 63, 63, 4, 4, 64, True, 0)]
# the split decode route (bf16, not causal, Sq x G <= 16 rows a (b, kv
# head), Sk >= 128) about its plan: Sq 1 with G 1, 2 and 8 at Dh 64, 96 and
# 128; Sk 4097 (off a tile and off a split) at G 8 and at KV 1; 16 rows (Sq
# 2, G 8); Sk 128, its least; Sk 129 (3 splits of 64 keys, the last one
# key); 140000 keys of one head (8 tiles a split, so each warp runs two);
# beside it on mma.sync: 17 rows, Sk 127, and causal decode (Sq = Sk = 1)
ATTN_DECODE_EDGES = [(2, 1, 1500, H, KV, Dh, False, 0)
                     for Dh in (64, 96, 128)
                     for H, KV in ((4, 4), (8, 4), (16, 2))] + [
                        (1, 1, 4097, 16, 2, 128, False, 0),
                        (1, 1, 4097, 8, 1, 64, False, 0),
                        (2, 2, 1500, 16, 2, 64, False, 0),
                        (3, 1, 128, 4, 4, 128, False, 0),
                        (1, 1, 129, 4, 4, 64, False, 0),
                        (1, 1, 140000, 1, 1, 64, False, 0),
                        (2, 17, 1500, 4, 4, 64, False, 0),
                        (2, 1, 127, 8, 8, 64, False, 0),
                        (2, 1, 1, 8, 2, 64, True, 0)]
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
# ssd_chunk_bwd about its own plan (csrc/ssd_chunk.cu), beside SSD_EDGES (H
# 1, 3, 9 one past a dx group of 8, 13 one past a pairs group of 12, 50; Q
# 1, 65, 1024; P 30, N 18 off 16-byte rows): one head past a state split of
# 24 (H 25) with P off 16-byte rows alone; fewer heads than a dx group (H
# 5) with N off 16-byte rows alone; one whole split and two whole pairs
# groups (H 24); and the most splits and groups (H 129: six splits, eleven
# groups, Q 64).  Then a of both signs (SSD_SIGNED): a_cum is not monotone,
# and decays above 1 occur.
SSD_BWD_EDGES = [(1, 192, 25, 66, 128), (2, 64, 5, 64, 62),
                 (2, 128, 24, 64, 128), (1, 64, 129, 64, 64)]
SSD_SIGNED = (2, 256, 13, 64, 128)


def log(phase: str, msg: str) -> None:
    print(f"({phase}) {msg}", flush=True)


# ----------------------------------------------------------------- helpers
def timed_ms(torch, fn, flush, iters: int = 20, warmup: int = 3,
             spin: bool = False) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around each call,
    with L2 flushed before each (the main path meets its weights cold).
    With ``spin``, a spin kernel of about 1 ms is queued ahead of each
    start event, so that the host's dispatch of a call made of many
    launches (an autograd backward) stays out of its window."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


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


def expected_launches(cfg, n_tokens: int, on_shard: bool = False):
    """Kernel launches for one prefill and n_tokens - 1 decode steps.  An
    image prefix changes no count (a launch covers every position).
    ``on_shard``: the sharded steps, whose decode cross-attention runs on
    its head_dim shard, not through the kernel, and whose SSM mixers
    split their gated norm over ``model`` (two launches a token)."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import _has_ffn, _layer_is_moe
    want = {name: 0 for name in ops.KERNEL_NAMES}
    want["rmsnorm"] = n_tokens                        # final norm each token
    if cfg.is_encoder_decoder:
        qk = 2 if cfg.qk_norm else 0
        # encoder, prefill only: ln1 (+ qk-norm), ln2, attention; enc_norm
        want["rmsnorm"] += cfg.n_enc_layers * (2 + qk) + 1
        want["flash_attention"] += cfg.n_enc_layers
        # decoder: ln1 (+ qk-norm), ln_x, ln2 each token; self-attention
        # through the kernel at prefill, cross-attention at every token
        # (at prefill only on the shard)
        want["rmsnorm"] += cfg.n_layers * (3 + qk) * n_tokens
        want["flash_attention"] += cfg.n_layers * (
            2 if on_shard else 1 + n_tokens)
        return want
    for i in range(cfg.n_layers):
        kind = cfg.pattern[i % cfg.block_size]
        norms = 1                                     # ln1
        if kind == "attn":
            norms += 2 if cfg.qk_norm else 0
            want["flash_attention"] += 1              # prefill only
        elif on_shard:                                # split gated norm
            want["rmsnorm_part"] += n_tokens
            want["rmsnorm_scale"] += n_tokens
            want["ssd_chunk"] += 1
        else:
            norms += 1                                # gated norm
            want["ssd_chunk"] += 1                    # prefill only
        if _has_ffn(cfg):
            norms += 1                                # ln2
            if _layer_is_moe(cfg, i % cfg.block_size):
                want["grouped_matmul"] += 3 * n_tokens
        want["rmsnorm"] += norms * n_tokens
    return want


def expected_train_launches(cfg, steps: int, on_shard: bool = False):
    """Kernel launches of ``steps`` training steps: each layer's forward
    kernels run twice with remat (the forward, then again in the backward
    pass), each backward kernel once; the final norm is outside the
    remat.  An attention layer runs flash_attention (and qk-norms), an SSM
    layer ssd_chunk and its gated norm (``on_shard``: split over
    ``model``, two launches each way)."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import _has_ffn, _layer_is_moe
    per = {name: 0 for name in ops.KERNEL_NAMES}
    per["rmsnorm"] = per["rmsnorm_bwd"] = 1           # the final norm
    again = 2 if cfg.remat else 1
    for i in range(cfg.n_layers):
        norms = 1                                     # ln1
        if cfg.pattern[i % cfg.block_size] == "attn":
            norms += 2 if cfg.qk_norm else 0
            per["flash_attention"] += again
            per["flash_attention_bwd"] += 1
        else:
            if on_shard:                              # split gated norm
                for name in SPLIT_NAMES:
                    per[name] += 1 if "bwd" in name else again
            else:
                norms += 1                            # gated norm
            per["ssd_chunk"] += again
            per["ssd_chunk_bwd"] += 1
        if _has_ffn(cfg):
            norms += 1                                # ln2
            if _layer_is_moe(cfg, i % cfg.block_size):
                per["grouped_matmul"] += 3 * again
                per["grouped_matmul_dx"] += 3
                per["grouped_matmul_dw"] += 3
        per["rmsnorm"] += norms * again
        per["rmsnorm_bwd"] += norms
    return {name: n * steps for name, n in per.items()}


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


# ------------------------------------------------------------ phase (a)
# kernels whose SASS must hold tensor-core instructions: (library, opcode,
# kernel names); every instantiation of each is counted
TENSOR_CORE_KERNELS = (
    ("grouped_matmul", "HGMMA", ("gmm_wgmma_kernel", "gmm_dw_wgmma_kernel")),
    ("flash_attention", "HMMA", ("flash_bwd_dkdv_mma_kernel",
                                 "flash_bwd_dq_mma_kernel",
                                 "flash_decode_split_kernel")),
    ("flash_attention", "HGMMA", ("flash_wgmma_kernel",
                                  "flash_bwd_dkdv_wgmma_kernel",
                                  "flash_bwd_dq_wgmma_kernel")))
# ptxas's notes that it made every wgmma of a kernel wait for the one before
# ("Potential Performance Loss: wgmma.mma_async instructions are
# serialized"), which phase (a) refuses in the attention kernels
SERIAL_NOTES = tuple(f"C75{i}" for i in range(10, 21))


def kernel_label(mangled: str) -> str:
    """``flash_bwd_dq_mma_kernel<128>`` from a mangled kernel name."""
    import re
    # _ZN <len><anonymous namespace> <len><name> [I <template args> E] ...
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    i = m.end() + int(m.group(1))
    m = re.match(r"\d+", mangled[i:])
    if not m:
        return mangled
    start = i + m.end()
    name = mangled[start:start + int(m.group(0))]
    rest = mangled[start + int(m.group(0)):]
    if not rest.startswith("I"):
        return name
    args = re.findall(r"Li(\d+)E", rest)
    if rest.startswith("If"):
        args.insert(0, "f32")
    elif rest.startswith("I13__nv_bfloat16"):
        args.insert(0, "bf16")
    return f"{name}<{','.join(args)}>"


def ptxas_report(text: str):
    """(kernel, registers, spill line) for each entry in nvcc's ``-Xptxas
    -v`` output."""
    import re
    out, kernel, spills = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel, spills = kernel_label(m.group(1)), ""
        elif "spill stores" in line:
            spills = line.strip()
        else:
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                out.append((kernel, int(m.group(1)), spills))
    return out


def sass_counts(text: str, opcode: str):
    """{kernel: number of ``opcode`` instructions} in cuobjdump's SASS."""
    import re
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = kernel_label(m.group(1))
            counts[cur] = 0
        elif cur is not None and re.search(rf"\b{opcode}\.", line):
            counts[cur] += 1
    return counts


def check_tensor_core_sass(build) -> None:
    """Phase (a): the bf16 grouped_matmul kernel's SASS (both B layouts:
    ``<0>`` the forward, ``<1>`` dX), the dW kernel's and the attention
    forward's wgmma kernel's hold HGMMA (wgmma), and the attention backward
    kernels' and the split decode kernel's HMMA (mma.sync), every
    instantiation."""
    for lib, opcode, kernels in TENSOR_CORE_KERNELS:
        counts = sass_counts(build.sass(lib), opcode)
        for kernel in kernels:
            found = {k: n for k, n in counts.items()
                     if k.startswith(kernel + "<") or k == kernel}
            log("a", f"SASS {kernel}: {opcode} "
                f"{', '.join(f'{k} {n}' for k, n in sorted(found.items()))}")
            if not found or min(found.values()) == 0:
                raise AssertionError(f"{kernel}: no {opcode} in its SASS "
                                     f"({found})")
    notes = [ln.strip() for ln in
             build.BUILD_LOG.get("flash_attention", "").splitlines()
             if any(f"({n})" in ln for n in SERIAL_NOTES)]
    log("a", f"ptxas flash_attention: {len(notes)} notes of serialized wgmma "
        f"({SERIAL_NOTES[0]} to {SERIAL_NOTES[-1]})")
    if notes:
        raise AssertionError(f"flash_attention: ptxas serialized wgmma: "
                             f"{notes[0][:300]}")


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
                        attention_twice(torch, ops, q, k, v, causal, 0),
                        ref.flash_attention_ref(q, k, v, causal=causal),
                        dname)
            log("b", f"flash_attention {(B, Sq, Sk, H, KV, Dh, causal)} "
                f"{dname}: max_abs_err {e:.3e} (tol {TOL[dname]}), route "
                f"{ops.attention_plan(B, Sq, Sk, H, KV, Dh, dt, causal)}")
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
    """Times at the main path's shapes, bf16; returns per-kernel records.
    Device time: each window opens behind a spin kernel (``timed_ms``)."""
    from repro_torch.launch import roofline as rl
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    bf = torch.bfloat16
    es = 2
    out = {}

    def record(name, shape, fn, plain, lib, nbytes, flops,
               dtype="bfloat16"):
        ms = timed_ms(torch, fn, flush, spin=True)
        plain_ms = timed_ms(torch, plain, flush, spin=True)
        lib_ms = (timed_ms(torch, lib, flush, spin=True) if lib is not None
                  else None)
        b_ms, b_by = rl.bound_ms(nbytes, flops, dtype)
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
                     *rl.rmsnorm_cost(T, D, es))
        out.setdefault("rmsnorm", rec)

    # flash attention at prefill; SDPA gets K/V expanded to all heads
    B, S, H, KV, Dh = BATCH, PROMPT, 16, 8, 64
    q = torch.randn(B, S, H, Dh, generator=gen, device=dev).to(bf)
    k = torch.randn(B, S, KV, Dh, generator=gen, device=dev).to(bf)
    v = torch.randn(B, S, KV, Dh, generator=gen, device=dev).to(bf)
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    out["flash_attention"] = record(
        "flash_attention", f"q[{B},{S},{H},{Dh}] causal, route "
        f"{ops.attention_plan(B, S, S, H, KV, Dh, bf, True)}",
        lambda: ops.flash_attention(q, k, v, causal=True),
        lambda: ref.flash_attention_ref(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        *rl.attention_cost(B, S, S, H, KV, Dh, True, 0, es))

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
                     *rl.gmm_cost(T, D, Fo, E, rows, used, es))
        out.setdefault("grouped_matmul", rec)

    # ssd_chunk at mamba2's prefill, f32; no single PyTorch call computes it
    BC, Q, H, P, N = SSD_MAIN
    args = ssd_inputs(torch, gen, *SSD_MAIN)
    out["ssd_chunk"] = record(
        "ssd_chunk", f"x[{BC},{Q},{H},{P}] N {N}",
        lambda: ops.ssd_chunk(*args), lambda: ref.ssd_chunk_ref(*args), None,
        *rl.ssd_cost(*SSD_MAIN), dtype="float32")
    del flush
    return out


def attention_plain(torch, ref, q, k, v, causal: bool, window: int):
    """The plain version one KV head (and its q heads) at a time, so that
    its f32 scores stay a few GB at S 8192; the same function."""
    G = q.shape[2] // k.shape[2]
    return torch.cat([ref.flash_attention_ref(
        q[:, :, h * G:(h + 1) * G], k[:, :, h:h + 1], v[:, :, h:h + 1],
        causal=causal, window=window) for h in range(k.shape[2])], dim=2)


def attention_twice(torch, ops, q, k, v, causal: bool, window: int):
    """flash_attention's output; in bf16 a second call must give the same
    bits (every output element has one owner and a fixed order)."""
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    if q.dtype == torch.bfloat16 and not torch.equal(
            got, ops.flash_attention(q, k, v, causal=causal, window=window)):
        raise AssertionError(f"flash_attention q{list(q.shape)} "
                             f"k{list(k.shape)}: two calls differ")
    return got


def attention_lse_plain(torch, q, k, causal: bool, window: int):
    """[B,H,Sq] f32: each row's logsumexp of its scaled, masked scores, +inf
    where no key is kept (the forward kernel's LSE)."""
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * Dh ** -0.5
    if causal:
        i = torch.arange(Sq, device=q.device)[:, None]
        j = torch.arange(Sk, device=q.device)[None, :]
        keep = j <= i
        if window:
            keep &= j > i - window
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    return lse.masked_fill(torch.isneginf(lse), float("inf"))


def check_wgmma_attention(torch, ops, ref, dev) -> None:
    """flash_attention in bf16 at ``ATTN_WGMMA_EDGES`` against the plain
    version (``TOL``), twice the same bits, the output with the LSE equal to
    the output without, and the LSE within 2e-3 of the plain one (+inf on
    the same rows).  Its own generator (seed 8), so every earlier check
    keeps its inputs."""
    gen = torch.Generator(device=dev).manual_seed(8)
    for shape in ATTN_WGMMA_EDGES:
        B, Sq, Sk, H, KV, Dh, causal, window = shape
        q, k, v = (torch.randn(*sh, generator=gen, device=dev).to(
            torch.bfloat16) for sh in ((B, Sq, H, Dh), (B, Sk, KV, Dh),
                                       (B, Sk, KV, Dh)))
        got = attention_twice(torch, ops, q, k, v, causal, window)
        e = compare("flash_attention", got,
                    attention_plain(torch, ref, q, k, v, causal, window),
                    "bfloat16")
        o, lse = ops.flash_attention_fwd(q, k, v, causal=causal,
                                         window=window, with_lse=True)
        if not torch.equal(o, got):
            raise AssertionError(f"flash_attention {shape}: the forward with "
                                 f"the LSE differs")
        want = attention_lse_plain(torch, q, k, causal, window)
        inf = torch.isinf(want)
        if not torch.equal(torch.isinf(lse), inf):
            raise AssertionError(f"flash_attention {shape}: the LSE's +inf "
                                 f"rows differ")
        le = float((lse - want)[~inf].abs().max()) if bool((~inf).any()) \
            else 0.0
        if not le <= 2e-3:
            raise AssertionError(f"flash_attention {shape}: LSE err {le:.3e}")
        log("b", f"flash_attention {shape} bfloat16: max_abs_err {e:.3e} "
            f"(tol {TOL['bfloat16']}), LSE err {le:.3e} (tol 2e-3); twice "
            f"the same bits; with the LSE the same bits; route "
            f"{ops.attention_plan(B, Sq, Sk, H, KV, Dh, q.dtype, causal)}")
        del q, k, v, got, o, lse, want
    torch.cuda.synchronize()


def check_new_attention(torch, ops, ref, dev) -> None:
    """flash_attention at ATTN_NEW, ATTN_NEW_EDGES and ATTN_DECODE_EDGES,
    f32 and bf16, against the plain version (``attention_plain``); a window
    of S or more must give the unwindowed kernel's output bit for bit.  At
    the decode edges the forward with the LSE must give the same output,
    and its LSE must be within ``ATTN_BWD_TOL`` of ``attention_lse_plain``
    (+inf on the same rows).  Its own generators (seed 6, and seed 12 for
    the decode edges), so every earlier check keeps its inputs."""
    gen = torch.Generator(device=dev).manual_seed(6)
    dec_gen = torch.Generator(device=dev).manual_seed(12)
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for i, shape in enumerate(ATTN_NEW + ATTN_NEW_EDGES
                                  + ATTN_DECODE_EDGES):
            decode = i >= len(ATTN_NEW) + len(ATTN_NEW_EDGES)
            B, Sq, Sk, H, KV, Dh, causal, window = shape
            q, k, v = (torch.randn(*sh, generator=dec_gen if decode else gen,
                                   device=dev).to(dt)
                       for sh in ((B, Sq, H, Dh), (B, Sk, KV, Dh),
                                  (B, Sk, KV, Dh)))
            got = attention_twice(torch, ops, q, k, v, causal, window)
            e = compare("flash_attention", got,
                        attention_plain(torch, ref, q, k, v, causal, window),
                        dname)
            lse_note = ""
            if decode:
                o, lse = ops.flash_attention_fwd(q, k, v, causal=causal,
                                                 window=window, with_lse=True)
                if not torch.equal(o, got):
                    raise AssertionError(f"flash_attention {shape} {dname}: "
                                         f"the forward with the LSE differs")
                want = attention_lse_plain(torch, q, k, causal, window)
                inf = torch.isinf(want)
                if not torch.equal(torch.isinf(lse), inf):
                    raise AssertionError(f"flash_attention {shape} {dname}: "
                                         f"the LSE's +inf rows differ")
                le = compare("flash_attention lse", lse[~inf], want[~inf],
                             dname, tol=ATTN_BWD_TOL[dname])
                lse_note = (f", LSE err {le:.3e} (tol {ATTN_BWD_TOL[dname]}),"
                            f" with the LSE the same output")
                del o, lse, want
            log("b", f"flash_attention {shape} {dname}: max_abs_err {e:.3e} "
                f"(tol {TOL[dname]}){lse_note}, route "
                f"{ops.attention_plan(B, Sq, Sk, H, KV, Dh, dt, causal)}")
            if window >= Sq:
                same = torch.equal(got, ops.flash_attention(q, k, v,
                                                            causal=True))
                log("b", f"flash_attention {shape} {dname}: equals the "
                    f"kernel without a window: {same}")
                if not same:
                    raise AssertionError("a window past S changed the output")
            del q, k, v, got
    torch.cuda.synchronize()


def time_new_attention(torch, ops, ref, dev):
    """Times of flash_attention at ATTN_NEW in bf16 (kernel, plain, SDPA
    and bound; each window behind a spin kernel); returns their records.
    Where the route has more than one kernel (split decode), the device time
    of each is profiled too."""
    from repro_torch.launch import roofline as rl
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(7)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    out = []
    for B, Sq, Sk, H, KV, Dh, causal, window in ATTN_NEW:
        q, k, v = (torch.randn(*sh, generator=gen, device=dev).to(
            torch.bfloat16) for sh in ((B, Sq, H, Dh), (B, Sk, KV, Dh),
                                       (B, Sk, KV, Dh)))
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
        mask = None
        if window:
            i = torch.arange(Sq, device=dev)[:, None]
            j = torch.arange(Sk, device=dev)[None, :]
            mask = (j <= i) & (j > i - window)
        fn = functools.partial(ops.flash_attention, q, k, v, causal=causal,
                               window=window)
        ms = timed_ms(torch, fn, flush, spin=True)
        plain_ms = timed_ms(torch, lambda: attention_plain(
            torch, ref, q, k, v, causal, window), flush, iters=5, warmup=1,
            spin=True)
        lib_ms = timed_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and not window),
            flush, spin=True)
        b_ms, b_by = rl.bound_ms(*rl.attention_cost(
            B, Sq, Sk, H, KV, Dh, causal, window, 2), "bfloat16")
        shape = (f"q[{B},{Sq},{H},{Dh}] k[{B},{Sk},{KV},{Dh}] "
                 f"{'causal' if causal else 'not causal'}"
                 + (f" window {window}" if window else ""))
        log("b", f"time flash_attention {shape} bfloat16: kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms (one KV head at a time), SDPA "
            f"{lib_ms:.4f} ms, bound {b_ms:.4g} ms ({b_by}); route "
            f"{ops.attention_plan(B, Sq, Sk, H, KV, Dh, q.dtype, causal)}")
        plan = ops.attention_plan(B, Sq, Sk, H, KV, Dh, q.dtype, causal)
        if len(plan.kernels) > 1:
            kernel_split(torch, fn, flush, f"flash_attention {shape} "
                         f"bfloat16, route {plan}", phase="b")
        out.append({"shape": shape, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by})
        del q, k, v, qt, kt, vt, mask
    del flush
    return out


# the split decode route's runs against the plan's: Sq 1 at whisper's 1500
# frames at each head dim (Dh 96 with G 2), and a longer cache at Dh 128
ATTN_SPLIT_SWEEP = [(8, 1, 1500, 16, 16, 64), (8, 1, 1500, 16, 8, 96),
                    (8, 1, 1500, 16, 16, 128), (8, 1, 4096, 32, 8, 128)]
# and both routes about its least Sk (ops.DECODE_MIN_KEYS), at whisper's heads
ATTN_SPLIT_EDGE = (8, 1, 16, 16, 64, (64, 128, 256, 512))


def sweep_decode_splits(torch, ops, build, dev) -> None:
    """flash_attention's split decode route at ``ATTN_SPLIT_SWEEP`` in
    bf16, L2 flushed, each window behind the spin kernel: SDPA, the route
    at the plan ``ops.attention_plan`` makes, and at runs of every tile
    count the kernel takes (``DECODE_MAX_TILES``), launched through the C
    entry point (so they count no launch).  Then the first row, plan and
    SDPA, behind a read of the flush buffer rather than its zero fill (which
    leaves L2 full of dirty lines that the reads must write back).  Last,
    mma.sync against the split route's plan at ``ATTN_SPLIT_EDGE``'s key
    counts, about the route's least Sk."""
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(14)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    bf = torch.bfloat16
    launcher = build.launcher("flash_attention")

    def launch(q, k, v, out, part, code, splits, keys):
        B, Sq, H, Dh = q.shape
        Sk, KV = k.shape[1], k.shape[2]
        rc = launcher(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), None, part.data_ptr(), B, Sq, Sk, H, KV,
                      Dh, Dh ** -0.5, 0, 0, code, splits, keys, 1,
                      torch.cuda.current_stream().cuda_stream)
        if rc:
            raise AssertionError(f"flash_attention route {code} at "
                                 f"{splits} x {keys} keys: {rc}")

    for B, Sq, Sk, H, KV, Dh in ATTN_SPLIT_SWEEP:
        q, k, v = (torch.randn(*sh, generator=gen, device=dev).to(bf)
                   for sh in ((B, Sq, H, Dh), (B, Sk, KV, Dh),
                              (B, Sk, KV, Dh)))
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
        plan = ops.attention_plan(B, Sq, Sk, H, KV, Dh, bf, False)
        tiles = -(-Sk // ops.ATTN_TILE)
        out = torch.empty_like(q)
        part = torch.empty(tiles * B * H * Sq * (Dh + 2), dtype=torch.float32,
                           device=dev)

        def split(per):
            launch(q, k, v, out, part, plan.code, -(-tiles // per),
                   per * ops.ATTN_TILE)

        sdpa = functools.partial(F.scaled_dot_product_attention, qt, kt, vt)
        fn = functools.partial(ops.flash_attention, q, k, v, causal=False)
        runs = ", ".join(
            f"{per} ({-(-tiles // per)} splits) "
            f"{timed_ms(torch, functools.partial(split, per), flush, spin=True):.4f}"
            for per in range(1, ops.DECODE_MAX_TILES[Dh] + 1))
        log("b", f"sweep flash_attention q[{B},{Sq},{H},{Dh}] "
            f"k[{B},{Sk},{KV},{Dh}] bfloat16 (ms): SDPA "
            f"{timed_ms(torch, sdpa, flush, spin=True):.4f}, plan "
            f"{timed_ms(torch, fn, flush, spin=True):.4f} ({plan}); tiles a "
            f"split: {runs}")
        if (B, Sq, Sk, H, KV, Dh) == ATTN_SPLIT_SWEEP[0]:
            sink = torch.empty((), dtype=torch.int64, device=dev)
            read = functools.partial(torch.sum, flush, dim=0,
                                     dtype=torch.int64, out=sink)
            ms = {}
            for name, f in (("SDPA", sdpa), ("plan", fn)):
                for _ in range(3):
                    f()
                ts = []
                for _ in range(20):
                    read()
                    torch.cuda._sleep(SPIN_CYCLES)
                    st, en = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                    st.record()
                    f()
                    en.record()
                    ts.append((st, en))
                torch.cuda.synchronize()
                ms[name] = sum(a.elapsed_time(b) for a, b in ts) / len(ts)
            log("b", f"sweep flash_attention q[{B},{Sq},{H},{Dh}] behind a "
                f"read of the flush buffer (not its zero fill): SDPA "
                f"{ms['SDPA']:.4f} ms, plan {ms['plan']:.4f} ms")
        del q, k, v, qt, kt, vt, out, part
    B, Sq, H, KV, Dh, keys = ATTN_SPLIT_EDGE
    runs = []
    for Sk in keys:
        q, k, v = (torch.randn(*sh, generator=gen, device=dev).to(bf)
                   for sh in ((B, Sq, H, Dh), (B, Sk, KV, Dh),
                              (B, Sk, KV, Dh)))
        out = torch.empty_like(q)
        plan = ops.attention_plan(B, Sq, max(Sk, ops.DECODE_MIN_KEYS), H,
                                  KV, Dh, bf, False)
        plan = ops.AttnPlan("split decode", splits=-(-Sk // plan.keys),
                            keys=plan.keys)
        part = torch.empty(plan.splits * B * H * Sq * (Dh + 2),
                           dtype=torch.float32, device=dev)
        mma = timed_ms(torch, functools.partial(
            launch, q, k, v, out, part, ops.ATTN_ROUTES.index("mma.sync"), 1,
            0), flush, spin=True)
        sp = timed_ms(torch, functools.partial(
            launch, q, k, v, out, part, plan.code, plan.splits, plan.keys),
            flush, spin=True)
        runs.append(f"Sk {Sk}: mma.sync {mma:.4f}, split decode {sp:.4f} "
                    f"({plan.splits} x {plan.keys})")
        del q, k, v, out, part
    log("b", f"sweep flash_attention q[{B},{Sq},{H},{Dh}] bfloat16 about the "
        f"split route's least Sk ({ops.DECODE_MIN_KEYS}; ms): "
        + "; ".join(runs))
    del flush


# ------------------------------------------------------------ phase (c)
def profile_window(torch, fn, wall_ms: float, label: str,
                   phase: str = "c") -> None:
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
        log(phase, f"profile {label}: wall {wall_ms:.3f} ms (unprofiled), "
            f"device time not measured (the profiler saw no kernel)")
        return
    log(phase, f"profile {label}: wall {wall_ms:.3f} ms (unprofiled), "
        f"kernels {busy:.3f} ms in {sum(r[1] for r in rows)} launches "
        f"(profiled run), device idle "
        f"{max(0.0, 1 - busy / wall_ms) * 100:.1f}%")
    for t, n, key in rows[:12]:
        log(phase, f"  {t:10.3f} ms {n:6d}x {key[:90]}")


def main_path(torch, dev, arch: str):
    """Serve ``arch`` at full width; returns the path's launch counts."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate, make_embeds, make_prompts
    from repro_torch.models.api import CausalLM

    cfg = configs.get_config(arch)
    prompt = PROMPTS.get(arch, PROMPT)
    model = CausalLM.random(cfg, seed=0, device=dev)
    prompts = make_prompts(cfg, BATCH, prompt, seed=1, device=dev)
    embeds = make_embeds(cfg, BATCH, seed=2, device=dev)
    generate(model, prompts[:, :16], 2, **embeds)  # warm-up: cuBLAS, caches
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    res = generate(model, prompts, TOKENS, **embeds)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    rate = BATCH * (TOKENS - 1) / res.decode_s
    extra = "".join(f", {name} {list(t.shape)}" for name, t in embeds.items())
    log("c", f"{arch} bf16 batch {BATCH} prompt {prompt}{extra} tokens "
        f"{TOKENS}: prefill {res.prefill_s * 1e3:.3f} ms, decode "
        f"{rate:.1f} tok/s, peak memory {peak:.2f} GiB")
    want = expected_launches(cfg, TOKENS)
    log("c", f"{arch} launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"{arch}: launch counts {launches} != {want}")
    toks = res.tokens
    if toks.shape != (BATCH, TOKENS) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"bad generated tokens {tuple(toks.shape)}")
    log("c", f"sequence 0: {toks[0].tolist()}")
    s_full = cfg.n_img_tokens + prompt
    logits, _ = model.prefill(prompts, s_full, **embeds)
    if logits.shape != (BATCH, cfg.vocab_size) or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError("prefill logits not finite or misshapen")

    # profiled windows: one prefill, then 8 decode steps
    s_max = s_full + 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, caches = model.prefill(prompts, s_max, **embeds)
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    profile_window(torch, lambda: model.prefill(prompts, s_max, **embeds),
                   pre_ms, f"{arch} prefill [{BATCH},{prompt}]{extra}")
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
    _, caches = model.prefill(prompts, s_max, **embeds)
    profile_window(torch, decode8, dec_ms,
                   f"{arch} 8 decode steps, batch {BATCH}")
    del model, caches, embeds
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase (d)
def whole_model_checks(torch, dev, arch: str, cut_lens, start: int,
                       window: int = 0) -> None:
    """f32: a 2-layer full-width cut (whisper: 2 encoder and 2 decoder
    layers) on the card against the plain path on the CPU, from prompts of
    each length in ``cut_lens`` plus 3 decode steps; then at full depth,
    decode logits against prefill of the sequence so far, from a prompt of
    ``start`` tokens.  The same frame or image embeddings throughout;
    ``window`` > 0 sets the config's sliding window."""
    from repro_torch import configs
    from repro_torch.launch.serve import make_embeds
    from repro_torch.models import api

    cfg = configs.get_config(arch).replace(dtype="float32")
    name = arch
    if window:
        cfg = cfg.replace(sliding_window=window)
        name = f"{arch} sliding_window {window}"
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (2, max(16, *cut_lens, start)),
                           generator=gen)
    embeds = make_embeds(cfg, 2, seed=4, device="cpu")
    gpu_embeds = {k: t.to(dev) for k, t in embeds.items()}
    n_img = cfg.n_img_tokens

    cut = cfg.replace(n_layers=2 * cfg.block_size,
                      n_enc_layers=min(cfg.n_enc_layers, 2))
    params = api.init(cut, torch.Generator().manual_seed(3), device="cpu")
    cpu_model = api.CausalLM(cut, params)
    gpu_model = api.CausalLM(cut, params).to(dev)
    err = 0.0
    for n in cut_lens:
        lc, cc = cpu_model.prefill(prompt[:, :n], n_img + n + 8, **embeds)
        lg, cg = gpu_model.prefill(prompt[:, :n].to(dev), n_img + n + 8,
                                   **gpu_embeds)
        err = max(err, float((lg.cpu() - lc).abs().max()))
        for _ in range(3):
            tok = torch.argmax(lc, dim=-1)
            lc, cc = cpu_model.decode_step(tok, cc)
            lg, cg = gpu_model.decode_step(tok.to(dev), cg)
            err = max(err, float((lg.cpu() - lc).abs().max()))
    layers = f"{cut.n_layers}-layer" + (
        f" (+{cut.n_enc_layers} encoder)" if cut.n_enc_layers else "")
    log("d", f"{name} {layers} f32, prompts of {cut_lens} tokens, card vs "
        f"plain path on the CPU: max abs logit err {err:.3e} (bound 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"{name}: card and CPU paths disagree")
    del cpu_model, gpu_model, params, cc, cg

    # granite: at 8 tokens or fewer no expert can pass the capacity floor
    # of 8, so neither path drops an assignment.
    model = api.CausalLM.random(cfg, seed=5, device=dev)
    seq = prompt[:, :start].to(dev)
    logits, caches = model.prefill(seq, n_img + max(16, start + 8),
                                   **gpu_embeds)
    err = 0.0
    for _ in range(4):
        tok = torch.argmax(logits, dim=-1)
        logits, caches = model.decode_step(tok, caches)
        seq = torch.cat([seq, tok[:, None]], dim=1)
        full, _ = model.prefill(seq, n_img + seq.shape[1], **gpu_embeds)
        err = max(err, float((logits - full).abs().max()))
    layers = f"{cfg.n_layers}-layer" + (
        f" (+{cfg.n_enc_layers} encoder)" if cfg.n_enc_layers else "")
    what = "image+prompt+generated" if n_img else "prompt+generated"
    label = (f"{name} {layers} f32, prefill over {what} vs decode logits "
             f"from a {start}-token prompt: max abs err {err:.3e}")
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
            raise AssertionError(f"{name}: decode disagrees with prefill")
    del model, caches, gpu_embeds
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
    launch counts of its runs, by kernel, and the profiles, by arch."""
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
    profiles = {}
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
        profiles[arch] = prof
    return total, profiles


# ------------------------------------------------------------ phase (k)
def host_cpu() -> str:
    """The host CPU as ``/proc/cpuinfo`` names it: its model name (which a
    virtual machine may give as "unknown"), vendor, family and model, and
    the logical CPUs and their clock."""
    info, n = {}, 0
    for line in Path("/proc/cpuinfo").read_text().splitlines():
        key, _, value = line.partition(":")
        key = key.strip()
        n += key == "processor"
        info.setdefault(key, value.strip())
    return (f"{info.get('model name', '?')} ({info.get('vendor_id', '?')} "
            f"family {info.get('cpu family', '?')} model "
            f"{info.get('model', '?')}, {n} logical CPUs at "
            f"{info.get('cpu MHz', '?')} MHz)")


def simulator_path(profiles) -> None:
    """Phase (k): (e)'s profiles through the port's simulator on both
    engines, the simulator's goldens, and the engines' host times."""
    from repro_torch.core import ratsim
    from repro_torch.core.config import MB, FabricConfig, SimConfig
    from repro_torch.workloads.derive import derive_workload, pod_fabric
    from repro_torch.workloads.replay import replay

    t0 = time.perf_counter()
    cpu = host_cpu()
    largest = None
    for arch in CAL_ARCHS:
        prof = profiles[arch]
        trace = derive_workload(arch, CAL_SHAPE, n_gpus=CAL_GPUS,
                                n_steps=SIM_STEPS, compute_profile=prof)
        reps, secs = {}, {}
        for engine in ("event", "vectorized"):
            cfg = SimConfig(fabric=pod_fabric(trace.pod), engine=engine)
            t = time.perf_counter()
            reps[engine] = replay(trace, cfg=cfg, compute_profile=prof)
            secs[engine] = time.perf_counter() - t
        rep = reps["event"]
        if reps["vectorized"].steps != rep.steps:
            raise AssertionError(f"{arch}: the engines' StepStats differ")
        log("k", f"{arch} {CAL_SHAPE} g{CAL_GPUS} on (e)'s windows: "
            f"{len(trace.calls)} calls, both engines the same bits")
        log("k", "  step,comm_us,ideal_us,compute_us,degradation,walks,"
            "requests")
        for st in rep.steps:
            log("k", f"  {st.step},{st.comm_ns / 1e3!r},"
                f"{st.ideal_comm_ns / 1e3!r},{st.compute_ns / 1e3!r},"
                f"{st.degradation!r},{st.walks},{st.requests}")
        log("k", f"  cold {rep.cold_degradation!r}, steady "
            f"{rep.steady_degradation!r}")
        # mamba2's windows are 0: the reference's roofline prices mixers
        # by attention and FFN parameters, and it has neither
        if not all(math.isfinite(st.degradation) and st.degradation >= 1.0
                   and st.compute_ns >= 0 for st in rep.steps):
            raise AssertionError(f"{arch}: a step is not a degradation")
        if arch == ARCH and not (
                rep.cold_degradation > rep.steady_degradation
                and all(st.walks == 0 for st in rep.steps[1:])):
            raise AssertionError(f"{arch}: warm TLBs did not win back the "
                                 f"cold walks")
        if largest is None or len(trace.calls) > largest[1]:
            largest = (arch, len(trace.calls), secs)
    for n, (base, ideal, reqs, walks) in SIM_FIG45.items():
        for engine in ("event", "vectorized"):
            c = ratsim.compare(1 * MB, n, engine=engine)
            got = (c.baseline.completion_ns, c.ideal.completion_ns,
                   c.baseline.counters.requests, c.baseline.counters.walks)
            if got != (base, ideal, reqs, walks):
                raise AssertionError(f"Fig. 4/5 at {n} GPUs ({engine}): "
                                     f"{got} != {(base, ideal, reqs, walks)}")
    for n, want in SIM_FIG14.items():
        for engine in ("event", "vectorized"):
            cfg = SimConfig(fabric=FabricConfig(
                n_gpus=n, leaf_size=16, oversubscription=2.0, pod_size=16),
                iterations=2, engine=engine)
            c = ratsim.compare(1 * MB, n, cfg=cfg)
            b, i = c.baseline.iterations, c.ideal.iterations
            got = (b[0].completion_ns, b[1].completion_ns,
                   i[0].completion_ns, i[1].completion_ns,
                   c.baseline.counters.walks)
            if got != want:
                raise AssertionError(f"Fig. 14 single_clos at {n} GPUs "
                                     f"({engine}): {got} != {want}")
    log("k", f"goldens: Fig. 4/5 at 1 MB on {sorted(SIM_FIG45)} GPUs and "
        f"Fig. 14 single_clos on {sorted(SIM_FIG14)}, both engines exact")
    arch, n_calls, secs = largest
    log("k", f"engines at the largest replay ({arch}, {n_calls} calls, "
        f"{SIM_STEPS} steps and its ideal twin), host time on {cpu}: "
        f"event {secs['event']:.3f} s, vectorized "
        f"{secs['vectorized']:.3f} s ({secs['event'] / secs['vectorized']:.2f}x)")
    log("k", f"phase (k) took {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------ phase (l)
def serving_bits(res):
    """Every number of a serving result that both engines must give alike:
    each step and request, each replica's life and each KV handoff (not
    the vectorized engine's fast-path counts, which the event engine has
    not)."""
    import dataclasses

    def fields(obj):
        return tuple(getattr(obj, f.name) for f in dataclasses.fields(obj)
                     if f.name not in ("fastpath_calls", "req", "itl_ns",
                                       "stats", "steps", "stream"))

    bits = [[fields(s) for s in res.steps],
            [(r.rid, fields(r), tuple(r.itl_ns)) for r in res.requests]]
    for rep in getattr(res, "replicas", ()):
        bits.append(fields(rep))
    bits.append([r.rid for r in getattr(res, "rejected", ())])
    bits.append([fields(h) for h in getattr(res, "handoffs", ())])
    return bits


def serving_line(res) -> str:
    """The numbers phase (l) prints of a serving result, as the reference's
    serving CLI names them (us, unrounded)."""
    ttft, itl = res.ttft_percentiles(), res.itl_percentiles()
    return (f"TTFT p50/p95/p99 {ttft[50.0] / 1e3!r} / {ttft[95.0] / 1e3!r} "
            f"/ {ttft[99.0] / 1e3!r} us, inter-token p50 "
            f"{itl[50.0] / 1e3!r} us, TTFT degradation mean "
            f"{res.mean_ttft_degradation!r} p99 "
            f"{res.p99_ttft_degradation!r}, {res.cold_steps} cold of "
            f"{len(res.steps)} steps, cold comm {res.cold_comm_ns / 1e3!r} "
            f"us, warm comm {res.warm_comm_ns / 1e3!r} us, walks "
            f"{sum(s.walks for s in res.steps)}, served "
            f"{len(res.first_token_served)} of {len(res.requests)}")


def serving_path(profile_path) -> None:
    """Phase (l): the port's serving layer (``repro_torch.serving``; host
    code in numpy, no torch) on (e)'s granite profile: Fig. 15's golden
    on roofline windows, the calibrated point at each retention, a fleet
    and a disaggregated point, each on both engines with the same bits,
    and one pooled sweep against the serial runs."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.session import SimSession
    from repro_torch.serving import (DisaggPoint, FleetPoint, TrafficPoint,
                                     sweep_traffic)
    from repro_torch.serving.disagg import _disagg_point
    from repro_torch.serving.fleet import _fleet_point
    from repro_torch.serving.simulate import _traffic_point
    from repro_torch.workloads.calibrate import ComputeProfile
    from repro_torch.workloads.derive import StepEmitter

    t0 = time.perf_counter()
    cpu = host_cpu()

    def replace_engine(point, engine):
        if isinstance(point, TrafficPoint):
            return dataclasses.replace(point, engine=engine)
        return dataclasses.replace(point, traffic=dataclasses.replace(
            point.traffic, engine=engine))

    def both_engines(label, price, point):
        """``price((point,))`` on each engine: the same bits, or raise."""
        res, secs = {}, {}
        for engine in ("event", "vectorized"):
            t = time.perf_counter()
            res[engine] = price((replace_engine(point, engine),))
            secs[engine] = time.perf_counter() - t
        if serving_bits(res["vectorized"]) != serving_bits(res["event"]):
            raise AssertionError(f"{label}: the engines' results differ")
        log("l", f"{label}: both engines the same bits (host time event "
            f"{secs['event']:.3f} s, vectorized {secs['vectorized']:.3f} s)")
        log("l", f"  {serving_line(res['event'])}")
        return res["event"]

    golden = both_engines("Fig. 15 bursty point, roofline windows",
                          _traffic_point, TrafficPoint(**SERVE_POINT))
    ttft = golden.ttft_percentiles()
    got = dict(p50=ttft[50.0], p95=ttft[95.0], p99=ttft[99.0],
               mean_deg=golden.mean_ttft_degradation,
               p99_deg=golden.p99_ttft_degradation,
               cold_comm_ns=golden.cold_comm_ns,
               warm_comm_ns=golden.warm_comm_ns,
               cold_steps=golden.cold_steps, steps=len(golden.steps),
               walks=sum(s.walks for s in golden.steps),
               served=len(golden.first_token_served))
    if got != SERVE_GOLDEN:
        raise AssertionError(f"Fig. 15 golden: {got} != {SERVE_GOLDEN}")
    log("l", "  golden: every field exact on both engines")

    prof = ComputeProfile.load(profile_path)
    log("l", f"profile {profile_path} ({prof.arch} {prof.shape} "
        f"g{prof.n_gpus}, interpret={prof.interpret}): " + ", ".join(
            f"{name} {w.calibrated_ns!r} ns (roofline {w.roofline_ns!r})"
            for name, w in sorted(prof.phases.items())))
    calibrated = {}
    for retention in SERVE_RETENTIONS:
        pt = TrafficPoint(**{**SERVE_POINT, "retention_ns": retention,
                             "profile_path": str(profile_path)})
        res = both_engines(f"calibrated, retention {retention} ns",
                           _traffic_point, pt)
        calibrated[pt] = res
        clears = res.p99_ttft_degradation > res.mean_ttft_degradation
        log("l", f"  the p99 TTFT degradation clears the mean: {clears}")
    # the largest compute window a single call passes on to the session,
    # at a one-token decode step and at the largest step (every slot and a
    # full prefill chunk): one that reaches the retention would flush the
    # TLBs inside a step
    mcfg = get_config(ARCH)
    pod = golden.pod
    for label, kw in (("roofline", {}), ("calibrated",
                                          dict(compute_profile=prof))):
        sess = SimSession(golden.cfg, **kw)
        for tokens in (1, 32 + 512):
            em = StepEmitter(mcfg, pod)
            em.step(0, tokens)
            widest = max(sess.resolve_gap(c.compute_ns, c.phase,
                                          c.window_parts) for c in em.calls)
            log("l", f"largest compute window of one call, {label}, "
                f"{tokens} tokens: {widest!r} ns; reaches the 50000.0 ns "
                f"retention: {widest >= SERVE_RETENTIONS[-1]}")

    small = {**SERVE_POINT, **SERVE_SMALL, "profile_path": str(profile_path)}
    fleet = FleetPoint(traffic=TrafficPoint(**small), **SERVE_FLEET)
    res = both_engines("fleet of 2 replicas, autoscaled, calibrated",
                       _fleet_point, fleet)
    log("l", f"  fleet: {res.spin_ups} spin-ups, {res.retired} retired, "
        f"peak {res.peak_replicas} replicas, replica rows "
        f"{res.replica_rows()}")
    disagg = DisaggPoint(traffic=TrafficPoint(**small))
    res = both_engines("disaggregated 1:1, calibrated", _disagg_point,
                       disagg)
    log("l", f"  disagg: {len(res.handoffs)} KV handoffs "
        f"({res.kv_cold_handoffs} cold, {res.kv_walks} walks), TTFT "
        f"decomposition {res.ttft_breakdown()}")

    t = time.perf_counter()
    points = {replace_engine(pt, "vectorized"): res
              for pt, res in calibrated.items()}
    pooled = sweep_traffic(list(points), workers=2)
    for pt, res in points.items():
        if serving_bits(pooled[pt]) != serving_bits(res):
            raise AssertionError(f"{pt}: pooled != serial")
    log("l", f"calibrated points on a pool of 2 spawned workers: the "
        f"serial bits ({time.perf_counter() - t:.1f} s)")
    log("l", f"host: {cpu}")
    log("l", f"phase (l) took {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------ phase (f)
def compare_rel(name: str, got, want, tol: float, scale=None):
    """max |got - want| within ``tol`` times max |want| (or times ``scale``
    where given); returns (max abs err, that err over the scale)."""
    want = want.float()
    if scale is None:
        scale = max(float(want.abs().max()), 1e-30) if want.numel() else 1.0
    err = float((got.float() - want).abs().max()) if want.numel() else 0.0
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max err {err:.3e} exceeds {tol} x "
                             f"max|ref| {scale:.3e}")
    return err, err / scale


def same_bits(torch, name: str, a, b) -> None:
    """Two calls' outputs (tuples of tensors) equal bit for bit."""
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: two calls differ")


def check_attention_bwd(torch, ops, ref, randn, shape, dname, dt,
                        phase: str = "f") -> float:
    """flash_attention_bwd at one shape against its plain version (each
    output within ``ATTN_BWD_TOL`` of max|ref|, finite) and twice bit for
    bit; the forward with the LSE equal to the forward without it.  With a
    window of 1 each row keeps one key, P is 1 and dS = dP - D is 0 up to
    rounding, so dq and dk are held against the size of what cancels:
    max|D| max|k| scale for dq, G max|D| max|q| scale for dk.  Returns the
    max abs error."""
    B, Sq, Sk, H, KV, Dh, causal, window = shape
    q, do = randn(B, Sq, H, Dh, dtype=dt), randn(B, Sq, H, Dh, dtype=dt)
    k, v = randn(B, Sk, KV, Dh, dtype=dt), randn(B, Sk, KV, Dh, dtype=dt)
    kw = dict(causal=causal, window=window)
    o, lse = ops.flash_attention_fwd(q, k, v, with_lse=True, **kw)
    if not torch.equal(o, ops.flash_attention_fwd(q, k, v, **kw)[0]):
        raise AssertionError(f"flash_attention {shape}: the forward with "
                             f"the LSE differs")
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, **kw)
    if not all(bool(torch.isfinite(g).all()) for g in got):
        raise AssertionError(f"flash_attention_bwd {shape} {dname}: not "
                             f"finite")
    scales = [None] * 3
    if window == 1:
        dd = float((do.float() * o.float()).sum(-1).abs().max())
        sm = Dh ** -0.5
        scales[0] = dd * float(k.float().abs().max()) * sm
        scales[1] = H // KV * dd * float(q.float().abs().max()) * sm
    e, r = map(max, zip(*(
        compare_rel(f"flash_attention_bwd {n} {shape} {dname}", g, w_,
                    ATTN_BWD_TOL[dname], scale=sc)
        for n, g, w_, sc in zip(("dq", "dk", "dv"), got, want, scales))))
    same_bits(torch, f"flash_attention_bwd {shape} {dname}", got,
              ops.flash_attention_bwd(q, k, v, o, lse, do, **kw))
    note = "; dq, dk against the cancelled terms" if window == 1 else ""
    log(phase, f"flash_attention_bwd {shape} {dname}: max_abs_err {e:.3e}, "
        f"err/max|ref| {r:.3e} (tol {ATTN_BWD_TOL[dname]}){note}; finite; "
        f"deterministic; the LSE forward equals the forward bit for bit; "
        f"route {ops.attention_bwd_plan(B, Sq, Sk, H, KV, dt)}")
    return e


def check_rmsnorm_bwd(torch, ops, ref, x, w, dy, label: str,
                      dname: str) -> float:
    """rmsnorm_bwd against its plain version (dx and dw within
    ``BWD_TOL`` of max|ref|) and twice bit for bit; returns the max abs
    error."""
    got = ops.rmsnorm_bwd(x, w, dy, 1e-6)
    want = ref.rmsnorm_bwd_ref(x, w, dy, eps=1e-6)
    e, r = map(max, zip(*(
        compare_rel(f"rmsnorm_bwd {n} {label} {dname}", g, w_,
                    BWD_TOL[dname])
        for n, g, w_ in zip(("dx", "dw"), got, want))))
    same_bits(torch, f"rmsnorm_bwd {label} {dname}", got,
              ops.rmsnorm_bwd(x, w, dy, 1e-6))
    log("f", f"rmsnorm_bwd {label} {dname}: max_abs_err {e:.3e}, "
        f"err/max|ref| {r:.3e} (tol {BWD_TOL[dname]}); deterministic")
    return e


def check_backward_kernels(torch, ops, ref, dev):
    """Phase (f): each backward kernel against its plain version (and
    twice, bit for bit), the LSE forward against the plain forward kernel
    bit for bit, and the ssd_chunk guard.  Its own generator (seed 9).
    Returns the errors at granite's bf16 training shapes."""
    gen = torch.Generator(device=dev).manual_seed(9)
    # the tensor-core tiles' edges draw from a generator of their own, so
    # that the earlier checks keep their inputs, and the routes of the
    # one-pass rmsnorm_bwd and dX's decode route from another
    edge_gen = torch.Generator(device=dev).manual_seed(13)
    route_gen = torch.Generator(device=dev).manual_seed(14)
    # and the wgmma backward's edges from another
    wg_gen = torch.Generator(device=dev).manual_seed(17)
    errs = {}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def edge_randn(*shape, dtype):
        return torch.randn(*shape, generator=edge_gen, device=dev).to(dtype)

    def route_randn(*shape, dtype):
        return torch.randn(*shape, generator=route_gen,
                           device=dev).to(dtype)

    def wg_randn(*shape, dtype):
        return torch.randn(*shape, generator=wg_gen, device=dev).to(dtype)

    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for T, D in RMS_BWD:
            x, dy = randn(T, D, dtype=dt), randn(T, D, dtype=dt)
            w = randn(D, dtype=torch.float32)
            e = check_rmsnorm_bwd(torch, ops, ref, x, w, dy, f"[{T},{D}]",
                                  dname)
            if dname == "bfloat16" and (T, D) == RMS_BWD[0]:
                errs["rmsnorm_bwd"] = e
            del x, dy
        for T, D in RMS_BWD_EDGES + RMS_UNALIGNED:
            x = route_randn(T * D + 1, dtype=dt)
            label = f"[{T},{D}]"
            if (T, D) in RMS_UNALIGNED:             # x one element in
                x, label = x[1:].view(T, D), label + " x unaligned"
            else:
                x = x[:T * D].view(T, D)
            dy = route_randn(T, D, dtype=dt)
            w = route_randn(D, dtype=torch.float32)
            check_rmsnorm_bwd(torch, ops, ref, x, w, dy, label, dname)
            del x, dy
        for shape in ATTN_BWD:
            e = check_attention_bwd(torch, ops, ref, randn, shape, dname, dt)
            if dname == "bfloat16" and shape == ATTN_BWD[0]:
                errs["flash_attention_bwd"] = e
        for shape in ATTN_BWD_EDGES:
            check_attention_bwd(torch, ops, ref, edge_randn, shape, dname, dt)
        for shape in ATTN_BWD_WGMMA_EDGES:
            check_attention_bwd(torch, ops, ref, wg_randn, shape, dname, dt)
        cases = []
        for T, D, Fo in ((TRAIN_BATCH * TRAIN_SEQ * 8, 1024, 512),
                         (TRAIN_BATCH * TRAIN_SEQ * 8, 512, 1024)):
            cases.append((f"training [{T},{D}]x[32,{D},{Fo}]", T, D, Fo, 32,
                          random_offsets(torch, gen, T, 32), True))
        # an uncovered head of 5 rows, experts with no rows, groups off
        # the 32-row steps, an uncovered tail; D and F off the 64 tiles
        edge = [5, 5, 6, 38, 38, 171, 300]
        cases.append((f"edges {edge}", 310, 136, 200, 6,
                      torch.tensor(edge, dtype=torch.int32, device=dev),
                      False))
        cases.append(("all rows uncovered", 64, 64, 64, 3,
                      torch.zeros(4, dtype=torch.int32, device=dev), False))
        base_labels = {c[0] for c in cases}
        for label, T, D, Fo, offs in GMM_DW_EDGES:
            cases.append((label, T, D, Fo, len(offs) - 1,
                          torch.tensor(offs, dtype=torch.int32, device=dev),
                          False))
        # dX's decode route, with uncovered rows ahead (2) and behind
        route_labels = set()
        for T, D, Fo, E in GMM_DX_DECODE:
            label = f"decode route dY[{T},{Fo}] W^T, W [{E},{D},{Fo}]"
            route_labels.add(label)
            cases.append((label, T, D, Fo, E,
                          random_offsets(torch, route_gen, T - 5, E) + 2,
                          False))
        for label, T, D, Fo, E, offs, main in cases:
            rnd = (randn if label in base_labels else
                   route_randn if label in route_labels else edge_randn)
            lhs, dy = rnd(T, D, dtype=dt), rnd(T, Fo, dtype=dt)
            rhs = (rnd(E, D, Fo, dtype=torch.float32) / math.sqrt(D)).to(dt)
            got = ops.grouped_matmul_bwd(lhs, rhs, offs, dy)
            want = ref.grouped_matmul_bwd_ref(lhs, rhs, offs, dy)
            e_dx, r_dx = compare_rel(f"grouped_matmul_dx {label} {dname}",
                                     got[0], want[0], BWD_TOL[dname])
            e_dw, r_dw = compare_rel(f"grouped_matmul_dw {label} {dname}",
                                     got[1], want[1], BWD_TOL[dname])
            same_bits(torch, f"grouped_matmul bwd {label} {dname}", got,
                      ops.grouped_matmul_bwd(lhs, rhs, offs, dy))
            lo, hi = int(offs[0]), int(offs[-1])
            counts = (offs[1:] - offs[:-1]).tolist()
            if bool((got[0][:lo] != 0).any()) or bool(
                    (got[0][hi:] != 0).any()):
                raise AssertionError(f"grouped_matmul_dx {label}: uncovered "
                                     f"rows are not zero")
            if any(bool((got[1][e] != 0).any())
                   for e, n in enumerate(counts) if n <= 0):
                raise AssertionError(f"grouped_matmul_dw {label}: an expert "
                                     f"with no rows is not zero")
            log("f", f"grouped_matmul bwd {label} {dname}: dX max_abs_err "
                f"{e_dx:.3e} (err/max|ref| {r_dx:.3e}), dW {e_dw:.3e} "
                f"({r_dw:.3e}) (tol {BWD_TOL[dname]}); "
                f"uncovered rows {lo + T - hi} (zero dX), experts with no "
                f"rows {sum(1 for n in counts if n <= 0)} (zero dW); "
                f"deterministic")
            if dname == "bfloat16" and main:
                errs["grouped_matmul_dx"] = max(
                    errs.get("grouped_matmul_dx", 0.0), e_dx)
                errs["grouped_matmul_dw"] = max(
                    errs.get("grouped_matmul_dw", 0.0), e_dw)
            del lhs, dy, rhs, got, want
    # dX reads W in place: at granite's training shape the call allocates
    # its output and nothing else (a copy of W^T would add 32 MiB)
    T, D, Fo, E = TRAIN_BATCH * TRAIN_SEQ * 8, 1024, 512, 32
    dyo = torch.zeros(T, Fo, dtype=torch.bfloat16, device=dev)
    rhs = torch.zeros(E, D, Fo, dtype=torch.bfloat16, device=dev)
    offs = random_offsets(torch, route_gen, T, E)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    dx, _ = ops.grouped_matmul_bwd(dyo, rhs, offs, dyo, need_dw=False)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(dev) - before
    limit = dx.numel() * dx.element_size() + (1 << 20)
    log("f", f"grouped_matmul_dx bf16 dY[{T},{Fo}] W^T, W [{E},{D},{Fo}]: "
        f"peak memory +{extra} bytes (dX {dx.numel() * dx.element_size()}, "
        f"limit {limit}; a copy of W^T would add {rhs.numel() * 2})")
    if extra > limit:
        raise AssertionError(f"grouped_matmul_dx allocated {extra} bytes "
                             f"beyond its inputs (limit {limit})")
    del dyo, rhs, dx
    try:
        ops.grouped_matmul_dw(torch.zeros(64, 100, dtype=torch.bfloat16,
                                          device=dev),
                              torch.zeros(64, 64, dtype=torch.bfloat16,
                                          device=dev),
                              torch.tensor([0, 64], dtype=torch.int32,
                                           device=dev), 1)
    except ValueError as err:
        log("f", f"grouped_matmul_dw bf16 D 100: raises ValueError ({err})")
    else:
        raise AssertionError("grouped_matmul_dw bf16 with D 100 did not "
                             "raise")
    torch.cuda.synchronize()
    return errs


def check_ssd_bwd(torch, ops, ref, dev) -> float:
    """ssd_chunk_bwd against its plain version: every output finite,
    within ``SSD_BWD_TOL`` of its max |ref| and within the bound of
    ``ref.ssd_chunk_bwd_f64``, and the same bits twice; at mamba2's
    training shape, the forward's tiling edges (``SSD_EDGES``) and the
    backward's own (``SSD_BWD_EDGES``), with ds absent, with dy absent, and
    with a of both signs (``SSD_SIGNED``).  Its own generator (seed 15).
    Returns the max abs error at the training shape."""
    gen = torch.Generator(device=dev).manual_seed(15)
    names = ("dx", "ddt", "da", "dB", "dC")
    cases = [(shape, True, True, False) for shape in [SSD_TRAIN] + SSD_EDGES]
    cases += [(SSD_TRAIN, True, False, False), (SSD_EDGES[-1], False, True,
                                                False)]
    cases += [(shape, True, True, False) for shape in SSD_BWD_EDGES]
    cases += [(SSD_SIGNED, True, True, True)]
    err_train = 0.0
    for shape, has_dy, has_ds, signed in cases:
        BC, Q, H, P, N = shape
        x, dt, a, B, C = ssd_inputs(torch, gen, *shape)
        if signed:
            a = 0.3 * torch.randn(a.shape, generator=gen, device=dev)
        dy = (torch.randn(x.shape, generator=gen, device=dev) if has_dy
              else None)
        ds = (torch.randn((BC, H, P, N) if x.ndim == 4 else (BC, P, N),
                          generator=gen, device=dev) if has_ds else None)
        label = (f"ssd_chunk_bwd {shape}" + ("" if has_dy else ", dy absent")
                 + ("" if has_ds else ", ds absent")
                 + (", a of both signs" if signed else ""))
        got = ops.ssd_chunk_bwd(x, dt, a, B, C, dy, ds)
        want = ref.ssd_chunk_bwd_ref(x, dt, a, B, C, dy, ds)
        vals, bounds = ref.ssd_chunk_bwd_f64(x, dt, a, B, C, dy, ds)
        errs, rels, ratios = [], [], []
        for n, g, w, v, b in zip(names, got, want, vals, bounds):
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{label} {n}: not finite")
            e, r = compare_rel(f"{label} {n}", g, w, SSD_BWD_TOL)
            errs.append(e)
            rels.append(r)
            ratios.append(compare_f64(f"{label} {n}", g, v, b))
        same_bits(torch, label, got, ops.ssd_chunk_bwd(x, dt, a, B, C, dy,
                                                       ds))
        log("f", f"{label}: max_abs_err {max(errs):.3e}, err/max|ref| "
            f"{max(rels):.3e} (tol {SSD_BWD_TOL}); err/f64 bound "
            + ", ".join(f"{n} {r:.3f}" for n, r in zip(names, ratios))
            + "; finite; deterministic")
        if shape == SSD_TRAIN and has_dy and has_ds and not signed:
            err_train = max(errs)
        del x, dt, a, B, C, dy, ds, got, want, vals, bounds
        torch.cuda.empty_cache()
    return err_train


def kernel_split(torch, fn, flush, label: str, calls: int = 5,
                 phase: str = "f") -> None:
    """Logs the device time a launch of each kernel that ``fn`` runs, from
    the profiler over ``calls`` calls with L2 flushed before each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    parts = []
    # late in a long run a trace can come back empty: one more try
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            t = getattr(evt, "self_device_time_total",
                        getattr(evt, "self_cuda_time_total", 0.0))
            if (evt.device_type == DeviceType.CUDA and t > 0
                    and "FillFunctor" not in evt.key):       # the flush
                name = evt.key.replace("(anonymous namespace)::", "")
                name = name.removeprefix("void ").split("(")[0]
                parts.append(f"{name} {t / 1e3 / evt.count:.4f} ms a launch "
                             f"({evt.count} seen)")
        if parts:
            break
    log(phase, f"profile {label} ({calls} calls, L2 flushed): "
        f"{'; '.join(parts) or 'device time not measured'}")


def time_backward_kernels(torch, ops, ref, dev):
    """Times of the backward kernels at granite's training shapes, bf16
    (rmsnorm_bwd at every ``RMS_BWD`` shape), and of ssd_chunk_bwd at
    mamba2's, f32: kernel, plain version, one PyTorch call computing the
    same function (backward alone, from a graph kept for it; none for
    ssd_chunk_bwd), and the bound.  Device time: each window opens behind
    a spin kernel (``timed_ms``)."""
    from repro_torch.launch import roofline as rl
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(10)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    bf, es = torch.bfloat16, 2
    out = {}

    def record(name, shape, fn, plain, lib, nbytes, flops, dtype="bfloat16"):
        ms = timed_ms(torch, fn, flush, spin=True)
        plain_ms = timed_ms(torch, plain, flush, iters=5, warmup=1, spin=True)
        lib_ms = (timed_ms(torch, lib, flush, spin=True) if lib is not None
                  else None)
        b_ms, b_by = rl.bound_ms(nbytes, flops, dtype)
        log("f", f"time {name} {shape} {dtype}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b_ms:.4g} ms ({b_by})")
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": b_ms, "bound_by": b_by, "shape": shape}

    rms = []
    for T, D in RMS_BWD:
        x = torch.randn(T, D, generator=gen, device=dev).to(bf)
        dy = torch.randn(T, D, generator=gen, device=dev).to(bf)
        w = torch.ones(D, device=dev)
        xl = x.clone().requires_grad_()
        wl = w.to(bf).requires_grad_()
        yl = F.rms_norm(xl, (D,), wl, 1e-6)
        rms.append(record(
            "rmsnorm_bwd", f"[{T},{D}]",
            lambda: ops.rmsnorm_bwd(x, w, dy, 1e-6),
            lambda: ref.rmsnorm_bwd_ref(x, w, dy, eps=1e-6),
            lambda: torch.autograd.grad(yl, (xl, wl), dy, retain_graph=True),
            *rl.rmsnorm_bwd_cost(T, D, es)))
        if (T, D) in (RMS_BWD[0], (37, 1001), (4096, 3072)):
            kernel_split(torch, lambda: ops.rmsnorm_bwd(x, w, dy, 1e-6),
                         flush, f"rmsnorm_bwd [{T},{D}] bfloat16")
        del x, dy, xl, wl, yl
    out["rmsnorm_bwd"] = {**rms[0], "by_shape": rms[1:]}

    attn = []
    for B, S, H, KV, Dh in ATTN_BWD_TIMED:
        q, do = (torch.randn(B, S, H, Dh, generator=gen, device=dev).to(bf)
                 for _ in range(2))
        k, v = (torch.randn(B, S, KV, Dh, generator=gen, device=dev).to(bf)
                for _ in range(2))
        o, lse = ops.flash_attention_fwd(q, k, v, causal=True, with_lse=True)
        qt = q.transpose(1, 2).detach().requires_grad_()
        kt = k.repeat_interleave(H // KV, 2).transpose(1, 2).detach() \
            .requires_grad_()
        vt = v.repeat_interleave(H // KV, 2).transpose(1, 2).detach() \
            .requires_grad_()
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2)
        bwd = lambda: ops.flash_attention_bwd(q, k, v, o, lse, do,
                                              causal=True)
        attn.append(record(
            "flash_attention_bwd", f"q[{B},{S},{H},{Dh}] causal", bwd,
            lambda: ref.flash_attention_bwd_ref(q, k, v, o, do, causal=True),
            lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                        retain_graph=True),
            *rl.attention_bwd_cost(B, S, S, H, KV, Dh, True, 0, es)))
        kernel_split(torch, bwd, flush, f"flash_attention_bwd q[{B},{S},{H},"
                     f"{Dh}] causal bfloat16, route "
                     f"{ops.attention_bwd_plan(B, S, S, H, KV, bf)}")
        del q, do, k, v, o, lse, qt, kt, vt, ot, dot
        torch.cuda.empty_cache()
    out["flash_attention_bwd"] = {**attn[0], "by_shape": attn[1:]}

    gmm = {"grouped_matmul_dx": [], "grouped_matmul_dw": []}
    for T, D, Fo in ((TRAIN_BATCH * TRAIN_SEQ * 8, 1024, 512),
                     (TRAIN_BATCH * TRAIN_SEQ * 8, 512, 1024)):
        E = 32
        offs = random_offsets(torch, gen, T, E)
        lhs = torch.randn(T, D, generator=gen, device=dev).to(bf)
        dyo = torch.randn(T, Fo, generator=gen, device=dev).to(bf)
        rhs = (torch.randn(E, D, Fo, generator=gen, device=dev)
               / math.sqrt(D)).to(bf)
        counts = (offs[1:] - offs[:-1]).tolist()
        cmax = max(counts)
        px, pdy = lhs.new_zeros(E, cmax, D), dyo.new_zeros(E, cmax, Fo)
        for e, (lo, n) in enumerate(zip(offs[:-1].tolist(), counts)):
            px[e, :n] = lhs[lo:lo + n]
            pdy[e, :n] = dyo[lo:lo + n]
        rows = int(offs[-1] - offs[0])
        used = sum(1 for n in counts if n)
        shape = f"[{T},{D}]x[{E},{D},{Fo}]"
        rec = record(
            "grouped_matmul_dx", f"dY[{T},{Fo}] W^T of {shape}",
            lambda: ops.grouped_matmul_bwd(lhs, rhs, offs, dyo, need_dw=False),
            lambda: ref.grouped_matmul_ref(dyo, rhs.transpose(1, 2), offs),
            lambda: torch.bmm(pdy, rhs.transpose(1, 2)),
            *rl.gmm_cost(T, Fo, D, E, rows, used, es))
        gmm["grouped_matmul_dx"].append(rec)
        kernel_split(torch, lambda: ops.grouped_matmul_bwd(
            lhs, rhs, offs, dyo, need_dw=False), flush,
            f"grouped_matmul_dx dY[{T},{Fo}] W^T bfloat16")
        rec = record(
            "grouped_matmul_dw", f"X^T dY of {shape}",
            lambda: ops.grouped_matmul_dw(lhs, dyo, offs, E),
            lambda: ref.grouped_matmul_dw_ref(lhs, dyo, offs, E),
            lambda: torch.bmm(px.transpose(1, 2), pdy),
            *rl.gmm_dw_cost(D, Fo, E, rows, es))
        gmm["grouped_matmul_dw"].append(rec)
        del lhs, dyo, rhs, px, pdy
    for name, recs in gmm.items():
        out[name] = {**recs[0], "by_shape": recs[1:]}

    x, dt, a, B, C = ssd_inputs(torch, gen, *SSD_TRAIN)
    BC, Q, H, P, N = SSD_TRAIN
    dy = torch.randn(x.shape, generator=gen, device=dev)
    ds = torch.randn(BC, H, P, N, generator=gen, device=dev)
    out["ssd_chunk_bwd"] = record(
        "ssd_chunk_bwd", f"x[{BC},{Q},{H},{P}], N {N}",
        lambda: ops.ssd_chunk_bwd(x, dt, a, B, C, dy, ds),
        lambda: ref.ssd_chunk_bwd_ref(x, dt, a, B, C, dy, ds), None,
        *rl.ssd_bwd_cost(*SSD_TRAIN), dtype="float32")
    kernel_split(torch, lambda: ops.ssd_chunk_bwd(x, dt, a, B, C, dy, ds),
                 flush, f"ssd_chunk_bwd x[{BC},{Q},{H},{P}] float32")
    del x, dt, a, B, C, dy, ds, flush
    return out


def grads_card_vs_cpu(torch, dev, arch: str, B: int, S: int, cfg=None,
                      bound=1e-4) -> None:
    """f32 loss and gradients of a 2-layer full-width cut (whisper: 2
    encoder and 2 decoder layers; or ``cfg``) on the card, through the
    kernels and their backward kernels, against the plain path on the CPU:
    the loss within ``bound`` relative, every leaf within ``bound`` of its
    max |g|, and every leaf on the card finite and not all zero.  With
    ``bound`` None the gap is printed as a measurement only."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import as_trainable
    from repro_torch.models import api
    from repro_torch.weights import flatten, tree_map

    if cfg is None:
        cfg = configs.get_config(arch)
        cfg = cfg.replace(n_layers=2 * cfg.block_size,
                          n_enc_layers=min(cfg.n_enc_layers, 2))
    cfg = cfg.replace(dtype="float32")
    params = api.init(cfg, torch.Generator().manual_seed(11), device="cpu")
    gen = torch.Generator().manual_seed(12)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = torch.randn(B, cfg.enc_frames, cfg.d_model,
                                          generator=gen)

    def loss_and_grads(p, b):
        p = as_trainable(p)
        loss, _ = api.loss_fn(cfg, p, b)
        flat = flatten(p)
        return loss, dict(zip(flat, torch.autograd.grad(
            loss, list(flat.values()))))

    lc, gc = loss_and_grads(params, batch)
    ops.reset_launches()
    lg, gg = loss_and_grads(tree_map(lambda t: t.to(dev), params),
                            {k: t.to(dev) for k, t in batch.items()})
    launched = {n: ops.LAUNCHES[n] for n in ops.KERNEL_NAMES
                if ops.LAUNCHES[n]}
    # each forward kernel the model ran has its backward kernels run too
    if any(launched.get(SOURCES[n]) and not launched.get(n)
           for n in BACKWARD):
        raise AssertionError(f"{arch}: a backward kernel was not launched "
                             f"({launched})")
    l_err = abs(float(lg) - float(lc)) / abs(float(lc))
    worst, worst_path = 0.0, ""
    for path, g in gg.items():
        g = g.cpu()
        if not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0:
            raise AssertionError(f"{arch}: gradient {path} is not finite or "
                                 f"all zero on the card")
        scale = max(float(gc[path].abs().max()), 1e-30)
        e = float((g - gc[path]).abs().max()) / scale
        if e > worst:
            worst, worst_path = e, path
    layers = f"{cfg.n_layers}-layer" + (
        f" (+{cfg.n_enc_layers} encoder)" if cfg.n_enc_layers else "")
    held = (f"bound {bound}" if bound is not None else
            "a measurement, held to no bound")
    log("f", f"{arch} {layers} f32 batch {B}x{S}: loss {float(lg):.6f} on "
        f"the card, {float(lc):.6f} on the CPU (rel err {l_err:.3e}); "
        f"{len(gg)} gradient leaves, max err/max|g| {worst:.3e} "
        f"({worst_path}), every leaf finite and non-zero ({held}); "
        f"launches {launched}")
    if bound is not None and not (l_err <= bound and worst <= bound):
        raise AssertionError(f"{arch}: card and CPU gradients disagree")
    del params, gc, gg
    torch.cuda.empty_cache()


def train_path(torch, dev, arch: str = ARCH):
    """``arch`` (granite-moe-1b-a400m, or mamba2-780m) at full width and
    depth, trained 6 steps by the port's Trainer; returns the run's launch
    counts, the trainer and its output (the state after the 6 steps, for
    phase (g))."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.weights import tree_leaves

    cfg = configs.get_config(arch)
    # the CLI's learning rate and the Trainer's default warm-up (10 steps)
    tcfg = TrainerConfig(steps=TRAIN_STEPS, batch_size=TRAIN_BATCH,
                         seq_len=TRAIN_SEQ, peak_lr=3e-4, log_every=1)
    held = (torch.cuda.memory_allocated(dev) / 2 ** 30,
            torch.cuda.memory_reserved(dev) / 2 ** 30)
    trainer = Trainer(cfg, tcfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    out = trainer.run()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    timed = [h["sec"] for h in hist[1:]]
    step_s = sum(timed) / len(timed)
    n_params = sum(t.numel() for t in tree_leaves(out["state"]["params"]))
    log("f", f"{arch} train bf16 params ({n_params} of them) + f32 master, "
        f"AdamW, batch {TRAIN_BATCH}x{TRAIN_SEQ}, remat {cfg.remat}: "
        f"{TRAIN_STEPS} steps, step {step_s * 1e3:.1f} ms (mean of steps "
        f"1..{TRAIN_STEPS - 1}; step 0 {hist[0]['sec'] * 1e3:.1f} ms, "
        f"untimed), {TRAIN_BATCH * TRAIN_SEQ / step_s:.0f} tokens/s, peak "
        f"memory {peak:.2f} GiB (before its Trainer: {held[0]:.2f} GiB "
        f"allocated, {held[1]:.2f} GiB reserved)")
    log("f", f"{arch} losses {[round(x, 4) for x in losses]}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x)
                                             for x in losses):
        raise AssertionError(f"training losses {losses}")
    want = expected_train_launches(cfg, TRAIN_STEPS)
    log("f", f"{arch} train launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"train launch counts {launches} != {want}")

    state = out["state"]
    it = trainer.batches()
    batch = trainer.to_device(next(it))

    def one_step():
        trainer.step(state["params"], state["opt"], state["comp"], batch)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    profile_window(torch, one_step, wall,
                   f"{arch} one training step, batch {TRAIN_BATCH}x"
                   f"{TRAIN_SEQ}", phase="f")
    del state, batch
    torch.cuda.empty_cache()
    return launches, trainer, out


def hybrid_config():
    """jamba's smoke config with head dim 64 (the attention kernel is built
    for 64, 96 and 128)."""
    from repro_torch import configs
    return configs.get_smoke_config(HYBRID_ARCH).replace(d_head=64)


def hybrid_path(torch, dev):
    """jamba at smoke size (head dim 64), trained ``HYBRID_STEPS`` steps on
    the card by the port's Trainer: finite losses, and launch counts the
    config's, among them the backward kernels of its SSM, attention and
    MoE layers.  Returns the launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = hybrid_config()
    tcfg = TrainerConfig(steps=HYBRID_STEPS, batch_size=HYBRID_BATCH,
                         seq_len=HYBRID_SEQ, peak_lr=3e-4, log_every=1)
    trainer = Trainer(cfg, tcfg, device=dev)
    ops.reset_launches()
    out = trainer.run()
    launches = dict(ops.LAUNCHES)
    losses = [h["loss"] for h in out["history"]]
    log("f", f"{cfg.name} (d_head 64) train {cfg.dtype} params + f32 "
        f"master, batch {HYBRID_BATCH}x{HYBRID_SEQ}, {cfg.n_layers} layers "
        f"{cfg.pattern}: losses {[round(x, 4) for x in losses]}")
    if len(losses) != HYBRID_STEPS or not all(math.isfinite(x)
                                              for x in losses):
        raise AssertionError(f"{HYBRID_ARCH} smoke losses {losses}")
    want = expected_train_launches(cfg, HYBRID_STEPS)
    log("f", f"{cfg.name} train launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"{HYBRID_ARCH} smoke launch counts "
                             f"{launches} != {want}")
    for name in ("ssd_chunk_bwd", "flash_attention_bwd", "grouped_matmul_dx",
                 "grouped_matmul_dw"):
        if not launches[name]:
            raise AssertionError(f"{HYBRID_ARCH} smoke: {name} not launched")
    del trainer, out
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase (g)
def bits_equal(torch, a, b) -> bool:
    """Two tensors of one dtype and shape with the same bits (so -0 and
    +0 differ, and a NaN equals itself)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        a, b = a.view(view), b.view(view)
    return torch.equal(a, b)


def check_same_tree(torch, name: str, got, want) -> None:
    """Every leaf of ``got`` equal to ``want``'s bit for bit."""
    from repro_torch.weights import flatten
    g, w = flatten(got), flatten(want)
    if g.keys() != w.keys():
        raise AssertionError(f"{name}: paths differ")
    for path, x in w.items():
        y = g[path]
        same = (bits_equal(torch, y, x) if torch.is_tensor(x)
                else type(y) is type(x) and y == x)
        if not same:
            raise AssertionError(f"{name}: leaf {path} differs")


def max_delta(torch, a, b) -> float:
    """max |a - b| over the leaves of two trees of tensors."""
    from repro_torch.weights import flatten
    fa, fb = flatten(a), flatten(b)
    if fa.keys() != fb.keys():
        raise AssertionError("the trees' paths differ")
    return max(float((x.detach().double() - fb[p].detach().double())
                     .abs().max()) for p, x in fa.items())


def tree_gb(torch, tree) -> float:
    from repro_torch.weights import flatten
    return sum(t.numel() * t.element_size() for t in flatten(tree).values()
               if torch.is_tensor(t)) / 1e9


def round_trip(torch, dev, trainer, out) -> None:
    """The state after phase (f)'s 6 steps, all 24 layers: a synchronous
    save and a load onto the card, every leaf bit for bit; then an async
    save with two training steps running while it writes, against two
    steps before it (after ``os.sync()``) and two after it with no save in
    flight (a measurement), and that checkpoint loaded and held against the state it
    was taken from, bit for bit."""
    from repro_torch.checkpoint import CheckpointManager, load_checkpoint
    from repro_torch.weights import tree_leaves

    ckdir = CKPT_ROOT / "full"
    shutil.rmtree(ckdir, ignore_errors=True)
    ckdir.mkdir(parents=True)
    log("g", f"free space at {ckdir}: "
        f"{shutil.disk_usage(ckdir).free / 1e9:.1f} GB")
    state, step = out["state"], out["data_step"]
    it = trainer.batches()
    it.step = step
    tree = {"params": state["params"], "opt": state["opt"],
            "data": it.state_dict()}
    gb = tree_gb(torch, tree)
    mgr = CheckpointManager(ckdir)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    mgr.save(step, tree)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_checkpoint(ckdir, step, tree, device=dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    check_same_tree(torch, "full-depth round trip", back, tree)
    log("g", f"{ARCH} {trainer.cfg.n_layers} layers, step {step}: "
        f"{gb:.2f} GB of params and optimizer state; save {t_save:.2f} s "
        f"({gb / t_save:.2f} GB/s), load onto the card {t_load:.2f} s "
        f"({gb / t_load:.2f} GB/s); every leaf the same bits")
    del back, tree
    shutil.rmtree(ckdir / f"step_{step:09d}")
    # what checksums cost: crc32 (zlib, the reference's) of the largest leaf
    from repro_torch.checkpoint.checkpoint import _crc
    big = max(tree_leaves(state["opt"]), key=lambda t: t.numel())
    host = big.cpu().numpy()
    t0 = time.perf_counter()
    _crc(host)
    t_crc = time.perf_counter() - t0
    # the save's pages still being written back would slow the steps timed
    # next: flush them first
    t0 = time.perf_counter()
    os.sync()
    log("g", f"crc32 of one {host.nbytes / 1e9:.2f} GB leaf in host memory: "
        f"{host.nbytes / 1e9 / t_crc:.2f} GB/s; os.sync() after the save "
        f"{time.perf_counter() - t0:.2f} s")
    del host

    def two_steps():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            batch = trainer.to_device(next(it))
            (state["params"], state["opt"], state["comp"],
             metrics) = trainer.step(state["params"], state["opt"],
                                     state["comp"], batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / 2

    before = two_steps()
    snap = {"params": state["params"], "opt": state["opt"],
            "data": it.state_dict()}
    t0 = time.perf_counter()
    mgr.async_save(it.step, snap)
    t_snap = time.perf_counter() - t0
    during = two_steps()
    t0 = time.perf_counter()
    mgr.wait()
    t_rest = time.perf_counter() - t0
    after = two_steps()
    log("g", f"async save of step {snap['data']['step']}: host snapshot {t_snap:.2f} s "
        f"({gb / t_snap:.2f} GB/s), then 2 steps at {during:.1f} ms a step "
        f"while it writes; the write ends {t_rest:.2f} s after them.  Steps "
        f"with no save in flight: {before:.1f} ms before, {after:.1f} ms "
        f"after")
    back = load_checkpoint(ckdir, snap["data"]["step"], snap, device=dev)
    check_same_tree(torch, "async save", back, snap)
    log("g", f"the async checkpoint holds the snapshot's bits, untouched by "
        f"the steps that ran while it was written; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB (the "
        f"snapshot's state held beside the trained one)")
    del back, snap, state
    shutil.rmtree(ckdir)
    torch.cuda.empty_cache()


def resume_path(torch, dev):
    """Kill and resume on the card: granite at full width cut to
    ``RESUME_LAYERS`` layers, 8 steps, a checkpoint every 4.  (A)
    uninterrupted, (B) the same again,
    (C) async save and a failure injected at step 4, (D) a new Trainer
    resuming from C's directory.  D's data step equals A's, its losses are
    within 1e-4 of A's, and its final state differs from A's by no more
    than B's does.  Returns D's launch counts."""
    from repro_torch import configs
    from repro_torch.checkpoint import latest_step
    from repro_torch.kernels import ops
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = configs.get_config(ARCH).replace(n_layers=RESUME_LAYERS)
    ckdir = CKPT_ROOT / "resume"
    shutil.rmtree(ckdir, ignore_errors=True)

    def trainer(ckpt=None):
        return Trainer(cfg, TrainerConfig(
            steps=RESUME_STEPS, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
            peak_lr=3e-4, log_every=1, checkpoint_dir=ckpt,
            checkpoint_every=RESUME_EVERY), device=dev)

    a = trainer().run(resume=False)
    b = trainer().run(resume=False)
    try:
        trainer(str(ckdir)).run(resume=False, fail_at_step=RESUME_EVERY)
        raise AssertionError("run C did not fail")
    except RuntimeError as e:
        if str(e) != f"injected failure at step {RESUME_EVERY}":
            raise
    if latest_step(ckdir) != RESUME_EVERY:
        raise AssertionError(f"C left step {latest_step(ckdir)}")
    ops.reset_launches()
    d = trainer(str(ckdir)).run(resume=True)
    launches = dict(ops.LAUNCHES)

    a_loss = {h["step"]: h["loss"] for h in a["history"]}
    d_loss = {h["step"]: h["loss"] for h in d["history"]}
    log("g", f"{ARCH} cut to {RESUME_LAYERS} layers, bf16 params + f32 "
        f"master, AdamW, batch {TRAIN_BATCH}x{TRAIN_SEQ}: losses A "
        f"{[round(x, 6) for x in a_loss.values()]}, B "
        f"{[round(h['loss'], 6) for h in b['history']]}, D (resumed at step "
        f"{RESUME_EVERY}) {[round(x, 6) for x in d_loss.values()]}")
    if (d["data_step"] != a["data_step"]
            or sorted(d_loss) != list(range(RESUME_EVERY, RESUME_STEPS))):
        raise AssertionError(f"D ran steps {sorted(d_loss)} to data step "
                             f"{d['data_step']}; A reached {a['data_step']}")
    worst = max(abs(d_loss[s] - a_loss[s]) / abs(a_loss[s]) for s in d_loss)
    if not worst <= 1e-4:
        raise AssertionError(f"D's losses differ from A's by {worst:.3e}")

    def final(out):
        return {"params": out["state"]["params"], "opt": out["state"]["opt"]}

    d_ba, d_da = max_delta(torch, final(b), final(a)), max_delta(
        torch, final(d), final(a))
    same = " (bitwise)" if d_ba == d_da == 0 else ""
    log("g", f"final params and optimizer state, max |delta| against A: "
        f"B {d_ba:.3e}, D {d_da:.3e}{same}; loss rel err D vs A "
        f"{worst:.3e} (bound 1e-4)")
    if d_da > d_ba:
        raise AssertionError("D is further from A than B is")
    want = expected_train_launches(cfg, RESUME_STEPS - RESUME_EVERY)
    log("g", f"D launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"resume launch counts {launches} != {want}")
    del a, b, d
    shutil.rmtree(ckdir)
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase (h)
def ep_plans(torch, cfg, T: int, es: int):
    """The three plans of (h), built from fields: a warm-up of about an
    eighth of the dispatch buffer, 4 chunks, and both."""
    from repro_torch.core import CollectivePlan
    from repro_torch.workloads.derive import moe_a2a_bytes

    n = moe_a2a_bytes(cfg, T, 1, es)

    def plan(warm, chunks):
        return CollectivePlan(total_bytes=n, n_peers=1, warmup_chunk_bytes=warm,
                              n_chunks=chunks, per_peer_buffer_bytes=n,
                              est_time_ns=0.0, est_time_unscheduled_ns=0.0)

    return {"warm-up": plan(n // 8, 1), "4 chunks": plan(0, 4),
            "both": plan(n // 8, 4)}


def ep_routing_flips(torch, moe, cfg, p_card, x_card, p_cpu, x_cpu):
    """Tokens whose top-k set differs between the card's f32 router and the
    CPU's.  Each must be a near tie on the CPU (the k-th and (k+1)-th
    probabilities within 1e-5 of each other, relative): f32 rounding in
    the two devices' dot products, not a fault."""
    k = cfg.top_k
    idx_card = moe.route(p_card, cfg, x_card)[0].cpu().sort(dim=-1).values
    idx_cpu = moe.route(p_cpu, cfg, x_cpu)[0].sort(dim=-1).values
    flips = (idx_card != idx_cpu).any(dim=-1)
    if bool(flips.any()):
        probs = torch.softmax(x_cpu.float() @ p_cpu["router"].float(), -1)
        top = probs[flips].topk(k + 1, dim=-1).values
        gap = (top[:, k - 1] - top[:, k]) / top[:, k - 1]
        if not bool((gap <= 1e-5).all()):
            raise AssertionError(f"card and CPU route {int(flips.sum())} "
                                 f"tokens differently, gaps {gap.tolist()}")
    return flips


def ep_path(torch, dev, card: str, errs):
    """Phase (h): granite-moe-1b-a400m's MoE block at full width through
    ``moe_block_ep`` on an NCCL group of one rank; returns the launch
    counts of its drive (the kernels line's ``ep`` path)."""
    from repro_torch import configs
    from repro_torch.core.overlap import _a2a
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import init_ep_group
    from repro_torch.models import moe

    t_h = time.perf_counter()
    bf, f32 = torch.bfloat16, torch.float32
    cfg = configs.get_config(ARCH)
    E, D, Fe = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    p_cpu = moe.init_moe(cfg.replace(param_dtype="float32"),
                         torch.Generator().manual_seed(21), "cpu")
    p32 = {k: v.to(dev) for k, v in p_cpu.items()}
    pbf = {k: (v if k == "router" else v.to(bf)) for k, v in p32.items()}
    gen = torch.Generator().manual_seed(22)
    xs = {T: torch.randn(T, D, generator=gen) for T in EP_TOKENS}
    # the overlap compute: granite's prefill attention, independent of the
    # send buffer
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    qkv = tuple(torch.randn(BATCH, PROMPT, h, Dh, generator=gen)
                .to(dev, bf) for h in (H, KV, KV))

    def attn(a):
        return ops.flash_attention(*a, causal=True)

    z_alone = attn(qkv)
    plans = {T: ep_plans(torch, cfg, T, 2) for T in EP_TOKENS}
    C = {T: moe._capacity(cfg, T) * E for T in EP_TOKENS}
    g = init_ep_group(dev)
    if g.backend != "nccl" or g.size != 1:
        raise AssertionError(f"EP group {g.backend} of {g.size}")
    try:
        for T in EP_TOKENS:                # first NCCL use: communicator
            moe.moe_block_ep(pbf, cfg, xs[T].to(dev, bf), g.group)
        torch.cuda.synchronize()

        # the path: counts from 0, then every block call of the drive
        ops.reset_launches()
        calls, scheduled, out = 0, 0, {}
        for T in EP_TOKENS:
            x = xs[T].to(dev, bf)
            y0, aux0 = moe.moe_block_ep(pbf, cfg, x, g.group)
            y1, aux1 = moe.moe_block_ep(pbf, cfg, x, g.group)
            calls += 2
            same_bits(torch, f"ep block T {T}", (y0, aux0), (y1, aux1))
            for name, plan in plans[T].items():
                got = []

                def compute(a):
                    got.append(attn(a))
                    return got[-1]

                ys, auxs = moe.moe_block_ep(pbf, cfg, x, g.group, plan=plan,
                                            overlap_compute=(compute, qkv))
                calls += 1
                scheduled += 1
                same_bits(torch, f"ep block T {T} under {name}", (ys, auxs),
                          (y0, aux0))
                if not (len(got) == 1 and torch.equal(got[0], z_alone)):
                    raise AssertionError(f"{name}: the overlap compute "
                                         f"changed")
            y32, _ = moe.moe_block_ep(p32, cfg, xs[T].to(dev), g.group)
            calls += 1
            out[T] = (x, y0, y32.cpu())
            if y0.shape != (T, D) or not bool(torch.isfinite(y0).all()):
                raise AssertionError(f"ep block T {T}: bad output")
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        want = {n: 0 for n in ops.KERNEL_NAMES}
        want.update(grouped_matmul=3 * calls, flash_attention=scheduled)
        log("h", f"launches {launches}, expected {want} ({calls} block "
            f"calls, {scheduled} with the attention beside the dispatch)")
        if launches != want:
            raise AssertionError(f"ep launch counts {launches} != {want}")

        # the kernel route against the plain expert FFN on the card, and
        # grouped_matmul at the receive buffer's shapes against its plain
        # version
        for T in EP_TOKENS:
            x, y0, _ = out[T]
            d = moe.ep_dispatch(pbf, cfg, x, 1)
            recv, rmeta = _a2a(d.send, g.group), _a2a(d.meta, g.group)
            y_plain = moe.ep_combine(d, _a2a(ref.expert_ffn_ref(
                pbf, recv, rmeta), g.group))
            err = compare(f"ep block T {T} vs plain FFN", y0, y_plain,
                          "bfloat16")
            order, offs = moe._expert_order(rmeta, E)
            lhs = recv.reshape(-1, D)[order]
            h = torch.randn(lhs.shape[0], Fe, generator=gen).to(dev, bf)
            e1 = compare(f"grouped_matmul recv [{lhs.shape[0]},{D}]",
                         ops.grouped_matmul(lhs, pbf["wi_gate"], offs),
                         ref.grouped_matmul_ref(lhs, pbf["wi_gate"], offs),
                         "bfloat16")
            e2 = compare(f"grouped_matmul recv [{lhs.shape[0]},{Fe}]",
                         ops.grouped_matmul(h, pbf["wo"], offs),
                         ref.grouped_matmul_ref(h, pbf["wo"], offs),
                         "bfloat16")
            errs["grouped_matmul"] = max(errs["grouped_matmul"], e1, e2)
            time_recv_gmm(torch, ops, ref, dev, card, lhs, pbf["wi_gate"],
                          offs)
            time_recv_gmm(torch, ops, ref, dev, card, h, pbf["wo"], offs)
            log("h", f"T {T}: C {C[T]}, send {list(d.send.shape)} bf16 "
                f"({d.send.nbytes} B), {int(offs[-1])} of {C[T]} rows "
                f"filled; block vs plain expert FFN max_abs_err {err:.3e} "
                f"(bf16 2e-2); grouped_matmul at the receive shapes "
                f"{e1:.3e}, {e2:.3e}; scheduled (warm-up, 4 chunks, both) "
                f"== unscheduled, bit for bit")
        ep_windows(torch, dev, card, cfg, pbf, out, plans, g, attn, qkv)
    finally:
        g.close()

    # f32 against the same block on the CPU (gloo, one rank)
    with init_ep_group("cpu") as gc:
        for T in EP_TOKENS:
            y_cpu, _ = moe.moe_block_ep(p_cpu, cfg, xs[T], gc.group)
            flips = ep_routing_flips(torch, moe, cfg, p32, xs[T].to(dev),
                                     p_cpu, xs[T])
            keep = ~flips
            err = compare(f"ep block f32 T {T}, card vs CPU",
                          out[T][2][keep], y_cpu[keep], "float32")
            log("h", f"T {T} f32: card vs CPU max_abs_err {err:.3e} (2e-5), "
                f"{int(flips.sum())} near-tie tokens routed differently")
    log("h", f"phase (h) took {time.perf_counter() - t_h:.1f} s")
    return launches


def time_recv_gmm(torch, ops, ref, dev, card: str, lhs, rhs, offs) -> None:
    """grouped_matmul at a receive buffer's shape (a tail of empty slots
    that no group covers): kernel, plain version, padded ``bmm`` and the
    bound (filled rows read, every row written); each window behind a spin
    kernel."""
    from repro_torch.launch import roofline as rl
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    T, K = lhs.shape
    E, _, N = rhs.shape
    counts = (offs[1:] - offs[:-1]).tolist()
    padded = lhs.new_zeros(E, max(counts), K)
    for e, (lo, n) in enumerate(zip(offs[:-1].tolist(), counts)):
        padded[e, :n] = lhs[lo:lo + n]
    rows, used = int(offs[-1]), sum(1 for n in counts if n)
    ms = timed_ms(torch, lambda: ops.grouped_matmul(lhs, rhs, offs), flush,
                  spin=True)
    plain = timed_ms(torch, lambda: ref.grouped_matmul_ref(lhs, rhs, offs),
                     flush, spin=True)
    lib = timed_ms(torch, lambda: torch.bmm(padded, rhs), flush, spin=True)
    b_ms, b_by = rl.bound_ms(*rl.gmm_cost(T, K, N, E, rows, used, 2),
                             "bfloat16")
    log("h", f"time grouped_matmul recv [{T},{K}]x[{E},{K},{N}] ({rows} "
        f"rows filled) bfloat16: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"library {lib:.4f} ms (padded bmm), bound {b_ms:.4g} ms ({b_by}); "
        f"{card}")


def ep_windows(torch, dev, card: str, cfg, pbf, out, plans, g, attn, qkv):
    """CUDA-event windows of the EP block's pieces (L2 flushed, host
    dispatch kept out by a spin), and the dispatch all-to-all then the
    attention against the warm-up route with the attention beside it."""
    from repro_torch.core.overlap import _a2a, scheduled_all_to_all
    from repro_torch.models import moe

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    log("h", f"windows on {card}: at world size 1 each all-to-all is a "
        f"self-copy through NCCL on one card, the cost of the machinery, "
        f"not of a fabric")
    for T in EP_TOKENS:
        x = out[T][0]
        d = moe.ep_dispatch(pbf, cfg, x, 1)
        recv, rmeta = _a2a(d.send, g.group), _a2a(d.meta, g.group)
        ffn = moe.ep_expert_ffn(pbf, recv, rmeta)
        back = _a2a(ffn, g.group)
        win = {
            "routing and packing": lambda: moe.ep_dispatch(pbf, cfg, x, 1),
            "dispatch all-to-all": lambda: _a2a(d.send, g.group),
            "metadata all-to-all": lambda: _a2a(d.meta, g.group),
            "expert FFN (3 grouped_matmul + SiLU)":
                lambda: moe.ep_expert_ffn(pbf, recv, rmeta),
            "combine all-to-all": lambda: _a2a(ffn, g.group),
            "unpack": lambda: moe.ep_combine(d, back),
            "whole block": lambda: moe.moe_block_ep(pbf, cfg, x, g.group),
        }
        ms = {name: timed_ms(torch, fn, flush, spin=True)
              for name, fn in win.items()}
        log("h", f"T {T} bf16 windows (ms, {card}): " + ", ".join(
            f"{name} {t:.4f}" for name, t in ms.items()) + f"; sum of "
            f"pieces {sum(ms.values()) - ms['whole block']:.4f}")
        warm = plans[T]["warm-up"]
        serial = timed_ms(torch, lambda: (_a2a(d.send, g.group), attn(qkv)),
                          flush, spin=True)
        hidden = timed_ms(torch, lambda: scheduled_all_to_all(
            d.send, g.group, warm, compute_fn=attn, compute_arg=qkv),
            flush, spin=True)
        alone = timed_ms(torch, lambda: attn(qkv), flush, spin=True)
        log("h", f"T {T} dispatch ({d.send.nbytes} B) then attention "
            f"q[{BATCH},{PROMPT},{cfg.n_heads},{cfg.d_head}]: {serial:.4f} "
            f"ms; warm-up route ({warm.warmup_chunk_bytes} B head, attention "
            f"beside it, then the tail) {hidden:.4f} ms; attention alone "
            f"{alone:.4f} ms ({card}; NCCL self-copy, not a fabric)")


# ------------------------------------------------------------ phase (i)
def tree_delta(torch, a, b) -> float:
    """The largest |a - b| over two trees of one structure, 0 when every
    leaf has the same bits."""
    from repro_torch.weights import flatten
    fa, fb = flatten(a), flatten(b)
    if fa.keys() != fb.keys():
        raise AssertionError("trees differ in their leaves")
    return max((0.0 if bits_equal(torch, fa[k], fb[k]) else
                float((fa[k].float() - fb[k].float()).abs().max()))
               for k in fa)


def collective_latency(torch, dev, mesh, card: str) -> None:
    """What one NCCL all-gather costs at world size 1 where each step
    depends on the one before, as the FSDP gathers do: a chain of
    (a multiply, then the all-gather of its output) against the same
    chain with a device copy, at 4 KiB and at one granite block's weights
    (55 M bf16)."""
    import torch.distributed as dist

    group = mesh.group("data")
    for numel in (2048, 55 * 2 ** 20):
        x = torch.randn(numel, device=dev, dtype=torch.bfloat16)
        out = torch.empty_like(x)
        ms = {}
        for name, move in (
                ("copy", lambda y: out.copy_(y)),
                ("all_gather", lambda y: dist.all_gather_into_tensor(
                    out, y, group=group))):
            for _ in range(3):
                move(x * 1.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                move(out * 1.0)
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3 / 50
        log("i", f"a multiply then a move of {numel * 2} B, 50 in a chain: "
            f"copy {ms['copy'] * 1e3:.1f} us, {mesh.backend} all-gather (world size 1)"
            f" {ms['all_gather'] * 1e3:.1f} us a link ({card})")


def check_local_shapes(torch, ops, ref, dev) -> None:
    """The kernels at the ``model``-local shapes of tensor-parallel compute
    (``TP_ATTN``, ``TP_GMM``), f32 and bf16, against their plain versions
    at phase (b)'s and (f)'s tolerances.  Its own generator (seed 15)."""
    gen = torch.Generator(device=dev).manual_seed(15)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for B, S, H, KV, Dh in TP_ATTN:
            q, k, v = (randn(B, S, h, Dh, dtype=dt) for h in (H, KV, KV))
            e = compare("flash_attention", ops.flash_attention(q, k, v),
                        attention_plain(torch, ref, q, k, v, True, 0), dname)
            log("i", f"flash_attention local q[{B},{S},{H},{Dh}] over {KV} "
                f"kv heads {dname}: max_abs_err {e:.3e} (tol {TOL[dname]})")
            del q, k, v
            check_attention_bwd(torch, ops, ref, randn,
                                (B, S, S, H, KV, Dh, True, 0), dname, dt,
                                phase="i")
        for T, D, Fo, E in TP_GMM:
            lhs, dy = randn(T, D, dtype=dt), randn(T, Fo, dtype=dt)
            rhs = (randn(E, D, Fo, dtype=torch.float32) / math.sqrt(D)).to(dt)
            offs = random_offsets(torch, gen, T, E)
            e = compare("grouped_matmul", ops.grouped_matmul(lhs, rhs, offs),
                        ref.grouped_matmul_ref(lhs, rhs, offs), dname)
            got = ops.grouped_matmul_bwd(lhs, rhs, offs, dy)
            want = ref.grouped_matmul_bwd_ref(lhs, rhs, offs, dy)
            e_dx, _ = compare_rel(f"grouped_matmul_dx local {dname}", got[0],
                                  want[0], BWD_TOL[dname])
            e_dw, _ = compare_rel(f"grouped_matmul_dw local {dname}", got[1],
                                  want[1], BWD_TOL[dname])
            log("i", f"grouped_matmul local [{T},{D}]x[{E},{D},{Fo}] "
                f"{dname}: max_abs_err {e:.3e} (tol {TOL[dname]}); dX "
                f"{e_dx:.3e}, dW {e_dw:.3e} (tol {BWD_TOL[dname]} x "
                f"max|ref|)")
            del lhs, dy, rhs, got, want
    torch.cuda.synchronize()


def split_norm(torch, ops, x, w, dy, m: int):
    """The norm of ``x`` [T, D] through the split launches as ``m`` model
    ranks would run it, each on its D / m columns, the partial sums added
    in rank order: (ss, y, sums, dx, dw), each whole (the columns
    concatenated)."""
    D = x.shape[1]
    xs, ws, gs = (t.chunk(m, dim=-1) for t in (x, w, dy))
    xs, gs = [t.contiguous() for t in xs], [t.contiguous() for t in gs]
    ss = sum(ops.rmsnorm_part(xi) for xi in xs)
    y = torch.cat([ops.rmsnorm_scale(xi, wi, ss, D, 1e-6)
                   for xi, wi in zip(xs, ws)], dim=-1)
    sums = sum(ops.rmsnorm_bwd_part(xi, wi, gi)
               for xi, wi, gi in zip(xs, ws, gs))
    parts = [ops.rmsnorm_bwd_scale(xi, wi, gi, sums, D, 1e-6)
             for xi, wi, gi in zip(xs, ws, gs)]
    return (ss, y, sums, torch.cat([p[0] for p in parts], dim=-1),
            torch.cat([p[1] for p in parts]))


def check_split_rmsnorm(torch, ops, ref, dev):
    """The split gated norm's four launches (``SPLIT_NAMES``) at
    ``SPLIT_RMS`` over ``SPLIT_MODELS`` and at ``SPLIT_EDGES``, f32 and
    bf16: each launch against its plain version on the same inputs (the
    sums at 2e-5 of max |ref| in f32, y at TOL, dx and dw at BWD_TOL of
    max |ref|), the whole rows against ``ref.rmsnorm_ref`` and
    ``rmsnorm_bwd_ref``, and over one rank the one-pass kernels' bits.
    Its own generator (seed 16).  Returns each launch's max abs error at
    ``SPLIT_TIMED``'s rows and split, bf16."""
    gen = torch.Generator(device=dev).manual_seed(16)
    errs = dict.fromkeys(SPLIT_NAMES, 0.0)
    f32 = BWD_TOL["float32"]
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for T, D in SPLIT_RMS + SPLIT_EDGES:
            x = torch.randn(T, D, generator=gen, device=dev).to(dt)
            dy = torch.randn(T, D, generator=gen, device=dev).to(dt)
            w = 1 + 0.1 * torch.randn(D, generator=gen, device=dev)
            models = ((1,) if D % 2 else (1, 2)) if (T, D) in SPLIT_EDGES \
                else SPLIT_MODELS
            for m in models:
                ss, y, sums, dx, dw = split_norm(torch, ops, x, w, dy, m)
                label = f"split rmsnorm [{T},{D}] over {m} {dname}"
                pieces = zip(x.chunk(m, -1), w.chunk(m), dy.chunk(m, -1))
                e = {n: 0.0 for n in SPLIT_NAMES}
                for xi, wi, gi in pieces:
                    xi, gi = xi.contiguous(), gi.contiguous()
                    e["rmsnorm_part"] = max(e["rmsnorm_part"], compare_rel(
                        f"rmsnorm_part {label}", ops.rmsnorm_part(xi),
                        ref.rmsnorm_part_ref(xi), f32)[0])
                    e["rmsnorm_scale"] = max(e["rmsnorm_scale"], compare(
                        f"rmsnorm_scale {label}",
                        ops.rmsnorm_scale(xi, wi, ss, D, 1e-6),
                        ref.rmsnorm_scale_ref(xi, wi, ss, D, 1e-6), dname))
                    e["rmsnorm_bwd_part"] = max(
                        e["rmsnorm_bwd_part"], compare_rel(
                            f"rmsnorm_bwd_part {label}",
                            ops.rmsnorm_bwd_part(xi, wi, gi),
                            ref.rmsnorm_bwd_part_ref(xi, wi, gi), f32)[0])
                    got = ops.rmsnorm_bwd_scale(xi, wi, gi, sums, D, 1e-6)
                    want = ref.rmsnorm_bwd_scale_ref(xi, wi, gi, sums, D,
                                                     1e-6)
                    e["rmsnorm_bwd_scale"] = max(
                        e["rmsnorm_bwd_scale"],
                        *(compare_rel(f"rmsnorm_bwd_scale {n} {label}", g,
                                      w_, BWD_TOL[dname])[0]
                          for n, g, w_ in zip(("dx", "dw"), got, want)))
                # the whole rows against the one-pass plain versions
                compare(f"y {label}", y, ref.rmsnorm_ref(x, w, eps=1e-6),
                        dname)
                for n, g, w_ in zip(("dx", "dw"), (dx, dw),
                                    ref.rmsnorm_bwd_ref(x, w, dy, eps=1e-6)):
                    compare_rel(f"{n} {label}", g, w_, BWD_TOL[dname])
                same = ""
                if m == 1:
                    one = (ops.rmsnorm(x, w, eps=1e-6),
                           *ops.rmsnorm_bwd(x, w, dy, 1e-6))
                    if not all(bits_equal(torch, a, b) for a, b in
                               zip((y, dx, dw), one)):
                        raise AssertionError(f"{label}: not the one-pass "
                                             f"kernels' bits")
                    same = "; the one-pass kernels' bits"
                log("i", f"{label}: max_abs_err " + ", ".join(
                    f"{n} {v:.3e}" for n, v in e.items()) + same)
                if (T, D, m) == SPLIT_TIMED and dname == "bfloat16":
                    errs = e
            del x, dy, w
    torch.cuda.synchronize()
    return errs


def time_split_rmsnorm(torch, ops, ref, dev):
    """Times of the split norm's launches at mamba2's 8 x 512 rows over
    model 1 and 16, bf16 (each window opens behind a spin kernel, so the
    host's dispatch of a launch this short stays out of it: ``timed_ms``),
    and the profiler's device time a launch of each kernel that
    ``rmsnorm_part``, ``rmsnorm_bwd_part`` and ``rmsnorm_bwd_scale`` run;
    returns
    each launch's record at ``SPLIT_TIMED`` (no single PyTorch call
    computes a half)."""
    from repro_torch.launch import roofline as rl
    gen = torch.Generator(device=dev).manual_seed(17)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    bf = torch.bfloat16
    T, D_all, _ = SPLIT_TIMED
    out = {}
    for m in (1, SPLIT_TIMED[2]):
        D = D_all // m
        x = torch.randn(T, D, generator=gen, device=dev).to(bf)
        dy = torch.randn(T, D, generator=gen, device=dev).to(bf)
        w = torch.ones(D, device=dev)
        ss = ops.rmsnorm_part(x) * m
        sums = ops.rmsnorm_bwd_part(x, w, dy) * m
        runs = {
            "rmsnorm_part": (lambda: ops.rmsnorm_part(x),
                             lambda: ref.rmsnorm_part_ref(x),
                             rl.rmsnorm_part_cost),
            "rmsnorm_scale": (
                lambda: ops.rmsnorm_scale(x, w, ss, D_all, 1e-6),
                lambda: ref.rmsnorm_scale_ref(x, w, ss, D_all, 1e-6),
                rl.rmsnorm_scale_cost),
            "rmsnorm_bwd_part": (lambda: ops.rmsnorm_bwd_part(x, w, dy),
                                 lambda: ref.rmsnorm_bwd_part_ref(x, w, dy),
                                 rl.rmsnorm_bwd_part_cost),
            "rmsnorm_bwd_scale": (
                lambda: ops.rmsnorm_bwd_scale(x, w, dy, sums, D_all, 1e-6),
                lambda: ref.rmsnorm_bwd_scale_ref(x, w, dy, sums, D_all,
                                                  1e-6),
                rl.rmsnorm_bwd_scale_cost)}
        for name, (fn, plain, cost) in runs.items():
            ms = timed_ms(torch, fn, flush, spin=True)
            plain_ms = timed_ms(torch, plain, flush, spin=True)
            b_ms, b_by = rl.bound_ms(*cost(T, D, 2), "bfloat16")
            log("i", f"time {name} [{T},{D}] (a row of {D_all} over {m}) "
                f"bfloat16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"library n/a (no single call), bound {b_ms:.4g} ms "
                f"({b_by})")
            if name in ("rmsnorm_part", "rmsnorm_bwd_part",
                        "rmsnorm_bwd_scale"):
                kernel_split(torch, fn, flush, f"{name} [{T},{D}] bfloat16",
                             phase="i")
            if m == SPLIT_TIMED[2]:
                out[name] = {"ms": ms, "plain_ms": plain_ms,
                             "library_ms": None, "bound_ms": b_ms,
                             "bound_by": b_by, "shape": f"[{T},{D}]"}
        del x, dy, w, ss, sums
    del flush
    return out


def check_local_ssd(torch, ops, ref, dev) -> None:
    """ssd_chunk and ssd_chunk_bwd on a model rank's heads of mamba2's
    training shape (``SSD_LOCAL``: 24, 12, 6 and 3 of its 48 heads): every
    output against its plain version (forward f32 TOL, backward
    SSD_BWD_TOL of max |ref|) and within ``ref.ssd_chunk_f64``'s and
    ``ref.ssd_chunk_bwd_f64``'s bounds, the backward twice bit for bit;
    both timed with their plain versions and bounds.  Its own generator
    (seed 18)."""
    from repro_torch.launch import roofline as rl
    gen = torch.Generator(device=dev).manual_seed(18)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    names = ("dx", "ddt", "da", "dB", "dC")
    for shape in SSD_LOCAL:
        BC, Q, H, P, N = shape
        x, dt, a, B, C = args = ssd_inputs(torch, gen, *shape)
        got = ops.ssd_chunk(*args)
        e = max(compare(f"ssd_chunk {shape} {n}", g, w, "float32")
                for n, g, w in zip(("y", "state"), got,
                                   ref.ssd_chunk_ref(*args)))
        y64, s64, yb, sb = ref.ssd_chunk_f64(*args)
        r = max(compare_f64(f"ssd_chunk {shape} y", got[0], y64, yb),
                compare_f64(f"ssd_chunk {shape} state", got[1], s64, sb))
        dy = torch.randn(x.shape, generator=gen, device=dev)
        ds = torch.randn((BC, H, P, N), generator=gen, device=dev)
        bwd = ops.ssd_chunk_bwd(*args, dy, ds)
        want = ref.ssd_chunk_bwd_ref(*args, dy, ds)
        vals, bounds = ref.ssd_chunk_bwd_f64(*args, dy, ds)
        eb = max(compare_rel(f"ssd_chunk_bwd {shape} {n}", g, w,
                             SSD_BWD_TOL)[0]
                 for n, g, w in zip(names, bwd, want))
        rb = max(compare_f64(f"ssd_chunk_bwd {shape} {n}", g, v, b)
                 for n, g, v, b in zip(names, bwd, vals, bounds))
        same_bits(torch, f"ssd_chunk_bwd {shape}", bwd,
                  ops.ssd_chunk_bwd(*args, dy, ds))
        t = {k: timed_ms(torch, fn, flush) for k, fn in (
            ("fwd", lambda: ops.ssd_chunk(*args)),
            ("fwd_plain", lambda: ref.ssd_chunk_ref(*args)),
            ("bwd", lambda: ops.ssd_chunk_bwd(*args, dy, ds)),
            ("bwd_plain", lambda: ref.ssd_chunk_bwd_ref(*args, dy, ds)))}
        fb = rl.bound_ms(*rl.ssd_cost(*shape), "float32")
        bb = rl.bound_ms(*rl.ssd_bwd_cost(*shape), "float32")
        log("i", f"ssd_chunk local x[{BC},{Q},{H},{P}] N {N}: max_abs_err "
            f"{e:.3e} (tol {TOL['float32']}), err/f64 bound {r:.3f}; "
            f"ssd_chunk_bwd max_abs_err {eb:.3e} (tol {SSD_BWD_TOL} x "
            f"max|ref|), err/f64 bound {rb:.3f}, deterministic; time "
            f"ssd_chunk {t['fwd']:.4f} ms (plain {t['fwd_plain']:.4f}, bound "
            f"{fb[0]:.4g} {fb[1]}), ssd_chunk_bwd {t['bwd']:.4f} ms (plain "
            f"{t['bwd_plain']:.4f}, bound {bb[0]:.4g} {bb[1]})")
        del args, x, dt, a, B, C, got, dy, ds, bwd, want, vals, bounds
        torch.cuda.empty_cache()
    del flush


def model_collectives(mesh, steps: int) -> str:
    """The collectives over ``model`` a step, by kind."""
    got = mesh.axis_collectives.get("model", {})
    return ", ".join(f"{k} {v / steps:g}" for k, v in sorted(got.items())) \
        or "none"


def sharded_path(torch, dev, card: str, trained_losses):
    """granite-moe-1b-a400m through the sharded steps on a mesh (data 1,
    model 1) of one NCCL rank: returns the path's launch counts."""
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models.api import CausalLM
    from repro_torch.parallel.fsdp import reshard, shard_tree
    from repro_torch.parallel.tp import greedy_tokens
    from repro_torch.runtime import Trainer, TrainerConfig

    t_i = time.perf_counter()
    cfg = configs.get_config(ARCH)
    # (f)'s run: the same seed, data and learning rates (the warm-up of 10
    # steps does not depend on the run's length)
    tcfg = TrainerConfig(steps=SHARD_STEPS, batch_size=TRAIN_BATCH,
                         seq_len=TRAIN_SEQ, peak_lr=3e-4, log_every=1)
    gib = 2 ** 30
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    plain = Trainer(cfg, tcfg, device=dev)
    ref = plain.run()
    plain_peak = torch.cuda.max_memory_allocated(dev) / gib
    ref_losses = [h["loss"] for h in ref["history"]]
    if ref_losses != trained_losses[:SHARD_STEPS]:
        raise AssertionError(f"unsharded losses {ref_losses} are not (f)'s "
                             f"{trained_losses[:SHARD_STEPS]}")
    with init_mesh(dev) as mesh:
        log("i", f"mesh {mesh.shape}, {mesh.backend} on a HashStore, rank "
            f"{mesh.rank} of {mesh.size}; {card}")
        sharded = Trainer(cfg, tcfg, mesh=mesh)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev) / gib
        # the state is built a leaf at a time: its peak is the state and
        # one whole leaf, not the whole state twice
        torch.cuda.reset_peak_memory_stats(dev)
        state = sharded.init_state()
        init_peak = torch.cuda.max_memory_allocated(dev) / gib - held
        log("i", f"sharded init: peak {init_peak:.2f} GiB above the "
            f"{held:.2f} GiB held, for a state of "
            f"{tree_gb(torch, state) * 1e9 / gib:.2f} GiB")
        del state
        torch.cuda.reset_peak_memory_stats(dev)
        mesh.reset_collectives()
        ops.reset_launches()
        out = sharded.run()
        train_launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev) / gib - held
        colls = dict(mesh.collectives)
        losses = [h["loss"] for h in out["history"]]
        log("i", f"{ARCH} {SHARD_STEPS} sharded train steps, batch "
            f"{TRAIN_BATCH}x{TRAIN_SEQ}: losses {losses}, unsharded "
            f"{ref_losses}; peak memory {peak:.2f} GiB above the "
            f"{held:.2f} GiB the unsharded run's state holds (unsharded "
            f"{plain_peak:.2f})")
        if any(abs(a - b) > 1e-4 * abs(b) for a, b in zip(losses,
                                                          ref_losses)):
            raise AssertionError(f"sharded losses {losses} != {ref_losses}")
        for part in ("params", "opt"):
            d = tree_delta(torch, out["state"][part], ref["state"][part])
            log("i", f"{part} after {SHARD_STEPS} steps: max |sharded - "
                f"unsharded| {d:.3e}" + (" (the same bits)" if d == 0
                                         else ""))
            if d > 1e-4:
                raise AssertionError(f"sharded {part} differ by {d}")
        want = expected_train_launches(cfg, SHARD_STEPS)
        log("i", f"train launches {train_launches}, expected {want}")
        if train_launches != want:
            raise AssertionError(f"sharded train launches {train_launches}"
                                 f" != {want}")
        if not all(colls.get(k) for k in ("all_gather", "reduce_scatter",
                                          "all_reduce")):
            raise AssertionError(f"collectives {colls}")
        log("i", "NCCL collectives a step: " + ", ".join(
            f"{k} {v / SHARD_STEPS:g}" for k, v in sorted(colls.items())) +
            "; of them over model (tensor-parallel sums): " +
            model_collectives(mesh, SHARD_STEPS))
        del out
        torch.cuda.empty_cache()

        # the step time, unsharded against sharded, in turns on one state
        # and batch (at one rank a shard is the whole leaf)
        batch = plain.to_device(next(plain.batches()))
        st = ref["state"]
        runs = {"unsharded": [], "sharded": []}
        for _ in range(SHARD_AB):
            for name in ("unsharded", "sharded", "sharded", "unsharded"):
                tr = plain if name == "unsharded" else sharded
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.step(st["params"], st["opt"], st["comp"], batch)
                torch.cuda.synchronize()
                runs[name].append((time.perf_counter() - t0) * 1e3)
        mean = {k: sum(v) / len(v) for k, v in runs.items()}
        shown = {k: [round(t, 1) for t in v] for k, v in runs.items()}
        log("i", f"step ms, {SHARD_AB} rounds of (unsharded, sharded, "
            f"sharded, unsharded): unsharded {shown['unsharded']} mean "
            f"{mean['unsharded']:.1f}; sharded {shown['sharded']} mean "
            f"{mean['sharded']:.1f}; sharded / unsharded "
            f"{mean['sharded'] / mean['unsharded']:.3f} ({card})")
        del plain, sharded, ref, st, batch
        torch.cuda.empty_cache()
        collective_latency(torch, dev, mesh, card)

        # serving: prefill 8 x 512, then greedy decode steps
        model = CausalLM.random(cfg, seed=0, device=dev)
        prompts = make_prompts(cfg, BATCH, PROMPT, seed=1, device=dev)
        shape = ShapeSpec("chip_smoke", "decode", PROMPT, BATCH)
        s_max = PROMPT + steps.sp.DECODE_MARGIN
        pre, (p_pre, b_pre), (l_spec, c_pre), _ = steps.make_prefill_step(
            cfg, mesh, shape)
        dec, (p_dec, _, c_dec), _, _ = steps.make_serve_step(
            cfg, mesh, shape)
        full = model.params
        params_pre = shard_tree(full, p_pre, mesh)
        params_dec = shard_tree(full, p_dec, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        mesh.reset_collectives()
        ops.reset_launches()
        t0 = time.perf_counter()
        logits, caches = pre(params_pre, shard_tree({"inputs": prompts},
                                                    b_pre, mesh))
        pre_model = model_collectives(mesh, 1)
        # the greedy token over vocab-local logits (here the whole vocab)
        tok = greedy_tokens(logits, l_spec, mesh)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        caches = reshard(caches, c_pre, c_dec, mesh)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pre_colls = dict(mesh.collectives)
        mesh.reset_collectives()
        # decode: attention on its head_dim shard of the cache (route of
        # models.layers._decode_on_shard, at model 1 the whole head_dim)
        got_logits, toks = [logits], [tok]
        for _ in range(SHARD_DECODE):
            logits, caches = dec(params_dec, tok, caches)
            tok = greedy_tokens(logits, l_spec, mesh)
            got_logits.append(logits)
            toks.append(tok)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        dec_colls = decode_collectives(mesh, SHARD_DECODE)
        serve_launches = dict(ops.LAUNCHES)
        serve_peak = torch.cuda.max_memory_allocated(dev) / gib
        want = expected_launches(cfg, SHARD_DECODE + 1, on_shard=True)
        log("i", f"serve launches {serve_launches}, expected {want}")
        if serve_launches != want:
            raise AssertionError(f"sharded serve launches {serve_launches} "
                                 f"!= {want}")
        # the unsharded model at the step's cache length: the same bits
        with torch.no_grad():
            torch.cuda.synchronize()
            u0 = time.perf_counter()
            want_logits, caches = model.prefill(prompts, s_max)
            torch.cuda.synchronize()
            u1 = time.perf_counter()
            wants = [want_logits]
            for t in toks[:-1]:
                want_logits, caches = model.decode_step(t, caches)
                wants.append(want_logits)
            torch.cuda.synchronize()
            u2 = time.perf_counter()
        same = all(bits_equal(torch, g, w)
                   for g, w in zip(got_logits, wants))
        log("i", f"sharded prefill [{BATCH},{PROMPT}] {(t1 - t0) * 1e3:.1f}"
            f" ms (unsharded {(u1 - u0) * 1e3:.1f}), caches resharded in "
            f"{(t2 - t1) * 1e3:.1f} ms, {SHARD_DECODE} decode steps "
            f"{(t3 - t2) * 1e3:.1f} ms (unsharded {(u2 - u1) * 1e3:.1f}), "
            f"peak memory {serve_peak:.2f} GiB; prefill and reshard "
            f"collectives {pre_colls}, over model in the prefill: "
            f"{pre_model}; {card}")
        log("i", f"decode collectives a token, by axis and kind: "
            f"{dec_colls}")
        check_decode_collectives(cfg, dec_colls, greedy=True)
        log("i", f"prefill and {SHARD_DECODE} decode logits against the "
            f"unsharded model's: {'the same bits' if same else 'differ'}")
        if not same:
            raise AssertionError("sharded logits differ from unsharded")
        # serve.generate with the same cache length: its first tokens
        got = torch.stack(toks, dim=1).cpu()
        res = generate(model, prompts, s_max - PROMPT - 8)
        log("i", f"sequence 0: {got[0].tolist()}, serve.generate "
            f"{res.tokens[0, :SHARD_DECODE + 1].tolist()}")
        if not torch.equal(got, res.tokens[:, :SHARD_DECODE + 1]):
            raise AssertionError("sharded greedy tokens differ from "
                                 "serve.generate's")
        del model, full, params_pre, params_dec, caches
        torch.cuda.empty_cache()
        encdec_launches = sharded_encdec(torch, dev, card, mesh)
        ssm_launches = sharded_ssm(torch, dev, card, mesh)
    torch.cuda.empty_cache()
    launches = {k: train_launches[k] + serve_launches[k]
                for k in train_launches}
    log("i", f"phase (i) took {time.perf_counter() - t_i:.1f} s")
    return launches, encdec_launches, ssm_launches


def sharded_ssm(torch, dev, card: str, mesh):
    """mamba2-780m at full width and depth through the sharded steps on
    ``mesh`` (1, 1): its mixers on their ``ssm_inner`` shard (at model 1
    every head), the gated norm through the split launches.
    ``SHARD_SSM_STEPS`` train steps of the sharded Trainer against the
    unsharded one from the same seed, then the sharded prefill of 8 x 512
    prompts and ``SHARD_DECODE`` greedy decode steps against the
    unsharded model's: params, optimizer state and logits the same bits,
    launches the config's, the decode's collectives a token over
    ``model`` the route's.  Returns the launch counts of the sharded
    runs."""
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.api import CausalLM
    from repro_torch.parallel.fsdp import reshard, shard_tree
    from repro_torch.parallel.tp import greedy_tokens
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = configs.get_config(SSM_ARCH)
    tcfg = TrainerConfig(steps=SHARD_SSM_STEPS, batch_size=TRAIN_BATCH,
                         seq_len=TRAIN_SEQ, peak_lr=3e-4, log_every=1)
    plain = Trainer(cfg, tcfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain.run()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    del plain
    gc_collect(torch)
    sharded = Trainer(cfg, tcfg, mesh=mesh)
    mesh.reset_collectives()
    ops.reset_launches()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = sharded.run()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(ops.LAUNCHES)
    model_train = model_collectives(mesh, SHARD_SSM_STEPS)
    losses = [h["loss"] for h in out["history"]]
    deltas = {part: tree_delta(torch, out["state"][part], ref["state"][part])
              for part in ("params", "opt")}
    log("i", f"{SSM_ARCH} {SHARD_SSM_STEPS} sharded train steps, batch "
        f"{TRAIN_BATCH}x{TRAIN_SEQ}, mixers on their ssm_inner shard: "
        f"losses {losses}, unsharded {[h['loss'] for h in ref['history']]};"
        f" max |sharded - unsharded| params {deltas['params']:.3e}, opt "
        f"{deltas['opt']:.3e}; {(t3 - t2) * 1e3:.1f} ms (unsharded "
        f"{(t1 - t0) * 1e3:.1f}, first step included); over model a step: "
        f"{model_train}; {card}")
    if any(deltas.values()):
        raise AssertionError(f"{SSM_ARCH}: sharded state is not the "
                             f"unsharded bits ({deltas})")
    want = expected_train_launches(cfg, SHARD_SSM_STEPS, on_shard=True)
    if launches != want:
        raise AssertionError(f"{SSM_ARCH} sharded train launches {launches}"
                             f" != {want}")
    del sharded, out, ref
    gc_collect(torch)

    model = CausalLM.random(cfg, seed=0, device=dev)
    prompts = make_prompts(cfg, BATCH, PROMPT, seed=1, device=dev)
    shape = ShapeSpec("chip_smoke_ssm", "decode", PROMPT, BATCH)
    s_max = PROMPT + steps.sp.DECODE_MARGIN
    pre, (p_pre, b_pre), (l_spec, c_pre), _ = steps.make_prefill_step(
        cfg, mesh, shape)
    dec, (p_dec, _, c_dec), _, _ = steps.make_serve_step(cfg, mesh, shape)
    params_pre = shard_tree(model.params, p_pre, mesh)
    params_dec = shard_tree(model.params, p_dec, mesh)
    mesh.reset_collectives()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = pre(params_pre, shard_tree({"inputs": prompts}, b_pre,
                                                mesh))
    tok = greedy_tokens(logits, l_spec, mesh)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pre_model = model_collectives(mesh, 1)
    caches = reshard(caches, c_pre, c_dec, mesh)
    got, toks = [logits], [tok]
    mesh.reset_collectives()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(SHARD_DECODE):
        logits, caches = dec(params_dec, tok, caches)
        tok = greedy_tokens(logits, l_spec, mesh)
        got.append(logits)
        toks.append(tok)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    colls = decode_collectives(mesh, SHARD_DECODE)
    serve_launches = dict(ops.LAUNCHES)
    with torch.no_grad():
        want_l, caches = model.prefill(prompts, s_max)
        wants = [want_l]
        torch.cuda.synchronize()
        u0 = time.perf_counter()
        for t in toks[:-1]:
            want_l, caches = model.decode_step(t, caches)
            wants.append(want_l)
        torch.cuda.synchronize()
        u1 = time.perf_counter()
    same = all(bits_equal(torch, g, w) for g, w in zip(got, wants))
    log("i", f"{SSM_ARCH} sharded prefill [{BATCH},{PROMPT}] "
        f"{(t1 - t0) * 1e3:.1f} ms (over model: {pre_model}), "
        f"{SHARD_DECODE} decode steps {(t3 - t2) * 1e3:.1f} ms (unsharded "
        f"{(u1 - u0) * 1e3:.1f}); decode collectives a token, by axis and "
        f"kind: {colls}; prefill and decode logits against the unsharded "
        f"model's: {'the same bits' if same else 'differ'}; {card}")
    if not same:
        raise AssertionError(f"{SSM_ARCH}: sharded logits differ")
    # a decode token over model: each mixer gathers its new xs_raw row and
    # conv_x (with conv_x_b, one buffer), sums its gated norm's rows and its
    # output; the embedding sums once, greedy_tokens gathers once
    n = cfg.n_layers
    want_c = {"all_gather": 2 * n + 1, "all_reduce": 2 * n + 1}
    if colls.get("model") != want_c:
        raise AssertionError(f"{SSM_ARCH} decode collectives over model "
                             f"{colls.get('model')} != {want_c}")
    want = expected_launches(cfg, SHARD_DECODE + 1, on_shard=True)
    log("i", f"{SSM_ARCH} train launches {launches}; serve launches "
        f"{serve_launches}, expected {want}")
    if serve_launches != want:
        raise AssertionError(f"{SSM_ARCH} sharded serve launches "
                             f"{serve_launches} != {want}")
    del model, params_pre, params_dec, caches
    gc_collect(torch)
    return {k: launches[k] + serve_launches[k] for k in launches}


def decode_collectives(mesh, steps: int):
    """The collectives a decode token, {axis: {kind: count}}."""
    return {a: {k: n / steps for k, n in sorted(kinds.items())}
            for a, kinds in sorted(mesh.axis_collectives.items())}


def check_decode_collectives(cfg, got, greedy: bool = False) -> None:
    """A decode token's collectives over ``model``, as the head_dim route
    predicts: a self-attention layer gathers its query, its new K row and
    its output, and sums its partial logits and its
    output; a cross-attention layer the same but the rows; an MoE or MLP
    sublayer sums once, the embedding once; no cache is gathered.  At
    model 1 the q heads split, so every such collective runs.  With
    ``greedy``, ``greedy_tokens`` gathers once a token too."""
    n_self = (cfg.n_layers if cfg.is_encoder_decoder else
              sum(k == "attn" for k in cfg.pattern) * cfg.n_blocks)
    n_cross = cfg.n_layers if cfg.is_encoder_decoder else 0
    want = {"all_gather": 3 * n_self + 2 * n_cross + greedy,
            "all_reduce": 2 * (n_self + n_cross) + cfg.n_layers + 1}
    if got.get("model") != want:
        raise AssertionError(f"decode collectives over model "
                             f"{got.get('model')} != {want}")


def sharded_encdec(torch, dev, card: str, mesh):
    """whisper-medium at full width, cut to SHARD_ENCDEC_LAYERS encoder
    and decoder layers, f32, through the sharded prefill and serve steps
    on ``mesh``: the decode's self- and cross-attention on their head_dim
    shards.  Logits (the prefill's and each decode step's, fed the
    unsharded greedy tokens) within 1e-4 of the unsharded model's; launch
    counts; the decode's collectives a token; decode ms of both.  Returns
    the launch counts."""
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.serve import make_embeds, make_prompts
    from repro_torch.models.api import CausalLM
    from repro_torch.parallel.fsdp import reshard, shard_tree

    cfg = configs.get_config(ENCDEC_ARCH).replace(
        dtype="float32", n_layers=SHARD_ENCDEC_LAYERS,
        n_enc_layers=SHARD_ENCDEC_LAYERS)
    prompt = PROMPTS[ENCDEC_ARCH]
    model = CausalLM.random(cfg, seed=0, device=dev)
    prompts = make_prompts(cfg, BATCH, prompt, seed=1, device=dev)
    embeds = make_embeds(cfg, BATCH, seed=2, device=dev)
    shape = ShapeSpec("chip_smoke_encdec", "decode", prompt, BATCH)
    s_max = prompt + steps.sp.DECODE_MARGIN
    pre, (p_pre, b_pre), (_, c_pre), _ = steps.make_prefill_step(
        cfg, mesh, shape)
    dec, (p_dec, _, c_dec), _, _ = steps.make_serve_step(cfg, mesh, shape)
    # the unsharded run first: its greedy tokens feed both
    with torch.no_grad():
        want, caches = model.prefill(prompts, s_max, **embeds)
        wants, toks = [want], []
        torch.cuda.synchronize()
        u0 = time.perf_counter()
        for _ in range(SHARD_DECODE):
            toks.append(torch.argmax(wants[-1], dim=-1))
            want, caches = model.decode_step(toks[-1], caches)
            wants.append(want)
        torch.cuda.synchronize()
        u1 = time.perf_counter()
    del caches
    params_pre = shard_tree(model.params, p_pre, mesh)
    params_dec = shard_tree(model.params, p_dec, mesh)
    mesh.reset_collectives()
    ops.reset_launches()
    logits, caches = pre(params_pre, shard_tree(
        {"inputs": prompts, **embeds}, b_pre, mesh))
    caches = reshard(caches, c_pre, c_dec, mesh)
    got = [logits]
    mesh.reset_collectives()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tok in toks:
        logits, caches = dec(params_dec, tok, caches)
        got.append(logits)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = dict(ops.LAUNCHES)
    colls = decode_collectives(mesh, SHARD_DECODE)
    err = max(float((g - w).abs().max()) for g, w in zip(got, wants))
    log("i", f"{ENCDEC_ARCH} {cfg.n_enc_layers} + {cfg.n_layers} layers "
        f"f32, batch {BATCH}, prompt {prompt}, frames {cfg.enc_frames}: "
        f"sharded prefill and {SHARD_DECODE} decode logits against the "
        f"unsharded model's: max abs err {err:.3e} (bound 1e-4); "
        f"{SHARD_DECODE} decode steps {(t1 - t0) * 1e3:.1f} ms (unsharded "
        f"{(u1 - u0) * 1e3:.1f}); {card}")
    log("i", f"{ENCDEC_ARCH} decode collectives a token, by axis and kind: "
        f"{colls}")
    want_l = expected_launches(cfg, SHARD_DECODE + 1, on_shard=True)
    log("i", f"{ENCDEC_ARCH} sharded serve launches {launches}, expected "
        f"{want_l}")
    if not err <= 1e-4:
        raise AssertionError(f"{ENCDEC_ARCH}: sharded logits differ by "
                             f"{err}")
    if launches != want_l:
        raise AssertionError(f"{ENCDEC_ARCH}: sharded launches {launches} "
                             f"!= {want_l}")
    check_decode_collectives(cfg, colls)
    del model, params_pre, params_dec, caches
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase (j)
DRY_CODE = """
import json, sys
sys.path.insert(0, 'src')
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
out = {}
for arch, s in %r:
    cell = dryrun.run_cell(arch, ShapeSpec(*s), mesh_shape=(1, 1),
                           verbose=False)
    if cell["status"] != "ok":
        raise SystemExit(cell["traceback"])
    out[arch + "|" + s[0]] = cell
print(json.dumps(out))
"""


def dry_cells():
    """The dry-run of phase (j)'s cells over a fake world at (1, 1) on the
    meta device, in a subprocess that sees no GPU: {arch|shape: cell}."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    run = subprocess.run([sys.executable, "-c", DRY_CODE % (COUNT_CELLS,)],
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=600, env=env)
    if run.returncode:
        raise AssertionError(f"dry-run failed: {run.stderr[-3000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def held_bytes(torch, tree) -> int:
    """The bytes of the storages of ``tree``'s tensors."""
    from repro_torch.launch.roofline import tensors
    seen = {}
    for t in tensors(tree):
        seen[id(t.untyped_storage())] = t.untyped_storage().nbytes()
    return sum(seen.values())


def compare_counts(name: str, card, dry) -> None:
    """The card's counts against the dry-run's: aten FLOPs, kernel records
    and collectives (count and bytes, by kind and axis) equal; a grouped
    matmul's launches equal and its rows, FLOPs and bytes at most the
    dry-run's capacity bound (printed)."""
    for key in ("aten_flops", "collectives", "axis_collectives"):
        if card[key] != dry[key]:
            raise AssertionError(f"{name}: {key} on the card {card[key]} != "
                                 f"the dry-run's {dry[key]}")
    if set(card["kernels"]) != set(dry["kernels"]):
        raise AssertionError(f"{name}: kernels {sorted(card['kernels'])} != "
                             f"{sorted(dry['kernels'])}")
    for k, rec in dry["kernels"].items():
        got = card["kernels"][k]
        if k.startswith("grouped_matmul"):
            if got["launches"] != rec["launches"] or any(
                    got[f] > rec[f] for f in ("rows", "flops", "bytes")):
                raise AssertionError(f"{name}: {k} {got} beyond the bound "
                                     f"{rec}")
            fewer = rec["rows"] - got["rows"]
            log("j", f"{name}: {k} rows {got['rows']} on the card, "
                f"{rec['rows']} the dry-run's bound ({fewer} fewer; FLOPs "
                f"{got['flops']} against {rec['flops']})")
        elif got != rec:
            raise AssertionError(f"{name}: {k} {got} != the dry-run's {rec}")


def counted_path(torch, dev, card: str):
    """Phase (j): returns the launch counts of the counted runs."""
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import init_mesh

    t_j = time.perf_counter()
    dry = dry_cells()
    log("j", f"dry-run of {len(dry)} cells at (1, 1) on meta in "
        f"{time.perf_counter() - t_j:.1f} s")
    launches = {name: 0 for name in ops.KERNEL_NAMES}
    gib = 2 ** 30
    with init_mesh(dev) as mesh:
        for arch, s in COUNT_CELLS:
            cfg = configs.get_config(arch)
            shape = ShapeSpec(*s)
            name = (f"{arch} {shape.kind} {shape.global_batch}x"
                    f"{shape.seq_len}")
            gc_collect(torch)
            cell = dryrun.build_cell(arch, shape, mesh, device=dev, seed=3)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(dev)
            held = held_bytes(torch, cell.args)
            torch.cuda.reset_peak_memory_stats(dev)
            mesh.reset_collectives()
            ops.reset_launches()
            counter, out, count_s = dryrun.count_cell(cell)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) - before + held
            for k, n in ops.LAUNCHES.items():
                launches[k] += n
            got = counter.as_dict()
            recorded = {k: r["launches"] for k, r in got["kernels"].items()}
            if recorded != {k: n for k, n in ops.LAUNCHES.items() if n}:
                raise AssertionError(f"{name}: recorded {recorded}, "
                                     f"launched {dict(ops.LAUNCHES)}")
            del out
            times = []
            for _ in range(COUNT_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = cell.run()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                del out
            step_s = sum(times) / len(times)
            terms = counter.terms()
            d = dry[f"{arch}|{shape.name}"]
            log("j", f"{name}: counted in {count_s:.2f} s; aten "
                f"{got['aten_flops']} FLOPs, kernels " + ", ".join(
                    f"{k} {r['launches']}x {r['flops']} FLOPs "
                    f"{r['bytes']} B" for k, r in got["kernels"].items())
                + f"; HBM {terms.hbm_bytes:.6g} B (aten "
                f"{got['aten_bytes']}); collectives " + ", ".join(
                    f"{a}/{k} {r['count']}x {r['bytes']} B"
                    for a, kinds in got["axis_collectives"].items()
                    for k, r in kinds.items()))
            compare_counts(name, got, d["counts"])
            err = abs(d["memory"]["peak_bytes"] - peak) / peak
            max_alloc = torch.cuda.max_memory_allocated(dev)
            log("j", f"{name}: peak {peak / gib:.3f} GiB on the card "
                f"(max_memory_allocated {max_alloc / gib:.3f} GiB, of it "
                f"{(before - held) / gib:.3f} GiB held before the "
                f"step's inputs), counter "
                f"{counter.peak_bytes / gib:.3f}, dry-run "
                f"{d['memory']['peak_bytes'] / gib:.3f}: "
                f"{err * 100:.2f}% off (limit 10%)")
            if err > COUNT_PEAK_TOL:
                raise AssertionError(f"{name}: dry-run peak off by "
                                     f"{err * 100:.1f}%")
            mf = dryrun.model_flops(cfg, shape)
            log("j", f"{name}: step {step_s * 1e3:.1f} ms (mean of "
                f"{COUNT_TIMED}: {[round(t * 1e3, 1) for t in times]}, "
                f"no counter); model FLOPs {mf:.6g}, MFU "
                f"{mf / (step_s * rl.PEAK_FLOPS['bfloat16']):.4f}; "
                f"roofline t_bound {terms.t_bound * 1e3:.2f} ms "
                f"({terms.bottleneck}: compute "
                f"{terms.t_compute * 1e3:.2f}, memory "
                f"{terms.t_memory * 1e3:.2f}, collective "
                f"{terms.t_collective * 1e3:.2f}), t_bound / step "
                f"{terms.t_bound / step_s:.4f}; {card}")
            del cell, counter
    gc_collect(torch)
    log("j", f"phase (j) took {time.perf_counter() - t_j:.1f} s")
    return launches


def gc_collect(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def run_ab(parent: str, call: str, keep, same=None) -> int:
    """``call`` (an expression on ``c``, this module, and ``torch``) in
    the checkout at PARENT and in this one, each in a fresh process, in
    turns parent, change, change, parent; prints each run's lines for
    which ``keep`` holds.  With ``same``, the lines for which it holds
    must be alike in the four runs, and there must be some."""
    code = ("import sys, torch; sys.path[:0] = ['src', '.']; "
            "torch.backends.cuda.matmul.allow_tf32 = False; "
            "torch.backends.cudnn.allow_tf32 = False; "
            f"import chip_smoke as c; {call}")
    alike = []
    for label, root in (("parent", parent), ("change", str(ROOT)),
                        ("change", str(ROOT)), ("parent", parent)):
        run = subprocess.run([sys.executable, "-c", code], cwd=root,
                             capture_output=True, text=True, timeout=900)
        lines = [ln for ln in run.stdout.splitlines() if keep(ln)]
        for line in lines:
            print(f"(ab) {label}: {line}", flush=True)
        if run.returncode:
            print(run.stderr[-3000:], file=sys.stderr)
            return 1
        if same is not None:
            alike.append([ln for ln in lines if same(ln)])
    if same is not None:
        if not alike[0] or any(a != alike[0] for a in alike):
            print("(ab) the runs' checked lines differ or are missing",
                  file=sys.stderr)
            return 1
        print(f"(ab) {len(alike[0])} checked lines alike in all four runs",
              flush=True)
    return 0


# ``--rms-ab``'s run, in either checkout (so it calls only what the parent
# has too): a crc32 of the bytes of rmsnorm_bwd's dx and dw at every
# ``RMS_BWD`` and ``RMS_BWD_EDGES`` shape, and of rmsnorm_bwd_part's sums and
# rmsnorm_bwd_scale's dx and dw on each shard of ``SPLIT_RMS`` over
# ``SPLIT_MODELS`` and of ``SPLIT_EDGES`` over 1 and 2, f32 and bf16, from
# seeded inputs; then rmsnorm_bwd's window at every ``RMS_BWD`` shape in
# bf16 ([4096,3072] last), the device time of its kernels there and of
# rmsnorm_bwd_part's, the windows of rmsnorm_bwd,
# rmsnorm_bwd_part and rmsnorm_part there behind a read of the flush buffer
# rather than its zero fill, and the split launches' times
# (``time_split_rmsnorm``), each window behind the spin kernel.
RMS_AB = f"""
import functools, zlib
from repro_torch.kernels import build, ops, ref
build.build_all()
dev = torch.device("cuda")
c.timed_ms = functools.partial(c.timed_ms, spin=True)
gen = torch.Generator(device=dev).manual_seed(19)


def digest(*ts):
    h = 0
    for t in ts:
        h = zlib.crc32(t.contiguous().view(torch.uint8).cpu().numpy()
                       .tobytes(), h)
    return format(h, "08x")


for dname in ("float32", "bfloat16"):
    dt = getattr(torch, dname)
    for T, D in {RMS_BWD + RMS_BWD_EDGES!r}:
        x, dy = (torch.randn(T, D, generator=gen, device=dev).to(dt)
                 for _ in range(2))
        w = torch.randn(D, generator=gen, device=dev)
        print(f"digest rmsnorm_bwd [{{T}},{{D}}] {{dname}}: "
              f"{{digest(*ops.rmsnorm_bwd(x, w, dy, 1e-6))}}", flush=True)
    for T, D in {SPLIT_RMS + SPLIT_EDGES!r}:
        x, dy = (torch.randn(T, D, generator=gen, device=dev).to(dt)
                 for _ in range(2))
        w = 1 + 0.1 * torch.randn(D, generator=gen, device=dev)
        models = {SPLIT_MODELS!r} if (T, D) in {SPLIT_RMS!r} else (
            (1,) if D % 2 else (1, 2))
        for m in models:
            xs, ws, gs = (t.chunk(m, dim=-1) for t in (x, w, dy))
            xs, gs = [t.contiguous() for t in xs], [t.contiguous() for t in gs]
            parts = [ops.rmsnorm_bwd_part(xi, wi, gi)
                     for xi, wi, gi in zip(xs, ws, gs)]
            sums = sum(parts)
            scaled = [t for xi, wi, gi in zip(xs, ws, gs)
                      for t in ops.rmsnorm_bwd_scale(xi, wi, gi, sums, D, 1e-6)]
            print(f"digest rmsnorm_bwd_part [{{T}},{{D}}] over {{m}} "
                  f"{{dname}}: {{digest(*parts)}}; rmsnorm_bwd_scale "
                  f"{{digest(*scaled)}}", flush=True)
flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
for T, D in {[t for t in RMS_BWD if t != (4096, 3072)] + [(4096, 3072)]!r}:
    x, dy = (torch.randn(T, D, generator=gen, device=dev)
             .to(torch.bfloat16) for _ in range(2))
    w = torch.ones(D, device=dev)
    bwd = lambda: ops.rmsnorm_bwd(x, w, dy, 1e-6)
    print(f"time rmsnorm_bwd [{{T}},{{D}}] bfloat16: kernel "
          f"{{c.timed_ms(torch, bwd, flush):.4f}} ms", flush=True)
c.kernel_split(torch, bwd, flush, "rmsnorm_bwd [4096,3072] bfloat16")
c.kernel_split(torch, lambda: ops.rmsnorm_bwd_part(x, w, dy), flush,
               "rmsnorm_bwd_part [4096,3072] bfloat16", phase="i")
# the same windows behind a read of the flush buffer instead of its zero
# fill, which leaves L2 full of dirty lines for the kernel's reads to evict
sink = torch.empty((), dtype=torch.int64, device=dev)
read = functools.partial(torch.sum, flush, dim=0, dtype=torch.int64, out=sink)
for name, fn in (("rmsnorm_bwd", bwd),
                 ("rmsnorm_bwd_part", lambda: ops.rmsnorm_bwd_part(x, w, dy)),
                 ("rmsnorm_part", lambda: ops.rmsnorm_part(x))):
    for _ in range(3):
        fn()
    ts = []
    for _ in range(20):
        read()
        torch.cuda._sleep(c.SPIN_CYCLES)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        ts.append((s, e))
    torch.cuda.synchronize()
    ms = sum(s.elapsed_time(e) for s, e in ts) / len(ts)
    print(f"time {{name}} [4096,3072] bfloat16 behind a read of the flush "
          f"buffer (not its zero fill): kernel {{ms:.4f}} ms", flush=True)
del x, dy, w, flush, sink
c.time_split_rmsnorm(torch, ops, ref, dev)
"""


# ``--attn-ab``'s run, in either checkout (so it calls only what the parent
# has too): flash_attention's bf16 forward at granite's prefill and the
# ``ATTN_NEW`` rows, then flash_attention_bwd at ``ATTN_BWD_TIMED`` with its
# launches' device times, L2 flushed and each window behind the spin kernel,
# with the plan from ``ops`` (a checkout without ``ops.attention_plan``
# prints its ``chip_smoke.attention_route``, and one without that the
# mma.sync route) and the host CPU on every line; then a crc32 of the bytes
# of the forward's output and LSE, of the output without the LSE and of the
# backward's dq, dk and dv at every ``ATTN_KEPT`` shape, f32 and bf16, from
# seeded inputs: the routes this checkout keeps must give the parent's bits
ATTN_ROWS = [(BATCH, PROMPT, PROMPT, 16, 8, 64, True, 0)] + ATTN_NEW
# every forward and backward route but the split decode one: wgmma at
# granite's prefill, the whisper cross-attention at Sq 224, phi-3's Dh 96, a
# window at Dh 128, Sq != Sk at Dh 96, and a window of 65; mma.sync at 17
# rows, 63 rows (causal), Sk 127 below the split route and causal decode
ATTN_KEPT = [(8, 512, 512, 16, 8, 64, True, 0),
             (8, 224, 1500, 16, 16, 64, False, 0),
             (2, 768, 768, 32, 32, 96, True, 0),
             (1, 2048, 2048, 64, 8, 128, True, 1024),
             (2, 129, 77, 8, 4, 96, False, 0),
             (2, 300, 300, 8, 2, 128, True, 65),
             (2, 17, 1500, 4, 4, 64, False, 0),
             (1, 63, 63, 4, 4, 64, True, 0),
             (2, 1, 127, 8, 8, 64, False, 0),
             (2, 1, 1, 8, 2, 64, True, 0)]
ATTN_AB = f"""
import functools, zlib
from repro_torch.kernels import build, ops
build.build_all()
dev = torch.device("cuda")
cpu = c.host_cpu()
gen = torch.Generator(device=dev).manual_seed(23)
flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
bf = torch.bfloat16


def route(B, Sq, Sk, H, KV, Dh, causal):
    if hasattr(ops, "attention_plan"):
        return ops.attention_plan(B, Sq, Sk, H, KV, Dh, bf, causal)
    if hasattr(c, "attention_route"):
        return c.attention_route(Sq, H, KV, Sk, "bfloat16")
    return "mma.sync (flash_mma_kernel)"


def bwd_route(B, S, H, KV):
    if hasattr(ops, "attention_bwd_plan"):
        return ops.attention_bwd_plan(B, S, S, H, KV, bf)
    if hasattr(c, "attention_bwd_route"):
        return c.attention_bwd_route(B, S, H, KV, S, "bfloat16")
    return "mma.sync (flash_bwd_dkdv_mma_kernel, flash_bwd_dq_mma_kernel)"


def digest(*ts):
    h = 0
    for t in ts:
        h = zlib.crc32(t.contiguous().view(torch.uint8).cpu().numpy()
                       .tobytes(), h)
    return format(h, "08x")


for B, Sq, Sk, H, KV, Dh, causal, window in {ATTN_ROWS!r}:
    q, k, v = (torch.randn(*sh, generator=gen, device=dev)
               .to(bf) for sh in ((B, Sq, H, Dh), (B, Sk, KV, Dh),
                                  (B, Sk, KV, Dh)))
    fn = functools.partial(ops.flash_attention, q, k, v, causal=causal,
                           window=window)
    ms = c.timed_ms(torch, fn, flush, spin=True)
    print(f"time flash_attention q[{{B}},{{Sq}},{{H}},{{Dh}}] "
          f"k[{{B}},{{Sk}},{{KV}},{{Dh}}] causal {{causal}} window {{window}} "
          f"bfloat16: kernel {{ms:.4f}} ms; route "
          f"{{route(B, Sq, Sk, H, KV, Dh, causal)}}; host {{cpu}}",
          flush=True)
    del q, k, v, fn
for B, S, H, KV, Dh in {ATTN_BWD_TIMED!r}:
    q, do = (torch.randn(B, S, H, Dh, generator=gen, device=dev)
             .to(bf) for _ in range(2))
    k, v = (torch.randn(B, S, KV, Dh, generator=gen, device=dev)
            .to(bf) for _ in range(2))
    o, lse = ops.flash_attention_fwd(q, k, v, causal=True, with_lse=True)
    fn = functools.partial(ops.flash_attention_bwd, q, k, v, o, lse, do,
                           causal=True)
    ms = c.timed_ms(torch, fn, flush, spin=True)
    print(f"time flash_attention_bwd q[{{B}},{{S}},{{H}},{{Dh}}] causal "
          f"bfloat16: kernel {{ms:.4f}} ms; route {{bwd_route(B, S, H, KV)}}; "
          f"host {{cpu}}", flush=True)
    c.kernel_split(torch, fn, flush,
                   f"flash_attention_bwd q[{{B}},{{S}},{{H}},{{Dh}}] causal "
                   f"bfloat16")
    del q, do, k, v, o, lse, fn
gen = torch.Generator(device=dev).manual_seed(29)
for dname in ("float32", "bfloat16"):
    dt = getattr(torch, dname)
    for B, Sq, Sk, H, KV, Dh, causal, window in {ATTN_KEPT!r}:
        q, do = (torch.randn(B, Sq, H, Dh, generator=gen, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(B, Sk, KV, Dh, generator=gen, device=dev).to(dt)
                for _ in range(2))
        kw = dict(causal=causal, window=window)
        o, lse = ops.flash_attention_fwd(q, k, v, with_lse=True, **kw)
        grads = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        shape = (B, Sq, Sk, H, KV, Dh, causal, window)
        print(f"digest flash_attention {{shape}} {{dname}}: forward "
              f"{{digest(o, lse)}}, without the LSE "
              f"{{digest(ops.flash_attention(q, k, v, **kw))}}, backward "
              f"{{digest(*grads)}}", flush=True)
        del q, do, k, v, o, lse, grads
"""


# what each A/B of ``--train-ab``, ``--split-ab``, ``--rms-ab`` and
# ``--attn-ab`` runs and prints (and which printed lines must be alike in
# its four runs)
AB = {
    "--train-ab": ("c.train_path(torch, torch.device('cuda'))",
                   lambda line: any(k in line for k in
                                    ("train bf16", "profile", "losses"))),
    # the parent's windows open behind the same spin kernel as this one's
    "--split-ab": ("import functools; "
                   "from repro_torch.kernels import build, ops, ref; "
                   "build.build_all(); "
                   "c.timed_ms = functools.partial(c.timed_ms, spin=True); "
                   "c.time_split_rmsnorm(torch, ops, ref, "
                   "torch.device('cuda'))",
                   lambda line: "time " in line or "profile" in line),
    "--rms-ab": (f"exec({RMS_AB!r})",
                 lambda line: any(k in line for k in
                                  ("digest ", "time ", "profile")),
                 lambda line: line.startswith("digest ")),
    "--attn-ab": (f"exec({ATTN_AB!r})",
                  lambda line: any(k in line for k in
                                   ("digest ", "time ", "profile")),
                  lambda line: line.startswith("digest ")),
}


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
    if sys.argv[1:2] and sys.argv[1] in AB and len(sys.argv) == 3:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60)
        print(smi.stdout.strip().splitlines()[0], flush=True)
        print(f"host CPU {host_cpu()}", flush=True)
        return run_ab(sys.argv[2], *AB[sys.argv[1]])
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import roofline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device("cuda")
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log("a", f"host CPU {host_cpu()}")

    total = torch.cuda.get_device_properties(0).total_memory
    log("a", f"device memory {total} bytes (launch.roofline.HBM_BYTES: "
        f"{roofline.HBM_BYTES})")
    build.build_all()
    log("a", f"kernels built in {build.BUILD_SECONDS:.2f} s")
    for name, text in build.BUILD_LOG.items():
        for kernel, regs, spills in ptxas_report(text):
            log("a", f"ptxas {name}: {kernel}: {regs} registers, {spills}")
    check_tensor_core_sass(build)
    log("a", f"(a) {time.perf_counter() - t_start:.1f} s")

    errs = check_kernels(torch, ops, ref, dev)
    check_new_attention(torch, ops, ref, dev)
    check_wgmma_attention(torch, ops, ref, dev)
    times = time_kernels(torch, ops, ref, dev)
    times["flash_attention"]["by_shape"] = time_new_attention(torch, ops,
                                                              ref, dev)
    sweep_decode_splits(torch, ops, build, dev)
    log("b", f"(a) to (b) {time.perf_counter() - t_start:.1f} s")
    by_path = {arch: main_path(torch, dev, arch) for arch in SERVING}
    log("c", f"(a) to (c) {time.perf_counter() - t_start:.1f} s")
    whole_model_checks(torch, dev, ARCH, (16,), 4)
    whole_model_checks(torch, dev, SSM_ARCH, (16, 2), 2)
    whole_model_checks(torch, dev, DENSE_ARCH, (16,), 4)
    whole_model_checks(torch, dev, ENCDEC_ARCH, (16,), 4)
    whole_model_checks(torch, dev, VLM_ARCH, (16,), 4)
    whole_model_checks(torch, dev, DENSE_ARCH, (200,), 80, window=20)
    log("d", f"(a) to (d) {time.perf_counter() - t_start:.1f} s")
    by_path["calibrate"], profiles = calibration_profiles(torch, dev)
    simulator_path(profiles)
    from repro_torch.workloads.calibrate import default_cache_path
    serving_path(default_cache_path(ARCH, CAL_SHAPE, CAL_GPUS,
                                    root=ROOT / "build" / "calibration"))
    for name in build.KERNELS:
        if not any(by_path[arch][name] for arch in SERVING):
            raise AssertionError(f"{name}: no serving path launched it")

    t_f = time.perf_counter()
    log("e", f"(a) to (e) {t_f - t_start:.1f} s")
    errs.update(check_backward_kernels(torch, ops, ref, dev))
    errs["ssd_chunk_bwd"] = check_ssd_bwd(torch, ops, ref, dev)
    times.update(time_backward_kernels(torch, ops, ref, dev))
    grads_card_vs_cpu(torch, dev, ARCH, 2, 64)
    grads_card_vs_cpu(torch, dev, ENCDEC_ARCH, 2, 32)
    grads_card_vs_cpu(torch, dev, SSM_ARCH, 2, TRAIN_SEQ)
    grads_card_vs_cpu(torch, dev, HYBRID_ARCH, 2, HYBRID_SEQ,
                      cfg=hybrid_config(), bound=None)
    # each path's trainer and state are freed before the next one trains
    by_path["train_ssm"] = train_path(torch, dev, SSM_ARCH)[0]
    gc_collect(torch)
    by_path["train_hybrid"] = hybrid_path(torch, dev)
    gc_collect(torch)
    by_path["train"], trainer, trained = train_path(torch, dev)
    for name in GRANITE_BWD:
        if not by_path["train"][name]:
            raise AssertionError(f"{name}: the training path did not "
                                 f"launch it")
    now = time.perf_counter()
    log("f", f"phase (f) took {now - t_f:.1f} s; (a) to (f) "
        f"{now - t_start:.1f} s")

    t_g = time.perf_counter()
    round_trip(torch, dev, trainer, trained)
    train_losses = [h["loss"] for h in trained["history"]]
    del trainer, trained
    by_path["resume"] = resume_path(torch, dev)
    for name in ("rmsnorm", "flash_attention", "grouped_matmul",
                 *GRANITE_BWD):
        if not by_path["resume"][name]:
            raise AssertionError(f"{name}: the resumed run did not launch "
                                 f"it")
    now = time.perf_counter()
    log("g", f"phase (g) took {now - t_g:.1f} s; (a) to (g) "
        f"{now - t_start:.1f} s")

    by_path["ep"] = ep_path(torch, dev, card, errs)
    log("h", f"(a) to (h) {time.perf_counter() - t_start:.1f} s")

    (by_path["sharded"], by_path["sharded_encdec"],
     by_path["sharded_ssm"]) = sharded_path(torch, dev, card, train_losses)
    for name in SPLIT_NAMES:
        if not by_path["sharded_ssm"][name]:
            raise AssertionError(f"{name}: mamba2's sharded path did not "
                                 f"launch it")
    check_local_shapes(torch, ops, ref, dev)
    errs.update(check_split_rmsnorm(torch, ops, ref, dev))
    times.update(time_split_rmsnorm(torch, ops, ref, dev))
    check_local_ssd(torch, ops, ref, dev)
    for name in ("rmsnorm", "flash_attention", "grouped_matmul",
                 *GRANITE_BWD):
        if not by_path["sharded"][name]:
            raise AssertionError(f"{name}: the sharded path did not launch "
                                 f"it")
    log("i", f"(a) to (i) {time.perf_counter() - t_start:.1f} s")

    by_path["counted"] = counted_path(torch, dev, card)
    for name in ops.KERNEL_NAMES:
        if not by_path["counted"][name]:
            raise AssertionError(f"{name}: the counted steps did not launch "
                                 f"it")
    log("j", f"(a) to (j) {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name in ops.KERNEL_NAMES:
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      f"{SOURCES.get(name, name)}.cu",
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
