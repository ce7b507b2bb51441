"""CLI: derive a model workload and replay it through a warm-TLB session.

    PYTHONPATH=src python -m repro_torch.workloads \
        --arch qwen3-moe-235b-a22b --shape decode_32k --gpus 16 --steps 4

Prints the derived collective mix, then the per-step (per-token for decode)
communication-degradation trajectory: step 0 pays the cold Link-TLB walks,
later steps reuse the warmed entries.  The lines are those of the
reference's ``python -m repro.workloads`` with the same arguments.

``--calibrate`` times the port's kernels on the H100 (``--device cpu``
runs their plain versions, for tests; ``--reps`` timed calls per kernel)
and replays with the resulting per-phase compute windows instead of the
roofline, caching the profile JSON under ``calibration/`` (or at
``--profile``); without ``--calibrate``, ``--profile`` loads a saved JSON
instead of measuring.  Everything except ``--calibrate`` itself needs no
GPU and imports no torch.
"""
from __future__ import annotations

import argparse
from collections import Counter

from ..core.config import SimConfig
from ..core.topology import TOPOLOGIES
from .calibrate import ComputeProfile, calibrate, default_cache_path
from .derive import PodSpec, derive_workload, pod_fabric
from .replay import replay


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.workloads",
        description="Replay a model-derived collective sequence through the "
                    "RAT simulator with persistent (warm) Link TLBs.")
    p.add_argument("--arch", required=True,
                   help="architecture registry name, e.g. qwen3-moe-235b-a22b")
    p.add_argument("--shape", default="decode_32k",
                   help="input shape: decode_32k | prefill_32k | train_4k")
    p.add_argument("--gpus", type=int, default=16, help="pod size")
    p.add_argument("--steps", type=int, default=4,
                   help="model steps to replay (decode: tokens)")
    p.add_argument("--topology", default="single_clos",
                   choices=sorted(TOPOLOGIES),
                   help="pod topology (repro_torch.core.topology); "
                        "hierarchical topologies map TP intra-tier and let "
                        "the EP all-to-all cross the oversubscribed uplink")
    p.add_argument("--leaf", type=int, default=0,
                   help="two_tier: GPUs per leaf switch (0: fabric default)")
    p.add_argument("--oversub", type=float, default=1.0,
                   help="two_tier: leaf->spine oversubscription factor")
    p.add_argument("--pod-size", type=int, default=0,
                   help="multi_pod: GPUs per pod (0: whole fabric)")
    p.add_argument("--retention-ns", type=float, default=None,
                   help="flush TLBs when an idle gap exceeds this (default: "
                        "entries survive gaps)")
    p.add_argument("--engine", default="event",
                   choices=("event", "vectorized"),
                   help="simulation engine (identical results; vectorized "
                        "is ~10x faster at pod scale)")
    p.add_argument("--calibrate", action="store_true",
                   help="time the port's kernels and replay with calibrated "
                        "compute windows (cached under calibration/)")
    p.add_argument("--profile", default=None, metavar="JSON",
                   help="replay with a previously cached compute profile "
                        "(loads JSON, measures nothing); with --calibrate, "
                        "where the measured profile is cached")
    p.add_argument("--force-calibrate", action="store_true",
                   help="re-measure even when a cached profile exists")
    p.add_argument("--policy", default="fixed", metavar="SPEC",
                   help="collective algorithm selection: fixed | auto | "
                        "table:<path> (repro_torch.core.select; fixed keeps "
                        "the historical choices bit-for-bit)")
    p.add_argument("--disagg", type=int, default=0, metavar="PROMPT_TOKENS",
                   help="also derive the disaggregation KV-cache handoff "
                        "for a prompt of this many tokens: per-GPU shard "
                        "size and the resolved kv_transfer collective "
                        "(DESIGN.md §16)")
    p.add_argument("--reps", type=int, default=3,
                   help="--calibrate: timed calls per kernel (best is kept)")
    p.add_argument("--device", default=None,
                   help="--calibrate: cuda (default) or cpu (plain "
                        "versions, tests only)")
    args = p.parse_args(argv)

    pod_spec = PodSpec(topology=args.topology, leaf_size=args.leaf,
                       oversubscription=args.oversub,
                       pod_size=args.pod_size)
    profile = None
    if args.calibrate:
        cache = args.profile or default_cache_path(args.arch, args.shape,
                                                   args.gpus)
        profile = calibrate(args.arch, args.shape, pod=pod_spec,
                            n_gpus=args.gpus, reps=args.reps,
                            cache_path=cache, force=args.force_calibrate,
                            device=args.device)
        print(f"# compute profile ({cache}): {profile.arch} / "
              f"{profile.shape} on {profile.n_gpus} GPUs (ep={profile.ep} "
              f"tp={profile.tp} dp={profile.dp}), "
              f"interpret={profile.interpret}")
        for name, w in sorted(profile.phases.items()):
            print(f"#   {name:<11s} roofline {w.roofline_ns/1e3:8.2f} us, "
                  f"measured {w.measured_wall_ns/1e3:8.2f} us -> calibrated "
                  f"{w.calibrated_ns/1e3:8.2f} us x {w.layers} layers "
                  f"({'+'.join(w.kernels)})")
    elif args.profile is not None:
        profile = ComputeProfile.load(args.profile)

    trace = derive_workload(
        args.arch, args.shape, pod=pod_spec,
        n_gpus=args.gpus, n_steps=args.steps, compute_profile=profile,
        policy=args.policy)
    cfg = SimConfig(fabric=pod_fabric(trace.pod), engine=args.engine)
    if args.retention_ns is not None:
        cfg = cfg.replace(tlb_retention_ns=args.retention_ns)

    pod = trace.pod
    print(f"# {trace.arch} / {trace.shape} on {pod.n_gpus} GPUs "
          f"(topology={pod.topology}, ep={pod.ep} tp={pod.tp} dp={pod.dp}), "
          f"{trace.tokens_per_step} tokens/step"
          + (f", {trace.n_microbatches} microbatches/pass"
             if trace.n_microbatches > 1 else ""))
    mix = Counter()
    for c in trace.step_calls(0):
        mix[(c.collective, c.group, c.nbytes)] += 1
    print(f"# per-step collective mix (policy={args.policy}):")
    for (coll, group, nbytes), k in sorted(mix.items()):
        print(f"#   {k:4d} x {coll:<14s} {nbytes/2**20:9.2f} MB "
              f"over {group} GPUs")
    if args.policy != "fixed":
        prov = Counter((c.logical, c.collective, c.resolved_by)
                       for c in trace.calls)
        print("# policy resolutions (logical -> concrete, provenance):")
        for (logical, coll, by), k in sorted(prov.items()):
            print(f"#   {k:4d} x {logical:<14s} -> {coll:<18s} [{by}]")
    if args.disagg > 0:
        from ..configs import get_config
        from .derive import derive_kv_transfer, kv_transfer_fabric
        mcfg = get_config(args.arch) if isinstance(args.arch, str) else args.arch
        call = derive_kv_transfer(mcfg, args.disagg, pod, policy=args.policy)
        kv_fab = kv_transfer_fabric(pod)
        print(f"# disaggregation KV handoff ({args.disagg}-token prompt, "
              f"DESIGN.md §16):")
        print(f"#   {mcfg.kv_bytes_per_token(pod.dtype_bytes)} B/token x "
              f"{args.disagg} tokens / {pod.n_gpus} GPUs = "
              f"{call.nbytes/2**20:.2f} MB per-GPU shard")
        print(f"#   {call.logical} -> {call.collective} [{call.resolved_by}] "
              f"over {kv_fab.n_gpus} GPUs ({kv_fab.topology}, "
              f"pod_size={kv_fab.pod_size})")

    rep = replay(trace, cfg=cfg)
    print("step,comm_us,ideal_us,degradation,walks,requests")
    for s in rep.steps:
        print(f"{s.step},{s.comm_ns/1e3:.2f},{s.ideal_comm_ns/1e3:.2f},"
              f"{s.degradation:.4f},{s.walks},{s.requests}")
    print(f"# cold (step 0) degradation:   {rep.cold_degradation:.4f}")
    print(f"# steady-state degradation:    {rep.steady_degradation:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
