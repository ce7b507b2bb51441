"""CLI: simulate request-level serving traffic on a RAT-simulated pod.

    PYTHONPATH=src python -m repro_torch.serving \
        --arch granite-moe-1b-a400m --rps 8 --steps-cap 200

Runs fully offline (no torch, no jax): the architecture registry resolves
through the torch-free :mod:`repro_torch.models.spec`, and the simulator is
numpy-only.  Prints
the per-step trace (optional), then p50/p95/p99 time-to-first-token and
inter-token latency with the cold-vs-warm Link-TLB communication split.

``--arrival bursty`` generates on/off bursts; together with
``--retention-ns`` the idle gaps between bursts flush the warmed
translations and each burst's leading requests re-pay the cold walks — the
tail-latency regime fig15 sweeps.

``--fleet N`` serves the same stream across N pod replicas behind a router
(``--router``), a bounded admission queue (``--max-queue``) and, with
``--autoscale``, a queue-depth autoscaler whose spin-ups start with
stone-cold TLBs — the fleet-scale regime fig16 sweeps (DESIGN.md §13).

``--disagg P:D`` switches to prefill/decode disaggregation: P prefill pods
and D decode pods, every request's KV cache crossing the pod boundary as an
explicit ``kv_transfer`` collective whose latency lands on TTFT — the
regime fig18 sweeps (DESIGN.md §16).  Mutually exclusive with ``--fleet``.
"""
from __future__ import annotations

import argparse
import sys

from ..core.topology import TOPOLOGIES
from .disagg import DisaggPoint, _disagg_point
from .fleet import ROUTERS, FleetPoint, _fleet_point
from .simulate import TrafficPoint, _traffic_point


def _parse_disagg(spec: str) -> tuple:
    """Parse the ``--disagg P:D`` pod split, e.g. ``1:2``."""
    try:
        p, _, d = spec.partition(":")
        pods = (int(p), int(d))
    except ValueError:
        pods = (0, 0)
    if pods[0] < 1 or pods[1] < 1:
        raise argparse.ArgumentTypeError(
            f"--disagg wants P:D with P,D >= 1 (e.g. 1:2), got {spec!r}")
    return pods


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.serving",
        description="Request-level serving traffic over persistent-TLB "
                    "workload replay (runs offline, no torch).")
    p.add_argument("--arch", required=True,
                   help="architecture registry name, e.g. "
                        "granite-moe-1b-a400m")
    p.add_argument("--rps", type=float, default=8.0,
                   help="mean arrival rate, requests per simulated second")
    p.add_argument("--arrival", default="poisson",
                   choices=("poisson", "bursty", "trace"),
                   help="arrival process (bursty: on/off modulated Poisson)")
    p.add_argument("--trace", default=None, metavar="FILE",
                   help="arrival trace file for --arrival trace "
                        "(arrival_ns,prompt_tokens,output_tokens lines)")
    p.add_argument("--requests", type=int, default=64,
                   help="number of requests to generate")
    p.add_argument("--seed", type=int, default=0,
                   help="arrival-stream seed (bit-for-bit reproducible)")
    p.add_argument("--gpus", type=int, default=16, help="pod size")
    p.add_argument("--topology", default="single_clos",
                   choices=sorted(TOPOLOGIES), help="pod topology")
    p.add_argument("--leaf", type=int, default=0,
                   help="two_tier: GPUs per leaf switch (0: fabric default)")
    p.add_argument("--oversub", type=float, default=1.0,
                   help="two_tier: leaf->spine oversubscription factor")
    p.add_argument("--pod-size", type=int, default=0,
                   help="multi_pod: GPUs per pod (0: whole fabric)")
    p.add_argument("--steps-cap", type=int, default=None,
                   help="stop after this many engine steps")
    p.add_argument("--retention-ns", type=float, default=None,
                   help="flush TLBs when an idle gap exceeds this "
                        "(default: entries survive gaps)")
    p.add_argument("--l2-entries", type=int, default=0,
                   help="override L2 Link-TLB entries (0: Table-1 default)")
    p.add_argument("--burst-size", type=int, default=8,
                   help="bursty: requests per burst")
    p.add_argument("--burstiness", type=float, default=16.0,
                   help="bursty: intra-burst rate multiplier")
    p.add_argument("--prompt-mean", type=int, default=256,
                   help="mean sampled prompt length (tokens)")
    p.add_argument("--output-mean", type=int, default=32,
                   help="mean sampled output length (tokens)")
    p.add_argument("--slots", type=int, default=32,
                   help="continuous-batching decode slots")
    p.add_argument("--prefill-chunk", type=int, default=512,
                   help="max prefill tokens admitted per step")
    p.add_argument("--pretranslate", action="store_true",
                   help="enable paper-§6.1 fused pre-translation probes")
    p.add_argument("--prefetch", action="store_true",
                   help="enable paper-§6.2 software TLB prefetch")
    p.add_argument("--engine", default="event",
                   choices=("event", "vectorized"),
                   help="simulation engine (identical results; vectorized "
                        "is ~10x faster at pod scale)")
    p.add_argument("--profile", default=None, metavar="FILE",
                   help="saved ComputeProfile JSON: calibrated compute "
                        "windows replace the rooflines (loaded torch-free)")
    p.add_argument("--policy", default="fixed", metavar="SPEC",
                   help="collective algorithm selection: fixed | auto | "
                        "table:<path> (repro_torch.core.select; fixed keeps the "
                        "historical choices bit-for-bit)")
    p.add_argument("--per-step", action="store_true",
                   help="print the per-step trace CSV")
    fl = p.add_argument_group(
        "fleet", "serve the stream across N pod replicas (DESIGN.md §13)")
    fl.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="fleet mode: number of pod replicas (with "
                         "--autoscale, the default max)")
    fl.add_argument("--router", default="round_robin",
                    choices=ROUTERS, help="request routing policy")
    fl.add_argument("--max-queue", type=int, default=None,
                    help="bounded admission: reject arrivals beyond this "
                         "fleet-wide prefill backlog")
    fl.add_argument("--autoscale", action="store_true",
                    help="start at --min-replicas and grow on queue "
                         "pressure; spin-ups start with stone-cold TLBs")
    fl.add_argument("--min-replicas", type=int, default=1,
                    help="autoscale floor (never retired below this)")
    fl.add_argument("--max-replicas", type=int, default=0,
                    help="autoscale ceiling on live replicas (0: --fleet)")
    fl.add_argument("--scale-up-queued", type=int, default=4,
                    help="spin up a replica when the admission queue "
                         "exceeds this depth")
    fl.add_argument("--scale-down-idle-ns", type=float, default=None,
                    help="retire a replica idle longer than this "
                         "(default: never retire)")
    fl.add_argument("--spinup-latency-ns", type=float, default=0.0,
                    help="delay between the scaling decision and the "
                         "replica becoming routable")
    dg = p.add_argument_group(
        "disaggregation",
        "dedicated prefill/decode pods with KV-cache transfer "
        "(DESIGN.md §16)")
    dg.add_argument("--disagg", type=_parse_disagg, default=None,
                    metavar="P:D",
                    help="disaggregated mode: P prefill pods and D decode "
                         "pods (routed by --router); incompatible with "
                         "--fleet")
    dg.add_argument("--kv-arena-mb", type=int, default=128,
                    help="decode-pod KV arena ring size (MB): the "
                         "transfer's steady-state Link-TLB working set")
    args = p.parse_args(argv)
    if args.disagg is not None and args.fleet > 0:
        p.error("--disagg and --fleet are mutually exclusive (a "
                "disaggregated deployment is its own replica set)")

    pt = TrafficPoint(
        arch=args.arch, rps=args.rps, arrival=args.arrival,
        n_requests=args.requests, seed=args.seed, n_gpus=args.gpus,
        topology=args.topology, leaf_size=args.leaf,
        oversubscription=args.oversub, pod_size=args.pod_size,
        l2_entries=args.l2_entries, retention_ns=args.retention_ns,
        steps_cap=args.steps_cap, burst_size=args.burst_size,
        burstiness=args.burstiness, prompt_mean=args.prompt_mean,
        output_mean=args.output_mean, max_decode_slots=args.slots,
        prefill_chunk_tokens=args.prefill_chunk,
        pretranslation=args.pretranslate, prefetch=args.prefetch,
        trace_path=args.trace, engine=args.engine,
        profile_path=args.profile, policy=args.policy)
    if args.disagg is not None:
        dp = DisaggPoint(traffic=pt, prefill_pods=args.disagg[0],
                         decode_pods=args.disagg[1], router=args.router,
                         kv_arena_bytes=args.kv_arena_mb * 2**20)
        res = _disagg_point((dp,))
    elif args.fleet > 0:
        fp = FleetPoint(
            traffic=pt, replicas=args.fleet, router=args.router,
            max_queue=args.max_queue, autoscale=args.autoscale,
            min_replicas=args.min_replicas, max_replicas=args.max_replicas,
            scale_up_queued=args.scale_up_queued,
            scale_down_idle_ns=args.scale_down_idle_ns,
            spinup_latency_ns=args.spinup_latency_ns)
        res = _fleet_point((fp,))
    else:
        res = _traffic_point((pt,))

    pod = res.pod
    print(f"# {res.arch} serving on {pod.n_gpus} GPUs "
          f"(topology={pod.topology}, ep={pod.ep} tp={pod.tp} dp={pod.dp}), "
          f"{args.arrival} arrivals at {args.rps} rps, seed {args.seed}")
    if args.fleet > 0:
        mode = (f"autoscale {args.min_replicas}.."
                f"{args.max_replicas or args.fleet}" if args.autoscale
                else f"static {args.fleet}")
        print(f"# fleet: {mode} replicas, router={args.router}, "
              f"{res.spin_ups} spin-ups, {res.retired} retired, "
              f"{len(res.rejected)} rejected")
        print("replica,spun_up_us,retired_us,routed,steps,walks,"
              "cold_comm_us,warm_comm_us")
        for row in res.replica_rows():
            ret = ("" if row["retired_ns"] is None
                   else f"{row['retired_ns']/1e3:.2f}")
            print(f"{row['idx']},{row['spun_up_ns']/1e3:.2f},{ret},"
                  f"{row['routed']},{row['steps']},{row['walks']},"
                  f"{row['cold_comm_ns']/1e3:.2f},"
                  f"{row['warm_comm_ns']/1e3:.2f}")
    if args.disagg is not None:
        pp, dd = args.disagg
        print(f"# disagg: {pp} prefill + {dd} decode pods, "
              f"router={args.router}, {len(res.handoffs)} KV handoffs "
              f"({res.kv_cold_handoffs} cold, {res.kv_walks} walks, "
              f"{res.kv_fastpath_calls} fastpath)")
        print("pod,role,routed,steps,walks,cold_comm_us,warm_comm_us")
        for row in res.replica_rows():
            print(f"{row['idx']},{row['role']},{row['routed']},"
                  f"{row['steps']},{row['walks']},"
                  f"{row['cold_comm_ns']/1e3:.2f},"
                  f"{row['warm_comm_ns']/1e3:.2f}")
        bd = res.ttft_breakdown()
        if bd:
            print(f"# TTFT decomposition (mean over {bd['n']:.0f} "
                  f"handed-off requests, us): "
                  f"prefill {bd['prefill_ns']/1e3:.2f} + "
                  f"kv_wait {bd['kv_wait_ns']/1e3:.2f} + "
                  f"kv_transfer {bd['kv_transfer_ns']/1e3:.2f} "
                  f"(RAT excess {bd['kv_excess_ns']/1e3:.2f}) + "
                  f"decode_wait {bd['decode_wait_ns']/1e3:.2f} = "
                  f"ttft {bd['ttft_ns']/1e3:.2f}")
    served = res.first_token_served
    print(f"# steps: {len(res.steps)}"
          + (" (capped)" if res.steps_capped else "")
          + f", requests: {len(res.requests)} generated, "
          f"{len(served)} served first token, {len(res.finished)} finished")
    if args.per_step:
        print("step,t_start_us,decode_tok,prefill_tok,comm_us,ideal_us,"
              "degradation,walks")
        for s in res.steps:
            print(f"{s.step},{s.t_start/1e3:.2f},{s.decode_tokens},"
                  f"{s.prefill_tokens},{s.comm_ns/1e3:.2f},"
                  f"{s.ideal_comm_ns/1e3:.2f},{s.degradation:.4f},{s.walks}")
    if not served:
        print("# no requests served (raise --steps-cap or --rps)",
              file=sys.stderr)
        return 1
    ttft = res.ttft_percentiles()
    itl = res.itl_percentiles()
    print("metric,p50_us,p95_us,p99_us")
    print(f"ttft,{ttft[50.0]/1e3:.2f},{ttft[95.0]/1e3:.2f},"
          f"{ttft[99.0]/1e3:.2f}")
    print(f"inter_token,{itl[50.0]/1e3:.2f},{itl[95.0]/1e3:.2f},"
          f"{itl[99.0]/1e3:.2f}")
    cold, warm = res.cold_comm_ns, res.warm_comm_ns
    tot = cold + warm
    print(f"# cold-vs-warm comm split: cold {cold/1e3:.2f} us "
          f"({(cold/tot if tot else 0.0)*100:.1f}%) over {res.cold_steps} "
          f"walking steps, warm {warm/1e3:.2f} us")
    print(f"# TTFT degradation vs zero-RAT ideal: "
          f"mean {res.mean_ttft_degradation:.4f}, "
          f"p99 {res.p99_ttft_degradation:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
