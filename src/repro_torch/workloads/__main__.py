"""CLI: measure the compute windows of one (arch, shape, pod) on the card.

    PYTHONPATH=src python -m repro_torch.workloads \
        --arch granite-moe-1b-a400m --shape decode_32k --gpus 16

times the port's kernels on the H100 (``--device cpu`` runs their plain
versions, for tests), writes the profile JSON (default under
``calibration/``), prints the per-phase windows and, as its last line,
the jax-free command that replays the profile through the simulator.
"""
from __future__ import annotations

import argparse
import shlex

from .calibrate import calibrate, default_cache_path
from .derive import TOPOLOGIES, PodSpec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.workloads",
        description="Measure per-phase compute windows on the port's "
                    "kernels and write a ComputeProfile JSON.")
    p.add_argument("--arch", required=True,
                   help="architecture registry name, e.g. qwen3-moe-235b-a22b")
    p.add_argument("--shape", default="decode_32k",
                   help="input shape: decode_32k | prefill_32k | train_4k")
    p.add_argument("--gpus", type=int, default=16, help="pod size")
    p.add_argument("--topology", default="single_clos",
                   choices=sorted(TOPOLOGIES), help="pod topology")
    p.add_argument("--leaf", type=int, default=0,
                   help="two_tier: GPUs per leaf switch (0: fabric default)")
    p.add_argument("--oversub", type=float, default=1.0,
                   help="two_tier: leaf->spine oversubscription factor")
    p.add_argument("--pod-size", type=int, default=0,
                   help="multi_pod: GPUs per pod (0: whole fabric)")
    p.add_argument("--profile", default=None, metavar="JSON",
                   help="where to write the profile (default: "
                        "calibration/<arch>_<shape>_g<gpus>.json)")
    p.add_argument("--force-calibrate", action="store_true",
                   help="re-measure even when a matching profile exists")
    p.add_argument("--reps", type=int, default=3,
                   help="timed calls per kernel (best is kept)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (plain versions, tests only)")
    args = p.parse_args(argv)

    path = args.profile or default_cache_path(args.arch, args.shape,
                                              args.gpus)
    pod = PodSpec(topology=args.topology, leaf_size=args.leaf,
                  oversubscription=args.oversub, pod_size=args.pod_size)
    prof = calibrate(args.arch, args.shape, pod=pod, n_gpus=args.gpus,
                     reps=args.reps, cache_path=path,
                     force=args.force_calibrate, device=args.device)
    print(f"# compute profile ({path}): {prof.arch} / {prof.shape} on "
          f"{prof.n_gpus} GPUs (ep={prof.ep} tp={prof.tp} dp={prof.dp}), "
          f"interpret={prof.interpret}")
    for name, w in sorted(prof.phases.items()):
        print(f"#   {name:<11s} roofline {w.roofline_ns/1e3:8.2f} us, "
              f"measured {w.measured_wall_ns/1e3:8.2f} us -> calibrated "
              f"{w.calibrated_ns/1e3:8.2f} us x {w.layers} layers "
              f"({'+'.join(w.kernels)})")
    cmd = ["python", "-m", "repro.workloads", "--arch", prof.arch,
           "--shape", prof.shape, "--gpus", str(prof.n_gpus)]
    if args.topology != "single_clos":
        cmd += ["--topology", args.topology, "--leaf", str(args.leaf),
                "--oversub", str(args.oversub), "--pod-size",
                str(args.pod_size)]
    print(shlex.join(cmd + ["--profile", str(path)]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
