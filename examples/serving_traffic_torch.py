"""Serving traffic on the port (``examples/serving_traffic.py`` on
``repro_torch``): what Link-TLB cold misses do to request tail latency,
with host code in numpy that loads no torch and prints the reference
example's lines.

Workload replay (examples/workload_replay_torch.py) prices fixed step
loops; real inference serving is a *stream of requests* — bursty arrivals, continuous
batching, and idle gaps between bursts during which competing traffic
evicts the warmed translations.  This example (repro_torch.serving, DESIGN.md
§11, torch-free) runs the same bursty request stream twice:

  1. with TLB retention disabled — every burst after the first rides the
     entries the previous one warmed;
  2. with a 50 us retention window — each inter-burst gap flushes the
     TLBs, every burst's leading steps re-pay the cold walks, and the
     degradation concentrates in the p99 time-to-first-token tail
     (fig15's regime).

    python examples/serving_traffic_torch.py
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.serving import TrafficPoint
from repro_torch.serving.simulate import _traffic_point


def show(tag, res):
    ttft = res.ttft_percentiles()
    itl = res.itl_percentiles()
    cold, warm = res.cold_comm_ns, res.warm_comm_ns
    print(f"  {tag}")
    print(f"    TTFT p50/p95/p99: {ttft[50.0]/1e3:8.2f} /"
          f" {ttft[95.0]/1e3:8.2f} / {ttft[99.0]/1e3:8.2f} us;"
          f"  inter-token p50: {itl[50.0]/1e3:6.2f} us")
    print(f"    TTFT degradation mean {res.mean_ttft_degradation:.4f}, "
          f"p99 {res.p99_ttft_degradation:.4f};  "
          f"{res.cold_steps} cold steps, "
          f"cold comm {cold/1e3:.0f} us vs warm {warm/1e3:.0f} us")


def main():
    pt = TrafficPoint(arch="granite-moe-1b-a400m", rps=16.0,
                      arrival="bursty", n_requests=12, seed=7,
                      burst_size=4, burstiness=24.0,
                      prompt_mean=128, output_mean=8, steps_cap=60)
    print(f"=== {pt.arch}: bursty serving on {pt.n_gpus} GPUs "
          f"(topology={pt.topology}, collective mix from the live batch) ===")
    show("no retention (gaps keep warmth):", _traffic_point((pt,)))
    import dataclasses
    aged = dataclasses.replace(pt, retention_ns=50_000.0)
    show("tlb_retention_ns=50us (gaps flush):", _traffic_point((aged,)))
    print("  -> with retention, the idle gaps between bursts re-pay the "
          "cold walks\n     and degradation concentrates in the TTFT tail "
          "(p99 >> mean).")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
