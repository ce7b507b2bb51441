"""Workload replay on the port (``examples/workload_replay.py`` on
``repro_torch``): warm-vs-cold Link-TLB trajectories of real model steps,
with host code in numpy that loads no torch and prints the reference
example's lines.

The paper prices free-standing collectives from cold TLBs; real serving
fires *sequences* — one MoE dispatch/combine all-to-all per layer per
decoded token.  This example replays model-derived sequences through
persistent-TLB sessions (repro_torch.core.session + repro_torch.workloads) and prints:

  1. the session API itself: cold vs warm vs idle-aged reruns;
  2. a granite-MoE decode loop (token 0 pays the cold walks, later tokens
     ride warm TLBs);
  3. the TLB-reach contrast: qwen3-moe's per-layer buffers overflow the L2
     Link TLB, so even steady-state tokens keep walking.

    python examples/workload_replay_torch.py
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import ratsim, paper_config, MB


def main():
    print("=== SimSession: translation state persists across collectives ===")
    s = ratsim.session(16)
    print(f"    (collective={s.cfg.collective}, "
          f"topology={s.cfg.fabric.topology}, {s.cfg.fabric.n_gpus} GPUs)")
    cold = s.run(1 * MB)
    warm = s.run(1 * MB)
    moved = s.run(1 * MB, base_offset=64 * MB)     # fresh buffer: cold again
    print(f"  cold  run: {cold.completion_ns/1e3:8.2f} us "
          f"({cold.counters.walks} page walks)")
    print(f"  warm  run: {warm.completion_ns/1e3:8.2f} us "
          f"({warm.counters.walks} page walks)")
    print(f"  new buffer: {moved.completion_ns/1e3:7.2f} us "
          f"({moved.counters.walks} page walks — TLB cold, PWC still warm)")

    aged = ratsim.session(16, cfg=paper_config(16).replace(
        tlb_retention_ns=1e6))
    aged.run(1 * MB)
    r = aged.run(1 * MB, gap_ns=5e6)               # long idle: flushed
    print(f"  after 5ms idle (1ms retention): {r.completion_ns/1e3:.2f} us "
          f"({r.counters.walks} page walks — aged out)\n")

    from repro_torch.workloads import derive_workload, replay

    print("=== granite-moe decode: per-token degradation trajectory ===")
    trace = derive_workload("granite-moe-1b-a400m", "decode_32k",
                            n_gpus=16, n_steps=4)
    colls = ", ".join(sorted({c.collective for c in trace.calls}))
    print(f"    (topology={trace.pod.topology}, collectives: {colls})")
    rep = replay(trace)
    for st in rep.steps:
        print(f"  token {st.step}: comm {st.comm_ns/1e3:8.2f} us, "
              f"degradation {st.degradation:.4f}, walks {st.walks}")
    print(f"  cold {rep.cold_degradation:.4f} vs steady "
          f"{rep.steady_degradation:.4f} — warm TLBs erase the cold tax\n")

    print("=== qwen3-moe-235b: working set exceeds L2 Link-TLB reach ===")
    trace = derive_workload("qwen3-moe-235b-a22b", "decode_32k",
                            n_gpus=16, n_steps=2)
    colls = ", ".join(sorted({c.collective for c in trace.calls}))
    print(f"    (topology={trace.pod.topology}, collectives: {colls})")
    rep = replay(trace)
    for st in rep.steps:
        print(f"  token {st.step}: degradation {st.degradation:.4f}, "
              f"walks {st.walks}")
    print("  steady-state walks stay high: capacity misses, not cold misses\n")

    from repro_torch.workloads import PodSpec

    print("=== two-tier pod: TP stays intra-leaf, the EP a2a crosses the "
          "spine ===")
    trace = derive_workload(
        "granite-moe-1b-a400m", "decode_32k",
        pod=PodSpec(topology="two_tier", leaf_size=4, oversubscription=2.0),
        n_gpus=16, n_steps=2)
    pod = trace.pod
    print(f"    (topology={pod.topology}, ep={pod.ep} tp={pod.tp} "
          f"dp={pod.dp})")
    rep = replay(trace)
    for st in rep.steps:
        print(f"  token {st.step}: degradation {st.degradation:.4f}, "
              f"walks {st.walks}")


if __name__ == "__main__":
    main()
