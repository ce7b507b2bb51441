"""Quickstart on the port (``examples/quickstart.py`` on ``repro_torch``):
reproduce the paper's headline result in ~5 seconds, with host code in
numpy that loads no torch and prints the reference example's lines.

Simulates Reverse Address Translation overheads for all-pairs AllToAll on a
UALink pod, prints the Fig-4 degradation sweep, and shows the paper's two
proposed optimizations (fused pre-translation, software TLB prefetch)
recovering the loss.

    python examples/quickstart_torch.py
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import ratsim, paper_config, simulate, MB, GB
from repro_torch.core.config import PreTranslationConfig, FabricConfig, PrefetchConfig


def main():
    cfg0 = paper_config(16)
    print("=== Reverse Address Translation overhead vs zero-RAT ideal ===")
    print(f"    (collective={cfg0.collective}, "
          f"topology={cfg0.fabric.topology})")
    print(f"{'pod':>6} " + " ".join(f"{s//MB:>7}MB" for s in
                                    (1*MB, 4*MB, 16*MB, 64*MB, 256*MB, 1*GB)))
    for n in (8, 16, 32, 64):
        degs = [ratsim.compare(s, n).degradation
                for s in (1*MB, 4*MB, 16*MB, 64*MB, 256*MB, 1*GB)]
        print(f"{n:>4}gpu " + " ".join(f"{d:8.3f}" for d in degs))
    print("\npaper: up to 1.4x at 1MB, ~1.1x at 16MB, amortized for large\n")

    print("=== beyond the paper: hierarchical pods (fig14) ===")
    for topo in ("single_clos", "two_tier"):
        cfg = paper_config(64).replace(fabric=FabricConfig(
            n_gpus=64, topology=topo, leaf_size=16, oversubscription=2.0))
        c = ratsim.compare(1 * MB, 64, cfg=cfg)
        print(f"  64gpu 1MB on {topo:<12s}: degradation "
              f"{c.degradation:.3f}x "
              f"(completion {c.baseline.completion_ns/1e3:.2f} us)")
    print()

    print("=== paper 6.1: fused pre-translation (warm TLBs during compute) ===")
    for s in (1*MB, 16*MB):
        base = ratsim.compare(s, 16)
        cfg = paper_config(16).replace(pretranslation=PreTranslationConfig(
            enabled=True, lead_time_ns=3000.0, pages_per_flow=0))
        opt = simulate(s, cfg)
        print(f"  {s//MB:>3}MB: baseline {base.degradation:.3f}x -> "
              f"pre-translated {opt.completion_ns/base.ideal.completion_ns:.3f}x")

    print("\n=== paper 6.2: software TLB prefetch (scarce ingress buffering) ===")
    fab = FabricConfig(n_gpus=16, ingress_entries=64)
    cfg = paper_config(16).replace(fabric=fab)
    for s in (16*MB, 64*MB):
        base = simulate(s, cfg)
        opt = simulate(s, cfg.replace(prefetch=PrefetchConfig(enabled=True, depth=2)))
        print(f"  {s//MB:>3}MB: prefetch speedup "
              f"{base.completion_ns/opt.completion_ns:.3f}x")

    print("\n=== translation-aware collective planning (framework integration) ===")
    from repro_torch.core.scheduler import TranslationAwareScheduler
    sch = TranslationAwareScheduler(n_gpus=16, overlap_compute_ns=5e3)
    plan = sch.plan_all_to_all(8 * MB)
    print(f"  8MB MoE all-to-all: warm-up chunk {plan.warmup_chunk_bytes//MB}MB, "
          f"{plan.n_chunks} pipeline chunks, est. speedup {plan.est_speedup:.3f}x,"
          f" per-peer buffer {plan.per_peer_buffer_bytes//MB}MB "
          "(Fig 11: one page/peer)")


if __name__ == "__main__":
    main()
