"""The paper's collective inside a real MoE block, on ``repro_torch``:
expert-parallel all-to-all dispatch under a warm-up plan
(``examples/moe_scheduled_a2a.py`` on the port).

Runs ``moe_block_ep`` on granite's smoke config (8 experts, top-2) over an
expert-parallel group, once with one all-to-all and once under a
``CollectivePlan`` with a compute to hide the warm-up behind, and checks
that both give the same bits and that the compute gives what it gives
alone.  At world size 1 the all-to-all is a self-copy through NCCL (the
code path, not a fabric); under torchrun each rank holds ``8 / N``
experts.  It runs on the card; ``--device cpu`` uses gloo and the plain
versions of the kernels.

    PYTHONPATH=src python examples/moe_scheduled_a2a_torch.py
    PYTHONPATH=src torchrun --nproc-per-node 4 \\
        examples/moe_scheduled_a2a_torch.py --device cpu

``--plan PATH`` reads a ``CollectivePlan`` JSON, which the port's
scheduler writes (``repro_torch.core.TranslationAwareScheduler(8)
.plan_all_to_all(nbytes).to_json()``); without it the plan is a warm-up
of an eighth of the buffer and 2 chunks.
"""
import argparse
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import CollectivePlan  # noqa: E402
from repro_torch.launch.mesh import (init_ep_group,  # noqa: E402
                                     init_ep_group_from_env)
from repro_torch.models.moe import init_moe, moe_block_ep  # noqa: E402
from repro_torch.weights import ep_slice  # noqa: E402
from repro_torch.workloads.derive import moe_a2a_bytes  # noqa: E402

T = 64                  # tokens a rank, f32 (the reference example's)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--plan", default=None, help="CollectivePlan JSON")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: NCCL) or cpu (gloo)")
    args = ap.parse_args(argv)

    g = (init_ep_group_from_env(args.device) if "WORLD_SIZE" in os.environ
         else init_ep_group(args.device))
    with g:
        cfg = configs.get_smoke_config("granite-moe-1b-a400m")
        full = init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
        p = {k: v.to(g.device) for k, v in
             ep_slice(full, g.rank, g.size).items()}
        gen = torch.Generator().manual_seed(1 + g.rank)
        x = torch.randn(T, cfg.d_model, generator=gen).to(g.device)
        a = torch.randn(256, 256, generator=gen).to(g.device)

        nbytes = moe_a2a_bytes(cfg, T, g.size, x.element_size())
        if args.plan:
            plan = CollectivePlan.from_json(pathlib.Path(args.plan)
                                            .read_text())
        else:
            plan = CollectivePlan(
                total_bytes=nbytes, n_peers=g.size,
                warmup_chunk_bytes=nbytes // 8, n_chunks=2,
                per_peer_buffer_bytes=nbytes // g.size, est_time_ns=0.0,
                est_time_unscheduled_ns=0.0)
        if g.rank == 0:
            print(f"ep {g.size} ({g.backend} on {g.device}), a2a "
                  f"{nbytes} B a rank; plan: warm-up "
                  f"{plan.warmup_chunk_bytes} B, {plan.n_chunks} chunks, "
                  + (f"est speedup {plan.est_speedup:.3f}x"
                     if plan.est_time_ns else "no estimate"))

        got = []

        def compute(m):
            z = torch.tanh(m @ m)
            got.append(z)
            return z

        y0, aux = moe_block_ep(p, cfg, x, g.group)
        y1, _ = moe_block_ep(p, cfg, x, g.group, plan=plan,
                             overlap_compute=(compute, a))
        if not torch.equal(y0, y1):
            raise AssertionError("scheduled and unscheduled outputs differ")
        if not (len(got) == 1 and torch.equal(got[0], compute(a))):
            raise AssertionError("the overlap compute changed beside the "
                                 "all-to-all")
        if not bool(torch.isfinite(y0).all()):
            raise AssertionError("non-finite MoE output")
        print(f"rank {g.rank}: y {list(y0.shape)} finite, aux "
              f"{float(aux):.4f}; scheduled == unscheduled bit for bit; "
              f"overlap compute unchanged: OK")


if __name__ == "__main__":
    main()
