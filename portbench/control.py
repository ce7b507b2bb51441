"""The readings that a cell's correctness limits are set from.

    python3 -m portbench.control --workload <cell> --seeds 1-12 \\
        --control-seeds 101-103 [--out chiprun_out/readings.json]

For each of ``--seeds`` it serves the cell's calls through the program at
the cell's own sizes, keeps what a run keeps of as many calls as a run
judges (``check.CALLS``), and judges them as a run does: the program's
readings (the lower ends).  For each of ``--control-seeds`` the reference
in float8 takes the program's place on the same sample (the control: the
upper ends).  No window is timed.  One process reads every seed, so the
kernels and the card start once.  ``--out`` keeps each request's
readings beside the numbers (``check.judge``'s ``detail``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def seeds(spec: str):
    out = []
    for part in spec.split(","):
        a, _, b = part.partition("-")
        out.extend(range(int(a), int(b) + 1) if b else [int(a)])
    return out


def readings(cell_name: str, seed: int, stand_in=None, device="cuda",
             port_cfg=None, model=None, traffic_over=None, calls=None):
    """The numbers of one seed: the program's, or with ``stand_in`` the
    reference at that precision in its place.  ``calls``: fewer calls
    than a run judges (the tests')."""
    import torch
    from portbench import bench, check, manifest, weights
    from portbench.reference import plain
    from repro_torch.models.spec import torch_dtype
    cell = manifest.cell(cell_name)
    if port_cfg is None:
        from repro_torch import configs
        port_cfg = configs.get_config(cell.config["port_config"])
        bench.check_config(cell, port_cfg)
        model = cell.config["model"]
    fam = manifest.reference(cell.config["reference"])
    n = int(calls or check.CALLS)
    dev = torch.device(device)
    flat = weights.draw(fam.leaves(model), seed, torch_dtype(port_cfg.dtype),
                        dev)
    mix = {**cell.traffic, **(traffic_over or {})}
    traffic = manifest.generator(mix).Traffic(mix, seed, model["vocab_size"],
                                              dev)
    served = []
    if stand_in is None:
        program = bench.Program(port_cfg, weights.tree(flat))
        for i in range(n):
            logits, tokens, caches = traffic.serve(program, i)
            served += bench.keep(i, logits, tokens, caches, seed)
            del logits, caches
        del program
    else:
        for i in range(n):
            rows = check.kept_rows(i, traffic.batch, seed)
            served += [check.Served(i, r, None, -1, {} if j == 0 and
                                    i % check.CACHE_EVERY == 0 else None)
                       for j, r in enumerate(rows)]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    plain.set_exact_matmul()
    return check.judge(served, fam, model, flat, traffic,
                       per_request=cell.limits.get("per_request"),
                       stand_in=stand_in)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="101-103")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = []
    for kind, spec, stand_in in (("program", args.seeds, None),
                                 ("control", args.control_seeds, "fp8")):
        for seed in seeds(spec):
            t = time.perf_counter()
            nums = readings(args.workload, seed, stand_in)
            detail = nums.pop("detail")
            rows.append({"kind": kind, "seed": seed, **nums,
                         "seconds": time.perf_counter() - t})
            print(json.dumps(rows[-1]), flush=True)
            rows[-1]["detail"] = detail
    for kind in ("program", "control"):
        sel = [r for r in rows if r["kind"] == kind]
        if sel:
            pick = max if kind == "program" else min
            agg = {k: pick(r[k] for r in sel) for k in sel[0]
                   if k not in ("kind", "seed", "seconds", "detail")}
            print(f"{kind}, {pick.__name__} over {len(sel)} seeds: "
                  f"{json.dumps(agg)}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
