"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is the result's JSON object; the
last lines of standard error are the numbers that decided ``correct``,
each beside its limit.  Exit codes: 0 a result, 2 bad arguments, 3 no
card (or too few), 4 the program's registry differs from the cell's
configuration file, 5 JAX or the JAX package got loaded, 1 anything else.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()     # set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from portbench import bench
    try:
        result = bench.run(args.workload, args.seed, args.seconds,
                           bool(args.trace), t0=T0)
    except bench.Failure as e:
        print(f"portbench: {e}", file=sys.stderr)
        return e.code
    sys.stderr.flush()
    print(bench.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
