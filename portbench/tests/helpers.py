"""Small sizes at which the benchmark's pieces run on the CPU in tests."""
from __future__ import annotations

import dataclasses
import io
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = {"granite-moe-1b-a400m.prefill": "granite-moe-1b-a400m",
         "mamba2-780m.prefill": "mamba2-780m"}
SMALL_TRAFFIC = {"batch": 4, "prompt_len": 64, "decode_budget": 8}
SEED = 2 ** 31 + 11


def small(cell: str, root=ROOT, **over):
    """(the program's config, its sizes as a dict) at test size: the
    registry's smoke config of the cell's model, with ``over``."""
    from portbench import manifest
    from repro_torch import configs
    name = manifest.cell(cell, root).config["port_config"]
    cfg = configs.get_smoke_config(name).replace(**over)
    return cfg, {f.name: getattr(cfg, f.name)
                 for f in dataclasses.fields(cfg)}


def run_small(cell: str, seed: int = SEED, seconds: float = 0.3,
              traced: bool = False, root=ROOT, cfg_over=None, **kw):
    """One run of ``cell`` on the CPU at test size."""
    from portbench import bench
    cfg, model = small(cell, root, **(cfg_over or {}))
    kw.setdefault("traffic_over", SMALL_TRAFFIC)
    return bench.run(cell, seed, seconds, traced, t0=time.perf_counter(),
                     device="cpu", root=root, port_cfg=cfg, model=model,
                     err=io.StringIO(), **kw)
