"""Multi-pod dry-run of the port (counterpart of ``repro.launch.dryrun``):
run every (architecture x shape x mesh) cell once, as one rank of the
production layout, on the meta device.

The reference lowers and compiles each cell's step for 512 placeholder
devices and reads its cost from the compiled HLO.  The port runs the step
itself: rank 0 of a fake world of 256 or 512 ranks
(``launch.mesh.init_fake_mesh``, torch's fake process group, whose
collectives move nothing) builds its sharded state on the meta device and
runs the sharded train step (forward, backward and update), the prefill
step or the serve step once under a ``launch.roofline.Counter``.  That
proves the cell is coherent (every spec divides, every shape meets) and
gives its per-device FLOPs, HBM bytes, collective bytes by kind and axis,
kernel launches and peak memory, against the H100's peaks and capacity.
Nothing is allocated on any device and nothing is computed: a tensor off
the meta device inside a step is an error.

An eager step runs every layer and every microbatch, so its counts follow
the loops by construction (the reference needs ``hlo_analysis`` for the
trip counts of its scans).  Where a step would read a value back to the
host, the dry-run takes the bound the reference's static shapes impose:
``models.moe.moe_gather`` keeps the capacity bound of rows, a grouped
matmul covers every row it is given.

Results go to ``build/dryrun/<arch>__<shape>__<single|multi>.json``
(``launch.report`` reads them).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k --mesh single          # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # all
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from .. import configs
from ..configs.shapes import SHAPES, ShapeSpec, shape_applicable
from ..models import api
from ..optim import adafactor, adamw, cosine_with_warmup, with_master
from ..parallel.fsdp import shard_tree
from . import roofline as rl
from . import specs as sp
from .steps import make_prefill_step, make_serve_step, make_train_step

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"

# Microbatching (grad accumulation) and optimizer choice per size class:
# >=100B-param models train with Adafactor + deeper accumulation.
BIG_ARCHS = {"mistral-large-123b", "qwen3-moe-235b-a22b",
             "jamba-1.5-large-398b"}
MESHES = {False: ("pod_16x16", (16, 16)),
          True: ("multipod_2x16x16", (2, 16, 16))}


def pick_optimizer(arch: str):
    sched = cosine_with_warmup(3e-4, 100, 10_000)
    inner = adafactor(sched) if arch in BIG_ARCHS else adamw(sched)
    return with_master(inner)   # bf16 params + f32 master (mixed precision)


MICROBATCHES = {  # per-arch grad-accumulation depth (train_4k)
    "mistral-large-123b": 16,
    "jamba-1.5-large-398b": 16,
    "qwen3-moe-235b-a22b": 16,
}


def microbatches_for(arch: str, shape_name: str) -> int:
    if shape_name != "train_4k":
        return 1
    return MICROBATCHES.get(arch, 4)


def rank_microbatches(arch: str, shape: ShapeSpec, mesh_sizes) -> int:
    """The microbatches a rank splits its rows into: ``microbatches_for``,
    cut to a divisor of the rank's rows.  The reference splits the global
    batch and lets GSPMD shard each microbatch unevenly; the port splits
    each rank's rows, so where the pods double the batch ranks (16 of 256
    rows for 32 ranks: 8 a rank) a microbatch takes one row, 8 of them."""
    n_batch = math.prod(n for a, n in mesh_sizes.items()
                        if a in ("pod", "data"))
    return math.gcd(microbatches_for(arch, shape.name),
                    max(1, shape.global_batch // n_batch))


SEQ_SHARD_OFF = set()  # archs where SP reshards cost more than they save


def seq_shard_for(cfg, shape) -> bool:
    # Sequence parallelism whenever seq divides the model axis; essential
    # when attention heads don't shard it (e.g. 12 or 40 heads on model=16).
    if cfg.name in SEQ_SHARD_OFF:
        return False
    return shape.kind in ("train", "prefill") and shape.seq_len % 16 == 0


def cell_config(arch: str, shape: ShapeSpec):
    """The cell's config: jamba's ``long_500k`` runs its attention layers
    with a window of 4096, as the reference's does."""
    cfg = configs.get_config(arch)
    if shape.name == "long_500k" and cfg.sliding_window == 0 and \
            any(k == "attn" for k in cfg.pattern):
        cfg = cfg.replace(sliding_window=4096)
    return cfg


@dataclass
class Cell:
    """One cell's step and this rank's arguments (params, optimizer state,
    batch or caches): ``run()`` is one step."""
    step: Callable
    args: tuple

    def run(self):
        return self.step(*self.args)


def _batch(cfg, shape: ShapeSpec, device, gen):
    """The global batch: meta tensors, or seeded tokens (and f32 frontend
    embeddings) on ``device``."""
    spec = sp.batch_specs(cfg, shape)
    if device.type == "meta":
        return spec
    out = {}
    for k, t in spec.items():
        if t.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, t.shape,
                                   generator=gen, device=device,
                                   dtype=torch.int32)
        else:
            out[k] = torch.randn(t.shape, generator=gen, device=device)
    return out


def build_cell(arch: str, shape: ShapeSpec, mesh, multi_pod: bool = False,
               device=None, seed: int = 0, cfg=None) -> Cell:
    """The cell's sharded step on ``mesh`` with this rank's arguments.

    ``device`` None (or meta): every tensor on the meta device, the
    dry-run's.  Otherwise seeded random params (``api.init``), their
    optimizer state and a random batch, made whole on ``device`` and cut
    to this rank's shards: the same step on real tensors.  ``cfg``
    replaces ``arch``'s config (a smoke config); the optimizer and the
    microbatches still follow ``arch``."""
    cfg = cfg or cell_config(arch, shape)
    dev = torch.device("meta" if device is None else device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    if shape.kind == "train":
        opt = pick_optimizer(arch)
        step, (p_specs, o_specs, b_specs), _, (params_s, opt_s) = \
            make_train_step(cfg, opt, mesh, multi_pod=multi_pod,
                            microbatches=rank_microbatches(arch, shape,
                                                           mesh.shape),
                            seq_shard=seq_shard_for(cfg, shape))
        if gen is not None:
            params_s = api.init(cfg.replace(param_dtype=cfg.dtype), gen, dev)
            opt_s = opt.init(params_s)
        params = shard_tree(params_s, p_specs, mesh)
        opt_state = shard_tree(opt_s, o_specs, mesh)
        del params_s, opt_s
        batch = shard_tree(_batch(cfg, shape, dev, gen), b_specs, mesh)
        return Cell(step, (params, opt_state, batch))
    if shape.kind == "prefill":
        step, (p_specs, b_specs), _, params_s = make_prefill_step(
            cfg, mesh, shape, multi_pod=multi_pod,
            seq_shard=seq_shard_for(cfg, shape))
        if gen is not None:
            params_s = api.cast_for_serving(cfg, api.init(cfg, gen, dev))
        params = shard_tree(params_s, p_specs, mesh)
        del params_s
        batch = _batch(cfg, shape, dev, gen)
        batch.pop("targets")
        batch = shard_tree(batch, {k: b_specs[k] for k in batch}, mesh)
        return Cell(step, (params, batch))
    step, (p_specs, t_spec, c_specs), _, (params_s, cache_s) = \
        make_serve_step(cfg, mesh, shape, multi_pod=multi_pod)
    if gen is not None:
        params_s = api.cast_for_serving(cfg, api.init(cfg, gen, dev))
        cache_s = sp.empty_caches(cfg, shape.global_batch,
                                  shape.seq_len + sp.DECODE_MARGIN, dev)
    params = shard_tree(params_s, p_specs, mesh)
    del params_s
    # the caches hold the prompt: decode writes at position seq_len
    caches = _filled(shard_tree(cache_s, c_specs, mesh), shape.seq_len)
    token = torch.zeros(shape.global_batch, dtype=torch.int32, device=dev)
    token = shard_tree(token, t_spec, mesh)
    return Cell(step, (params, token, caches))


def _filled(caches, length: int):
    """Caches whose KV length is ``length`` (an SSM cache has none)."""
    def fill(c):
        return c._replace(length=length) if hasattr(c, "length") else c
    if isinstance(caches, dict):
        return {k: fill(c) for k, c in caches.items()}
    if hasattr(caches, "self_kv"):
        return caches._replace(self_kv=fill(caches.self_kv))
    return caches


def model_flops(cfg, shape: ShapeSpec) -> float:
    """The step's useful FLOPs over all devices (6ND train, 2ND
    prefill, 2N a decoded token)."""
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind != "decode" else shape.global_batch)
    n_active = configs.active_param_count(cfg)
    if shape.kind == "train":
        return rl.model_flops_train(n_active, tokens)
    if shape.kind == "prefill":
        return rl.model_flops_train(n_active, tokens) / 3.0   # fwd only
    return rl.model_flops_decode(n_active, tokens)


def count_cell(cell: Cell, only_device: Optional[str] = None):
    """Run ``cell`` once under a counter; returns (counter, the step's
    output, seconds)."""
    t0 = time.time()
    with rl.Counter(only_device=only_device) as c:
        c.hold(cell.args)
        out = cell.run()
    return c, out, time.time() - t0


def cell_result(arch: str, shape: ShapeSpec, mesh_name: str, mesh_sizes,
                counter: rl.Counter, run_s: float, cfg=None) -> dict:
    """A cell's JSON: the reference's keys, ``run_s`` for its
    ``lower_s`` and ``compile_s``, and what was counted."""
    cfg = cfg or cell_config(arch, shape)
    terms = counter.terms()
    n_devices = math.prod(mesh_sizes.values())
    mf_per_dev = model_flops(cfg, shape) / n_devices
    mb = ({"microbatches": rank_microbatches(arch, shape, mesh_sizes),
           "microbatches_asked": microbatches_for(arch, shape.name)}
          if shape.kind == "train" else {})
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "status": "ok",
        "run_s": round(run_s, 1),
        "n_devices": n_devices,
        "memory": {"peak_bytes": counter.peak_bytes},
        "fits_hbm": counter.peak_bytes < rl.HBM_BYTES,
        "roofline": terms.as_dict(),
        "flops_by_dtype": terms.flops_by_dtype,
        "model_flops_per_device": mf_per_dev,
        "useful_flops_ratio": (mf_per_dev / terms.flops
                               if terms.flops else None),
        "counts": counter.as_dict(),
        **mb,
    }


def run_cell(arch: str, shape, multi_pod: bool = False,
             mesh_shape: Optional[Tuple[int, ...]] = None,
             verbose: bool = True, cfg=None) -> dict:
    """One cell on the meta device, as rank 0 of a fake world of
    ``mesh_shape`` (default: the production layout, 16 x 16 or 2 x 16 x
    16).  ``shape``: a name in ``SHAPES`` or a ``ShapeSpec``; ``cfg``
    replaces the architecture's config (``build_cell``)."""
    from .mesh import init_fake_mesh

    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh_name, default = MESHES[multi_pod]
    mesh_shape = tuple(mesh_shape or default)
    if mesh_shape != default:
        mesh_name = "x".join(map(str, mesh_shape))
    cell = {"arch": arch, "shape": shape.name, "mesh": mesh_name}
    if not shape_applicable(cfg or configs.get_config(arch), shape):
        cell["status"] = "skipped"
        cell["reason"] = ("long_500k requires sub-quadratic attention; "
                          f"{arch} is pure full-attention (DESIGN.md)")
        return cell
    t0 = time.time()
    try:
        with init_fake_mesh(mesh_shape, multi_pod=multi_pod) as mesh:
            built = build_cell(arch, shape, mesh, multi_pod, cfg=cfg)
            counter, out, _ = count_cell(built, only_device="meta")
            del built, out
            cell = cell_result(arch, shape, mesh_name, mesh.shape, counter,
                               time.time() - t0, cfg)
        if verbose:
            r = cell["roofline"]
            ufr = cell["useful_flops_ratio"]
            print(f"[ok] {arch} x {shape.name} x {mesh_name}: "
                  f"run {cell['run_s']}s, "
                  f"peak {cell['memory']['peak_bytes']/2**30:.2f} GiB/dev "
                  f"(fits={cell['fits_hbm']}), "
                  f"t_comp={r['t_compute_s']:.4f}s "
                  f"t_mem={r['t_memory_s']:.4f}s "
                  f"t_coll={r['t_collective_s']:.4f}s -> {r['bottleneck']}; "
                  f"useful={ufr and round(ufr, 3)}", flush=True)
    except Exception as e:  # noqa: BLE001 — report, continue the sweep
        cell["status"] = "error"
        cell["error"] = f"{type(e).__name__}: {e}"
        cell["traceback"] = traceback.format_exc()[-2000:]
        cell["run_s"] = round(time.time() - t0, 1)
        if verbose:
            print(f"[ERR] {arch} x {shape.name} x {mesh_name}: "
                  f"{cell['error']}", flush=True)
    return cell


def cell_path(arch: str, shape: str, multi_pod: bool) -> pathlib.Path:
    mesh = "multi" if multi_pod else "single"
    return RESULTS / f"{arch}__{shape}__{mesh}.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true", help="ignore cache")
    args = ap.parse_args(argv)

    RESULTS.mkdir(parents=True, exist_ok=True)
    archs = configs.list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ([False, True] if args.mesh == "both" or args.all
              else [args.mesh == "multi"])

    failures = 0
    t0 = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                path = cell_path(arch, shape, mp)
                if path.exists() and not args.force:
                    cell = json.loads(path.read_text())
                    print(f"[cached] {arch} x {shape} x "
                          f"{'multi' if mp else 'single'}: {cell['status']}")
                else:
                    cell = run_cell(arch, shape, mp)
                    path.write_text(json.dumps(cell, indent=1))
                if cell["status"] == "error":
                    failures += 1
    print(f"\ndry-run complete in {time.time() - t0:.1f} s; "
          f"{failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
