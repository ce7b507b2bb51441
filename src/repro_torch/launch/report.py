"""Aggregate ``build/dryrun/*.json`` into the roofline tables
(counterpart of ``repro.launch.report``, with the reference's columns):
the H100's capacity names the "fits" column, and the dry-run table shows
each cell's run time where the reference shows its compile time.

    PYTHONPATH=src python -m repro_torch.launch.report
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from .. import configs
from ..configs.shapes import SHAPES
from .dryrun import RESULTS
from .roofline import HBM_BYTES

GIB = 2**30
CAPACITY = f"{HBM_BYTES / GIB:.1f}G"


def load_cells(root=RESULTS) -> List[Dict]:
    return [json.loads(f.read_text()) for f in sorted(root.glob("*.json"))]


def fmt_s(x: Optional[float]) -> str:
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def _cell(cells, arch, shape, mesh):
    return next((c for c in cells if c["arch"] == arch
                 and c["shape"] == shape and c["mesh"] == mesh), None)


def roofline_table(cells: List[Dict], mesh: str = "pod_16x16") -> str:
    rows = ["| arch | shape | t_compute | t_memory | t_collective | "
            f"bottleneck | peak GiB/dev | fits {CAPACITY} | useful FLOPs |",
            "|---|---|---|---|---|---|---|---|---|"]
    for arch in configs.list_archs():
        for shape in SHAPES:
            c = _cell(cells, arch, shape, mesh)
            if c is None:
                continue
            if c["status"] == "skipped":
                rows.append(f"| {arch} | {shape} | - | - | - | skipped "
                            f"(full attention @500k) | - | - | - |")
                continue
            if c["status"] != "ok":
                rows.append(f"| {arch} | {shape} | ERROR | | | | | | |")
                continue
            r = c["roofline"]
            uf = c.get("useful_flops_ratio")
            if not uf:
                rows.append(f"| {arch} | {shape} | - | - | - | - | - | - "
                            f"| - |")
                continue
            rows.append(
                f"| {arch} | {shape} | {fmt_s(r['t_compute_s'])} | "
                f"{fmt_s(r['t_memory_s'])} | {fmt_s(r['t_collective_s'])} | "
                f"{r['bottleneck']} | "
                f"{c['memory']['peak_bytes']/GIB:.2f} | "
                f"{'yes' if c['fits_hbm'] else 'NO*'} | {uf:.3f} |")
    return "\n".join(rows)


def dryrun_table(cells: List[Dict]) -> str:
    rows = ["| arch | shape | mesh | status | run | peak GiB/dev | "
            "coll GB/dev (ag/ar/rs/a2a) |",
            "|---|---|---|---|---|---|---|"]
    for arch in configs.list_archs():
        for shape in SHAPES:
            for mesh in ("pod_16x16", "multipod_2x16x16"):
                c = _cell(cells, arch, shape, mesh)
                if c is None:
                    continue
                if c["status"] != "ok":
                    rows.append(f"| {arch} | {shape} | {mesh} | "
                                f"{c['status']} | - | - | - |")
                    continue
                k = c["roofline"]["coll_by_kind"]
                coll = (f"{k.get('all-gather',0)/1e9:.1f}/"
                        f"{k.get('all-reduce',0)/1e9:.1f}/"
                        f"{k.get('reduce-scatter',0)/1e9:.1f}/"
                        f"{k.get('all-to-all',0)/1e9:.2f}")
                rows.append(
                    f"| {arch} | {shape} | {mesh} | ok | "
                    f"{c['run_s']}s | "
                    f"{c['memory']['peak_bytes']/GIB:.2f} | {coll} |")
    return "\n".join(rows)


def cells_table(cells: List[Dict]) -> str:
    """Every cell, a row an (arch, shape) with both meshes side by side:
    the roofline terms, the bottleneck, the peak and whether it fits, the
    collective GB a device by kind, the run's seconds; the skipped cells
    in one line after it."""
    meshes = ("pod_16x16", "multipod_2x16x16")
    head = (" t_comp/t_mem/t_coll | bound | peak GiB | ag/ar/rs/a2a GB | "
            "run s |")
    rows = ["| arch | shape |" + head + head,
            "|---|---|" + "---|" * 10]
    skipped = []
    for arch in configs.list_archs():
        for shape in SHAPES:
            cs = [_cell(cells, arch, shape, m) for m in meshes]
            if all(c is None for c in cs):
                continue
            if all(c is not None and c["status"] == "skipped" for c in cs):
                skipped.append(f"{arch} {shape}")
                continue
            row = f"| {arch} | {shape} |"
            for c in cs:
                if c is None or c["status"] != "ok":
                    row += f" {c and c['status']} | | | | |"
                    continue
                r, k = c["roofline"], c["roofline"]["coll_by_kind"]
                row += (f" {fmt_s(r['t_compute_s'])}/"
                        f"{fmt_s(r['t_memory_s'])}/"
                        f"{fmt_s(r['t_collective_s'])} | {r['bottleneck']} | "
                        f"{c['memory']['peak_bytes'] / GIB:.2f}"
                        f"{'' if c['fits_hbm'] else ' NO'} | "
                        + "/".join(f"{k.get(n, 0) / 1e9:.2f}" for n in (
                            "all-gather", "all-reduce", "reduce-scatter",
                            "all-to-all"))
                        + f" | {c['run_s']} |")
            rows.append(row)
    if skipped:
        rows.append("")
        rows.append("skipped (full attention at 500k, both meshes): "
                    + ", ".join(skipped))
    return "\n".join(rows)


def cache_gather_bytes(cell: Dict) -> Optional[int]:
    """The bytes of cache that the cell's step gathered on a rank, over
    every axis: its counted all-gathers under the tag ``"cache"``
    (``parallel.fsdp``); None for a cell counted before the tag."""
    tagged = cell["counts"].get("tagged")
    if tagged is None:
        return None
    return sum(kinds.get("all-gather", {}).get("bytes", 0)
               for kinds in tagged.get("cache", {}).values())


def decode_table(cells: List[Dict]) -> str:
    """The serve steps' all-gathers a device (GB), over ``model`` and over
    the batch axes, and how much of them is cache, counted from the step
    (the rest is weights gathered whole, the SSM mixers', and decode
    attention's new K rows, queries and outputs)."""
    rows = ["| arch | shape | mesh | all-gather over model GB | over "
            "data/pod GB | of them caches GB |",
            "|---|---|---|---|---|---|"]
    for arch in configs.list_archs():
        for shape in SHAPES:
            if SHAPES[shape].kind != "decode":
                continue
            for mesh in ("pod_16x16", "multipod_2x16x16"):
                c = _cell(cells, arch, shape, mesh)
                if c is None or c["status"] != "ok":
                    continue
                by_axis = c["counts"]["axis_collectives"]

                def ag(axis):
                    return by_axis.get(axis, {}).get("all-gather", {}).get(
                        "bytes", 0)
                cache = cache_gather_bytes(c)
                rows.append(f"| {arch} | {shape} | {mesh} | "
                            f"{ag('model') / 1e9:.2f} | "
                            f"{(ag('data') + ag('pod')) / 1e9:.2f} | "
                            + ("-" if cache is None else f"{cache / 1e9:.2f}")
                            + " |")
    return "\n".join(rows)


def summary(cells: List[Dict]) -> Dict:
    ok = [c for c in cells if c["status"] == "ok"]
    skipped = [c for c in cells if c["status"] == "skipped"]
    err = [c for c in cells if c["status"] == "error"]
    fits = [c for c in ok if c.get("fits_hbm")]
    return {"ok": len(ok), "skipped": len(skipped), "error": len(err),
            "fits": len(fits), "total": len(cells)}


if __name__ == "__main__":
    cells = load_cells()
    print(json.dumps(summary(cells), indent=1))
    print()
    print(roofline_table(cells))
    print()
    print(dryrun_table(cells))
    print()
    print(cells_table(cells))
    print()
    print(decode_table(cells))
