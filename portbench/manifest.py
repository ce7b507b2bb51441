"""The benchmark's manifest and the files it names, found by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, the
cells and the metrics.  Everything that belongs to one of them sits in a
file of its own under ``portbench/``, found from the name alone:

- ``configs/<config>.json``: the sizes as run, the program's registry name
  for them (``port_config``) and the reference family;
- ``traffic/<mix>.json``: the traffic mix's parameters, read by the
  generator it names;
- ``generators/<generator>.py``: a traffic generator (an arrival
  process and the timed call);
- ``workloads/<cell>.json``: the cell's correctness limits;
- ``metrics/<metric>.py``: the reader of one metric (``read(run)``);
- ``reference/<family>.py``: the plain reference of a model family and
  its model FLOPs.

A new cell, configuration or metric is new files and manifest entries.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Metric:
    name: str
    unit: str
    workloads: Optional[List[str]]     # None: every cell reports it
    path: Path

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads

    def reader(self):
        """The metric's module: ``read(run) -> float | None``."""
        return _module(self.path,
                       "portbench_metric_" + self.name.replace(".", "_"))


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    limits: Dict                      # workloads/<cell>.json
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)

    def metrics(self, trace: bool) -> List[Metric]:
        return self.per_layer if trace else self.end_to_end


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load(root: Path = ROOT) -> Dict:
    return _json(Path(root) / "BENCHMARK.json")


def _metrics(root: Path, entries, cell: str) -> List[Metric]:
    out = []
    for e in entries:
        m = Metric(name=e["name"], unit=e["unit"],
                   workloads=e.get("workloads"),
                   path=Path(root) / "portbench" / "metrics"
                   / f"{e['name']}.py")
        if m.applies(cell):
            out.append(m)
    return out


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the manifest with every file it names read."""
    root = Path(root)
    bench = load(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=_json(root / conf["file"]), traffic_name=w["traffic"],
        traffic=_json(root / "portbench" / "traffic" / f"{w['traffic']}.json"),
        limits=_json(root / "portbench" / "workloads" / f"{name}.json"),
        end_to_end=_metrics(root, bench["end_to_end"], name),
        per_layer=_metrics(root, bench["per_layer"], name))


def reference(family: str):
    """The reference module of a model family (``reference/<family>.py``)."""
    return importlib.import_module(f"portbench.reference.{family}")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(mix: Dict, root: Path = ROOT):
    """The generator module a mix names (``generators/<name>.py``)."""
    name = mix["generator"]
    return _module(Path(root) / "portbench" / "generators" / f"{name}.py",
                   f"portbench_generator_{name}")
