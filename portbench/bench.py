"""One run of one cell: set-up, the measured window, the judgement, the
metrics, and the result line.

Set-up (``setup_s``, from the process's start to the window's start):
the program's registry is checked against the cell's configuration file,
the weights are drawn on the card from ``--seed``, the program is built
on them, and the cell's own call shape is served ``WARMUP_CALLS`` times
(the kernels come from the program's build cache in the checkout).

The window: the mix's generator (``generators/<name>.py``) issues the
calls, each when its requests have arrived and the previous call has
returned; the closed loop's call is the program's ``CausalLM.prefill``
followed by the argmax of the last position's logits and its copy to the
host, as the program's ``launch/serve.generate`` serves a first token.
With ``--trace 1`` the ``PROFILE_CALLS`` calls after the first
``PROFILE_AFTER`` are recorded by ``torch.profiler``, each inside a
``portbench.call`` range.

After the window: the device's peak memory is read, the program and its
outputs are freed, the reference judges what was kept (``check``), and
each metric's reader reads the window or the trace.  No module of JAX or
of the JAX package may be loaded by then.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from . import check, manifest, roofline, trace, weights
from .reference import plain
from .window import Call, Window

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARMUP_CALLS = 2     # the cell's call shape served before the window
PROFILE_AFTER = 2    # a traced run records the calls after these
PROFILE_CALLS = 3    # steady calls a traced run records


class Program:
    """The system under test: the program's ``CausalLM`` on the cell's
    weights, serving prefill calls."""

    def __init__(self, cfg, params):
        from repro_torch.models.api import CausalLM
        self.model = CausalLM(cfg, params)

    def prefill(self, ids: torch.Tensor, s_max: int):
        return self.model.prefill(ids, s_max)

    def first_tokens(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits, dim=-1).cpu()


@dataclass
class Run:
    """What a metric's reader reads (``metrics/<name>.py``)."""
    model: Dict                       # the configuration's sizes as run
    setup_s: float
    window: Window
    reference: object = None          # the family's reference module
    trace: Optional[trace.Summary] = None
    profiled: List[Dict] = field(default_factory=list)
    yardstick = roofline


class Failure(Exception):
    """A run that cannot give a result; ``code`` is its exit code."""

    def __init__(self, msg: str, code: int):
        super().__init__(msg)
        self.code = code


def loaded_forbidden() -> List[str]:
    """Modules of JAX or of the JAX package in this process, by top-level
    name compared whole."""
    return sorted({name.split(".", 1)[0] for name in sys.modules
                   if name.split(".", 1)[0] in FORBIDDEN})


def check_config(cell: manifest.Cell, port_cfg) -> None:
    """Every size of the cell's configuration file equals the program's
    registry entry it names: no change to the registry shrinks the timed
    model unseen."""
    bad = []
    for key, want in cell.config["model"].items():
        got = getattr(port_cfg, key, None)
        got = list(got) if isinstance(got, tuple) else got
        if got != want:
            bad.append(f"{key}: file {want!r}, registry {got!r}")
    if bad:
        raise Failure(f"{cell.config_name}: the program's registry entry "
                      f"{cell.config['port_config']!r} differs from the "
                      f"configuration file: " + "; ".join(bad), 4)


def _cache_rows(caches, row: int) -> Dict[str, torch.Tensor]:
    """Row ``row`` of every tensor of the program's caches, copied."""
    out = {}
    for name, c in caches.items():
        for f, t in c._asdict().items():
            if isinstance(t, torch.Tensor):
                out[f"{name}/{f}"] = t[:, row].clone()
    return out


def keep(i: int, logits, tokens, caches, seed: int) -> List[check.Served]:
    """What call ``i`` leaves for the judgement (``check``): the kept
    rows' logits and tokens, and the first kept row's cache on every
    ``CACHE_EVERY``-th call."""
    rows = check.kept_rows(i, logits.shape[0], seed)
    return [check.Served(
        call=i, row=r, logits=logits[r].clone(), token=int(tokens[r]),
        cache=(_cache_rows(caches, r) if j == 0 and i % check.CACHE_EVERY
               == 0 else None)) for j, r in enumerate(rows)]


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run(cell_name: str, seed: int, seconds: float, traced: bool, *,
        t0: float, device=None, root=manifest.ROOT, port_cfg=None,
        model=None, traffic_over: Optional[Dict] = None,
        program_cls=Program, err=sys.stderr) -> Dict:
    """One run; returns the result's object.  ``device`` None means the
    card(s) the cell asks for, looked for first; the tests pass "cpu"
    with a small ``port_cfg``, its ``model`` sizes and ``traffic_over``."""
    marks = [("imports", time.perf_counter())]
    cell = manifest.cell(cell_name, root)
    if device is None:
        if not torch.cuda.is_available():
            raise Failure("no CUDA device: this benchmark runs on the card",
                          3)
        if torch.cuda.device_count() < cell.chips:
            raise Failure(f"{cell.name} needs {cell.chips} cards, "
                          f"{torch.cuda.device_count()} found", 3)
        device = "cuda"
    dev = torch.device(device)
    if port_cfg is None:
        from repro_torch import configs
        port_cfg = configs.get_config(cell.config["port_config"])
        check_config(cell, port_cfg)
        model = cell.config["model"]
    fam = manifest.reference(cell.config["reference"])
    mix = {**cell.traffic, **(traffic_over or {})}

    from repro_torch.models.spec import torch_dtype
    torch.empty(0, device=dev)
    marks.append(("card", time.perf_counter()))
    flat = weights.draw(fam.leaves(model), seed,
                        torch_dtype(port_cfg.dtype), dev)
    program = program_cls(port_cfg, weights.tree(flat))
    traffic = manifest.generator(mix, root).Traffic(mix, seed, model["vocab_size"],
                                              dev)
    marks.append(("weights", time.perf_counter()))
    for i in traffic.warmup_calls(WARMUP_CALLS):
        traffic.serve(program, i)
        marks.append((f"call {i}", time.perf_counter()))
    prof_after, prof_calls = PROFILE_AFTER, PROFILE_CALLS
    profiler_kw = {}
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        profiler_kw = dict(activities=acts)
        with profile(**profiler_kw):        # the tracer's own start-up
            torch.ones(1, device=dev).add_(1)
            if dev.type == "cuda":
                torch.cuda.synchronize()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    setup_s = time.perf_counter() - t0
    marks.append(("tracer" if traced else "rest", t0 + setup_s))
    print("setup: " + ", ".join(
        f"{name} {b - a:.3f} s" for (name, b), (_, a)
        in zip(marks, [("", t0)] + marks[:-1])), file=err)

    # ------------------------------------------------------ the window
    window = Window(opened=time.perf_counter())
    kept: Dict[int, List[check.Served]] = {}
    prof = None
    i = 0
    while True:
        now = time.perf_counter()
        if now - window.opened >= seconds and (
                not traced or i >= prof_after + prof_calls):
            break
        arrivals = traffic.arrivals(i)
        if arrivals is not None:
            arrived = [window.opened + a for a in arrivals]
            wait = max(arrived) - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        if traced and i == prof_after:
            prof = profile(**profiler_kw)
            prof.start()
        recording = prof is not None and i < prof_after + prof_calls
        with (torch.profiler.record_function(trace.CALL_RANGE)
              if recording else contextlib.nullcontext()):
            t_issue = time.perf_counter()
            logits, tokens, caches = traffic.serve(program, i)
            t_done = time.perf_counter()
        if recording and i == prof_after + prof_calls - 1:
            prof.stop()
        B = logits.shape[0]
        window.calls.append(Call(
            i, t_issue, t_done, B, B * traffic.prompt_len(i),
            None if arrivals is None else arrived))
        kept[i] = keep(i, logits, tokens, caches, seed)
        del logits, caches
        i += 1

    # ----------------------------------------------- after the window
    if dev.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        kind = torch.cuda.get_device_name(dev)
    else:
        peak, kind = 0, "cpu"
    del program
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    plain.set_exact_matmul()
    done = [c.index for c in window.calls]
    judged = [s for c in check.choose(done, check.CALLS, seed)
              for s in kept[c]]
    kept.clear()
    numbers = check.judge(judged, fam, model, flat, traffic,
                          per_request=cell.limits.get("per_request"))
    ok, checks = check.verdict(numbers, cell.limits)

    view = Run(model=model, setup_s=setup_s, window=window, reference=fam)
    metrics = cell.metrics(traced)
    readers = {m.name: m.reader() for m in metrics}
    summary = None
    if traced:
        evs = trace.events(prof)
        kinds: Dict[str, int] = {}
        for e in evs:
            kinds[e.kind] = kinds.get(e.kind, 0) + 1
        print(f"trace: {len(evs)} records by kind {kinds}", file=err)
        summary = trace.summarize(evs)
        prof = None
        view.trace = summary
        profiled = window.calls[prof_after:prof_after + prof_calls]
        needs = set().union(*(getattr(r, "NEEDS", ()) for r in
                              readers.values()))
        for c in profiled:
            entry = {"batch": c.requests,
                     "prompt_len": traffic.prompt_len(c.index)}
            if "route_stats" in needs:
                with torch.no_grad():
                    entry["route"] = fam.forward(
                        model, flat, traffic.ids(c.index), stats=True
                    )["stats"]
            view.profiled.append(entry)
    values = {}
    for m in metrics:
        v = readers[m.name].read(view)
        if v is not None:
            values[m.name] = {"value": float(v), "unit": m.unit}

    found = loaded_forbidden()
    if found:
        raise Failure("modules of JAX or the JAX package are loaded: "
                      + ", ".join(found), 5)
    result = {
        "correct": bool(ok and window.calls),
        "attempted": window.requests,
        "failed": 0,
        "metrics": values,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": kind, "count": 1, "memory_peak_bytes": int(peak)},
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
        if dev.type == "cuda":
            print(f"card and power limit: {power_limit()}", file=err)
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=err)
    return result


def dumps(result: Dict) -> str:
    """The result as one line of JSON (infinite numbers as strings)."""
    def fix(v):
        if isinstance(v, float) and not math.isfinite(v):
            return str(v)
        if isinstance(v, dict):
            return {k: fix(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [fix(x) for x in v]
        return v
    return json.dumps(fix(result))
