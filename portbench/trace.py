"""What a traced run reads off the profiler: device busy time, idle gaps
and what the host did in them, kernels and host syncs a call.

The profiler (``torch.profiler`` with CPU and CUDA activities) records the
profiled calls, each inside a ``portbench.call`` range.  :func:`events`
turns its records into :class:`Ev` tuples on one clock;
:func:`summarize` reads them.  The traced window runs from the first
profiled call's issue to the last one's return.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, NamedTuple, Tuple

CALL_RANGE = "portbench.call"
# runtime calls that hold the host until the device reaches them
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})
DEVICE_KINDS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})


class Ev(NamedTuple):
    kind: str      # kernel, gpu_memcpy, gpu_memset, cuda_runtime, cpu_op,
    #                user_annotation, ...
    name: str
    start: int     # ns
    end: int       # ns


def _kind(e) -> str:
    """The record's activity: the profiler's own word where it gives one
    (``activity_type``, newer PyTorch), else told from the device and the
    name: device records are kernels but for copies, fills and the call
    range's device copy; host records named ``cuda*`` are runtime calls."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    name = e.name()
    if "CUDA" in str(e.device_type()):
        if name == CALL_RANGE:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if name == CALL_RANGE:
        return "user_annotation"
    if name.startswith("cuda") or name.startswith("cu"):
        return "cuda_runtime"
    return "cpu_op"


def events(prof) -> List[Ev]:
    """The records of a finished ``torch.profiler.profile`` as :class:`Ev`."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            start, dur = int(e.start_ns()), int(e.duration_ns())
        else:
            start, dur = int(e.start_us()) * 1000, int(e.duration_us()) * 1000
        out.append(Ev(_kind(e), e.name(), start, start + dur))
    return out


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Overlapping or touching intervals merged, in order."""
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def kernel_key(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    arguments: what a metric's prefix is matched against (the port's
    kernels sit in anonymous namespaces: ``void (anonymous namespace)::
    gmm_wgmma_kernel<0>(CUtensorMap_st, ...)`` -> ``gmm_wgmma_kernel<0>``).
    """
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0]


@dataclass
class Summary:
    calls: int                      # profiled calls
    window_s: float                 # first issue to last return
    busy_s: float                   # the union of device operations in it
    kernels: int                    # kernel launches in it
    syncs: int                      # runtime calls that held the host
    kernel_s: Dict[str, float] = field(default_factory=dict)   # by key
    kernel_n: Dict[str, int] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def idle_s(self) -> float:
        return max(0.0, self.window_s - self.busy_s)

    def device_time(self, prefix: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose key starts with
        ``prefix``."""
        s = sum(t for k, t in self.kernel_s.items() if k.startswith(prefix))
        n = sum(c for k, c in self.kernel_n.items() if k.startswith(prefix))
        return s, n


def _label(stack: List[Ev]) -> str:
    if not stack:
        return "python (between calls)"
    if stack[-1].name == CALL_RANGE:
        return "python (in a call, no operation)"
    return stack[-1].name


def host_timeline(host: List[Ev], w0: int, w1: int):
    """[(start, end, what the host was doing)] covering [w0, w1]: the
    innermost host operation at each instant (host events of one thread
    nest), from one sweep with a stack."""
    segs: List[Tuple[int, int, str]] = []
    stack: List[Ev] = []
    t = w0

    def emit(upto: int) -> None:
        nonlocal t
        upto = min(max(upto, w0), w1)
        if upto > t:
            segs.append((t, upto, _label(stack)))
            t = upto

    for e in sorted(host, key=lambda e: (e.start, -e.end)):
        while stack and stack[-1].end <= e.start:
            emit(stack[-1].end)
            stack.pop()
        emit(e.start)
        stack.append(e)
    while stack:
        emit(stack[-1].end)
        stack.pop()
    emit(w1)
    return segs


def idle_by_host(holes: List[Tuple[int, int]], segs) -> Dict[str, float]:
    """Seconds of the device's idle ``holes`` by what the host was doing."""
    out: Dict[str, float] = {}
    j = 0
    for a, b in holes:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                out[segs[k][2]] = out.get(segs[k][2], 0.0) + (hi - lo) / 1e9
            k += 1
    return out


def summarize(evs: List[Ev], top: int = 10) -> Summary:
    calls = sorted((e for e in evs if e.kind == "user_annotation"
                    and e.name == CALL_RANGE), key=lambda e: e.start)
    if not calls:
        raise ValueError(f"trace: no {CALL_RANGE!r} range recorded")
    w0, w1 = calls[0].start, max(e.end for e in calls)
    dev = [e for e in evs if e.kind in DEVICE_KINDS
           and e.end > w0 and e.start < w1]
    busy = union((max(e.start, w0), min(e.end, w1)) for e in dev)
    kernels = [e for e in dev if e.kind == "kernel"]
    kernel_s: Dict[str, float] = {}
    kernel_n: Dict[str, int] = {}
    by_op: Dict[str, float] = {}
    for e in dev:
        key = kernel_key(e.name)
        by_op[key] = by_op.get(key, 0.0) + (e.end - e.start) / 1e9
        if e.kind == "kernel":
            kernel_s[key] = kernel_s.get(key, 0.0) + (e.end - e.start) / 1e9
            kernel_n[key] = kernel_n.get(key, 0) + 1
    syncs = sum(1 for e in evs if e.kind == "cuda_runtime"
                and e.name in SYNC_CALLS and w0 <= e.start < w1)
    # one thread issues every call, so host events nest
    host = [e for e in evs if e.kind in ("cpu_op", "cuda_runtime",
                                         "cuda_driver", "user_annotation")]
    holes, edge = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > edge:
            holes.append((edge, s))
        edge = max(edge, e)
    gaps = idle_by_host(holes, host_timeline(host, w0, w1))
    return Summary(
        calls=len(calls), window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9, kernels=len(kernels),
        syncs=syncs, kernel_s=kernel_s, kernel_n=kernel_n,
        device_ops=sorted(by_op.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:top])
