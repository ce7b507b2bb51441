"""Replay a derived workload through persistent-TLB sessions (DESIGN.md §8).

Two sessions run the same :class:`~repro_torch.workloads.derive.WorkloadTrace`
call-for-call: a baseline (full Reverse Address Translation) and an ideal
(translation disabled).  Compute windows advance both clocks identically, so
per-step degradation is purely the communication-time ratio — token 0 pays
the cold Link-TLB walks, steady-state tokens reuse the warmed entries, and
the trajectory between the two is the paper's inference-serving answer.

Each logical buffer of the trace is laid out in its own page-aligned region
of the target NPA space, so distinct buffers (dispatch vs combine vs
activations vs per-layer gradients) touch distinct Link-TLB entries while
repeated calls on the same buffer hit warm ones.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..core.config import SimConfig
from ..core.session import CollectiveResult, SimSession
from .derive import WorkloadTrace, pod_fabric


@dataclass
class StepStats:
    """Communication statistics of one model step (decode: one token)."""

    step: int
    comm_ns: float = 0.0        # sum of collective completion times
    ideal_comm_ns: float = 0.0
    compute_ns: float = 0.0     # roofline compute windows (both sessions)
    walks: int = 0
    requests: int = 0

    @property
    def degradation(self) -> float:
        return (self.comm_ns / self.ideal_comm_ns
                if self.ideal_comm_ns else float("nan"))


@dataclass
class ReplayResult:
    trace: WorkloadTrace
    cfg: SimConfig
    steps: List[StepStats]
    calls: List[CollectiveResult] = field(default_factory=list)
    ideal_calls: List[CollectiveResult] = field(default_factory=list)

    @property
    def cold_degradation(self) -> float:
        """Step-0 (cold-TLB) communication degradation."""
        return self.steps[0].degradation

    @property
    def steady_degradation(self) -> float:
        """Steady-state degradation: mean over the second half of the steps
        (always excluding step 0 when more than one step was replayed)."""
        if len(self.steps) == 1:
            return self.steps[0].degradation
        tail = self.steps[max(1, len(self.steps) // 2):]
        return sum(s.degradation for s in tail) / len(tail)

    @property
    def total_comm_ns(self) -> float:
        return sum(s.comm_ns for s in self.steps)


def buffer_layout(trace: WorkloadTrace, page_bytes: int) -> Dict[str, int]:
    """Page-aligned base offset per logical buffer of the trace.

    A buffer's region spans twice its largest collective (hierarchical
    patterns stage above the final buffer), rounded up to whole pages.
    """
    sizes: Dict[str, int] = {}
    for c in trace.calls:
        sizes[c.buffer] = max(sizes.get(c.buffer, 0), 2 * c.nbytes)
    layout: Dict[str, int] = {}
    off = 0
    for name in sizes:                       # insertion = first-use order
        layout[name] = off
        pages = -(-sizes[name] // page_bytes)
        off += (pages + 1) * page_bytes
    return layout


def replay(trace: WorkloadTrace, *, cfg: Optional[SimConfig] = None,
           include_ideal: bool = True,
           compute_profile=None) -> ReplayResult:
    """Replay ``trace`` through a warm session (and its ideal twin).

    ``compute_profile`` re-resolves every phase-tagged compute gap from the
    profile's measured windows at replay time (both sessions age
    identically, so degradation stays a pure communication ratio); ``None``
    keeps the trace's derived gaps bit-for-bit.  A trace already derived
    *with* the profile replays identically either way — re-application is
    idempotent.

    The default config simulates the pod the trace was derived for,
    including its topology and tier parameters (:func:`~repro_torch.workloads.
    derive.pod_fabric`); pass ``cfg`` to override fabric or translation
    knobs.
    """
    cfg = cfg or SimConfig(fabric=pod_fabric(trace.pod))
    if cfg.fabric.n_gpus != trace.pod.n_gpus:
        raise ValueError(
            f"cfg pod size {cfg.fabric.n_gpus} != trace pod size "
            f"{trace.pod.n_gpus}")
    layout = buffer_layout(trace, cfg.translation.page_bytes)
    sess = SimSession(cfg, compute_profile=compute_profile)
    ideal = (SimSession(cfg.ideal(), compute_profile=compute_profile)
             if include_ideal else None)

    steps: Dict[int, StepStats] = {}
    calls: List[CollectiveResult] = []
    ideal_calls: List[CollectiveResult] = []
    # With translation disabled a collective's duration depends only on its
    # signature, not on session time or warmth — price each signature once.
    ideal_ns: Dict[tuple, float] = {}
    for c in trace.calls:
        kw = dict(collective=c.collective, n_gpus=c.group,
                  rank_stride=c.stride,
                  gap_ns=c.compute_ns, base_offset=layout[c.buffer],
                  label=c.label, phase=c.phase,
                  window_parts=c.window_parts)
        rec = sess.run(c.nbytes, **kw)
        calls.append(rec)
        st = steps.setdefault(c.step, StepStats(step=c.step))
        st.comm_ns += rec.completion_ns
        st.compute_ns += sess.resolve_gap(c.compute_ns, c.phase,
                                          c.window_parts)
        st.walks += rec.counters.walks
        st.requests += rec.counters.requests
        if ideal is not None:
            sig = (c.collective, c.nbytes, c.group, c.stride)
            if sig not in ideal_ns:
                irec = ideal.run(c.nbytes, **kw)
                ideal_calls.append(irec)
                ideal_ns[sig] = irec.completion_ns
            st.ideal_comm_ns += ideal_ns[sig]

    return ReplayResult(trace=trace, cfg=cfg,
                        steps=[steps[k] for k in sorted(steps)],
                        calls=calls, ideal_calls=ideal_calls)
