"""Request-level serving simulation over persistent-TLB replay (DESIGN.md §11).

:func:`simulate_traffic` drives one :class:`~repro_torch.core.session.SimSession`
with a stream of inference requests instead of a fixed step loop: a
continuous-batching scheduler (:mod:`repro_torch.serving.scheduler`) decides each
step's live batch composition, :class:`repro_torch.workloads.derive.StepEmitter`
sizes that step's collectives from it (EP dispatch bytes scale with active
tokens; prefill chunks interleave with decode tokens), and the session
prices them with whatever Link-TLB warmth the preceding traffic left
behind.  When the pod has no work the session *idles* to the next arrival —
under ``SimConfig.tlb_retention_ns`` a long enough gap flushes the warmed
translations, so the first steps after a quiet period re-pay the cold
walks.  That interaction between arrival burstiness and TLB retention is
the tail-latency mechanism this layer exists to measure.

The zero-translation counterfactual runs the *same* schedule (admission
decisions are driven by the baseline clock) on an ideal fabric: with
translation disabled a collective's duration depends only on its signature,
so each signature is priced once and the ideal timeline is accumulated
analytically.  Per-request degradation is then baseline vs ideal
time-to-first-token on an identical step sequence.

Determinism contract: given the same request list and ``SimConfig``,
:func:`simulate_traffic` is bit-for-bit deterministic across engines
(event ≡ vectorized) and sweep executors (:func:`fan_out_points` serial ≡
process-pooled) — locked by ``tests/test_torch_serving.py``.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.config import (PrefetchConfig, PreTranslationConfig, SimConfig)
from ..core.session import SimSession
from ..workloads.derive import (PodSpec, StepEmitter, WorkloadTrace,
                                pod_fabric, resolve_pod)
from ..workloads.replay import buffer_layout
from .arrivals import (Request, bursty_requests, poisson_requests,
                       trace_requests)
from .scheduler import ContinuousBatcher, RequestStats

_PCTS = (50.0, 95.0, 99.0)


@dataclass
class ServingStep:
    """One engine step: live batch composition and priced timing."""

    step: int
    t_start: float
    t_end: float
    decode_tokens: int
    prefill_tokens: int
    comm_ns: float
    ideal_comm_ns: float
    compute_ns: float
    walks: int
    # Vectorized-engine warm-fast-path engagements while pricing this step
    # (0 on the event engine, which has no fast path to engage).
    fastpath_calls: int = 0

    @property
    def degradation(self) -> float:
        return (self.comm_ns / self.ideal_comm_ns
                if self.ideal_comm_ns else float("nan"))


class ServingAggregates:
    """Request/step aggregation shared by single-pod and fleet results.

    Mixin over anything exposing ``requests`` (a list of
    :class:`RequestStats`) and ``steps`` (a list of :class:`ServingStep`);
    :class:`TrafficResult` carries them as fields, the fleet result
    aggregates them over its replicas.
    """

    # -- aggregation ---------------------------------------------------------
    @property
    def finished(self) -> List[RequestStats]:
        return [r for r in self.requests if r.finished]

    @property
    def first_token_served(self) -> List[RequestStats]:
        return [r for r in self.requests if r.first_token_ns is not None]

    def ttft_percentiles(self, pcts: Sequence[float] = _PCTS) -> Dict[float, float]:
        vals = [r.ttft_ns for r in self.first_token_served]
        if not vals:
            return {p: float("nan") for p in pcts}
        return {p: float(np.percentile(vals, p)) for p in pcts}

    def itl_percentiles(self, pcts: Sequence[float] = _PCTS) -> Dict[float, float]:
        vals = [v for r in self.requests for v in r.itl_ns]
        if not vals:
            return {p: float("nan") for p in pcts}
        return {p: float(np.percentile(vals, p)) for p in pcts}

    def ttft_degradations(self) -> List[float]:
        return [r.ttft_degradation for r in self.first_token_served
                if r.ttft_degradation is not None]

    @property
    def mean_ttft_degradation(self) -> float:
        d = self.ttft_degradations()
        return float(np.mean(d)) if d else float("nan")

    @property
    def p99_ttft_degradation(self) -> float:
        d = self.ttft_degradations()
        if not d:
            return float("nan")
        with np.errstate(invalid="ignore"):
            p = float(np.percentile(d, 99.0))
        # Zero-ideal requests carry infinite degradation; when the p99
        # rank lands between two such samples numpy's interpolation is
        # inf - inf = nan, but the order statistic itself is inf.
        if np.isnan(p) and any(np.isinf(x) for x in d):
            return float("inf")
        return p

    # Pod-level comm split, aggregated from steps.  (Per-request
    # ``RequestStats.cold_comm_ns`` is *experienced* latency — every active
    # request counts a shared step in full — so summing it over requests
    # would multiply-count overlapping batches; these are the honest
    # pod-time aggregates.)
    @property
    def cold_comm_ns(self) -> float:
        return sum(s.comm_ns for s in self.steps if s.walks > 0)

    @property
    def warm_comm_ns(self) -> float:
        return sum(s.comm_ns for s in self.steps if s.walks == 0)

    @property
    def cold_steps(self) -> int:
        return sum(1 for s in self.steps if s.walks > 0)

    # Warm-fast-path engagement (vectorized engine only; the event engine
    # reports 0 everywhere and the fraction is 0.0).
    @property
    def fastpath_calls(self) -> int:
        return sum(s.fastpath_calls for s in self.steps)

    @property
    def fastpath_step_fraction(self) -> float:
        """Fraction of priced steps where the warm fast path engaged.

        Steady-state decode traffic on the vectorized engine should sit
        near 1.0; prefill chunks and post-flush steps are the misses.
        """
        if not self.steps:
            return float("nan")
        return (sum(1 for s in self.steps if s.fastpath_calls > 0)
                / len(self.steps))


@dataclass
class TrafficResult(ServingAggregates):
    """Per-request and per-step statistics of one serving simulation."""

    arch: str
    pod: PodSpec
    cfg: SimConfig
    requests: List[RequestStats]
    steps: List[ServingStep]
    steps_capped: bool = False


def _resolve_arch(arch):
    if isinstance(arch, str):
        from ..configs import get_config         # torch-free (models.spec)
        return get_config(arch)
    return arch


def serving_layout(mcfg, pod: PodSpec, max_step_tokens: int,
                   page_bytes: int) -> Dict[str, int]:
    """Page-aligned buffer offsets covering the *largest possible* step.

    Collective sizes vary with live batch composition, but a logical
    buffer's pages must stay put across steps (that is what makes repeated
    steps warm); regions are therefore sized for the worst-case step —
    every decode slot occupied plus a full prefill chunk.
    """
    em = StepEmitter(mcfg, pod)
    em.step(0, max_step_tokens)
    probe = WorkloadTrace(arch=mcfg.name, shape="serving", pod=pod,
                          calls=em.calls)
    return buffer_layout(probe, page_bytes)


def resolve_traffic_pod(arch, pod: Optional[PodSpec],
                        n_gpus: Optional[int],
                        cfg: Optional[SimConfig]):
    """``(mcfg, pod, cfg)`` after the shared serving-entry validation."""
    mcfg = _resolve_arch(arch)
    pod = pod or PodSpec()
    if n_gpus is not None:
        pod = dataclasses.replace(pod, n_gpus=n_gpus)
    pod = resolve_pod(pod, mcfg, "decode")
    cfg = cfg or SimConfig(fabric=pod_fabric(pod))
    if cfg.fabric.n_gpus != pod.n_gpus:
        raise ValueError(f"cfg pod size {cfg.fabric.n_gpus} != "
                         f"pod size {pod.n_gpus}")
    return mcfg, pod, cfg


class PodStream:
    """One pod's serving stream: session, batcher, ideal counterfactual.

    The single-pod engine behind :func:`simulate_traffic`, factored out so
    the fleet layer (:mod:`repro_torch.serving.fleet`) can run N of them — one
    per replica, each with its own :class:`SimSession` (and hence its own
    Link-TLB warmth) — under an external event loop.  ``start_ns`` places
    the stream's clock at the replica's spin-up time: a freshly spun
    replica is a *cold* session whose first steps re-pay the full TLB
    warmup, which is exactly the fleet-scale RAT event.

    :meth:`advance` performs one scheduler decision — price one step, or
    idle to the stream's next arrival — and :meth:`next_event_ns` exposes
    when that decision would happen, so an external loop can interleave
    several streams in global time order without ever letting one stream's
    clock run ahead of an arrival that still has to be routed to it.
    """

    def __init__(self, mcfg, pod: PodSpec, cfg: SimConfig,
                 requests: List[Request], *,
                 max_decode_slots: int = 32,
                 prefill_chunk_tokens: int = 512,
                 compute_profile=None, start_ns: float = 0.0,
                 policy=None):
        self.mcfg, self.pod, self.cfg = mcfg, pod, cfg
        self.layout = serving_layout(
            mcfg, pod, max_decode_slots + prefill_chunk_tokens,
            cfg.translation.page_bytes)
        self.sess = SimSession(cfg, compute_profile=compute_profile)
        self.ideal = SimSession(cfg.ideal(), compute_profile=compute_profile)
        self.sess.t = start_ns
        self.ideal_clock = start_ns
        self._ideal_ns: Dict[tuple, float] = {}  # signature -> ideal ns
        self.batcher = ContinuousBatcher(
            requests, max_decode_slots=max_decode_slots,
            prefill_chunk_tokens=prefill_chunk_tokens)
        # The emitter resolves logical collectives per step; the trace it
        # emits carries concrete names, so the session replays exactly the
        # chosen algorithms (policy=None on the session side).
        self.em = StepEmitter(mcfg, pod, policy=policy)
        self.steps: List[ServingStep] = []

    @property
    def t(self) -> float:
        return self.sess.t

    @property
    def drained(self) -> bool:
        return self.batcher.drained

    def next_event_ns(self) -> Optional[float]:
        """When the next :meth:`advance` call would act; ``None`` = drained.

        ``sess.t`` when a step can be planned now (work admitted or in
        flight), else the stream's next arrival (never before ``sess.t`` —
        a stream cannot plan in its own past).
        """
        b = self.batcher
        if b.decoding or b.prefilling or b.waiting:
            return self.sess.t
        nxt = b.next_arrival_ns()
        if nxt is None:
            return None
        return max(nxt, self.sess.t)

    def advance(self) -> Optional[ServingStep]:
        """One scheduler decision: price one step, or idle to next arrival.

        Returns the priced :class:`ServingStep`, or ``None`` when the
        stream idled (or is drained — check :attr:`drained`).
        """
        plan = self.batcher.plan(self.sess.t)
        if plan is None:
            nxt = self.batcher.next_arrival_ns()
            if nxt is None:          # nothing in flight, nothing to come
                return None
            # Idle to the next arrival: ages (and beyond the retention
            # window, flushes) the warmed TLBs.  The ideal timeline waits
            # for the same arrival.  A flushing gap also resets the
            # emitter's buffer-warmth view, so the first post-flush steps
            # re-select cold-optimal algorithms.
            gap = nxt - self.sess.t
            self.sess.idle(gap)
            retention = self.cfg.tlb_retention_ns
            if retention is not None and gap >= retention:
                self.em.mark_cold()
            self.ideal_clock = max(self.ideal_clock, nxt)
            return None

        # Causality floor for the ideal timeline: the counterfactual run
        # executes the same step sequence, but a step serving a request's
        # *first* prefill chunk cannot start before that request arrived —
        # without this, a faster-than-baseline ideal clock could emit
        # first tokens before their requests exist, inflating degradation
        # with an unphysical queueing term.
        new_arrivals = [r.req.arrival_ns for r, _t in plan.prefill
                        if r.prefill_done == 0]
        if new_arrivals:
            self.ideal_clock = max(self.ideal_clock, max(new_arrivals))

        sess, em, layout = self.sess, self.em, self.layout
        t0 = sess.t
        base = len(em.calls)
        em.step(len(self.steps), plan.total_tokens,
                prefix=f"t{len(self.steps)}")
        comm = ideal_comm = compute = 0.0
        walks = fastpath = 0
        for c in em.calls[base:]:
            kw = dict(collective=c.collective, n_gpus=c.group,
                      rank_stride=c.stride, gap_ns=c.compute_ns,
                      base_offset=layout[c.buffer], label=c.label,
                      phase=c.phase, window_parts=c.window_parts)
            rec = sess.run(c.nbytes, **kw)
            comm += rec.completion_ns
            walks += rec.counters.walks
            fastpath += rec.fastpath_calls
            compute += sess.resolve_gap(c.compute_ns, c.phase,
                                        c.window_parts)
            sig = (c.collective, c.nbytes, c.group, c.stride)
            if sig not in self._ideal_ns:
                self._ideal_ns[sig] = self.ideal.run(
                    c.nbytes, **kw).completion_ns
            ideal_comm += self._ideal_ns[sig]
        self.ideal_clock += compute + ideal_comm
        step = ServingStep(
            step=len(self.steps), t_start=t0, t_end=sess.t,
            decode_tokens=plan.decode_tokens,
            prefill_tokens=plan.prefill_tokens,
            comm_ns=comm, ideal_comm_ns=ideal_comm, compute_ns=compute,
            walks=walks, fastpath_calls=fastpath)
        self.steps.append(step)
        self.batcher.commit(plan, sess.t, self.ideal_clock, comm,
                            ideal_comm, walks)
        return step


def simulate_traffic(arch, requests: List[Request], *,
                     pod: Optional[PodSpec] = None,
                     n_gpus: Optional[int] = None,
                     cfg: Optional[SimConfig] = None,
                     max_decode_slots: int = 32,
                     prefill_chunk_tokens: int = 512,
                     steps_cap: Optional[int] = None,
                     compute_profile=None,
                     policy=None) -> TrafficResult:
    """Serve ``requests`` on a simulated pod; returns per-request latencies.

    ``arch`` is a registry name (resolved without importing torch) or any
    ``ModelConfig``-shaped object.  ``cfg`` overrides the simulated fabric
    and translation knobs (``tlb_retention_ns`` is what couples arrival
    gaps to TLB cold misses); the default simulates the pod the workload
    is mapped onto, exactly as workload replay does.  ``steps_cap`` bounds
    the number of engine steps (unfinished requests simply stay
    unfinished); percentiles are computed over served requests.
    ``policy`` selects each step's collective algorithms
    (:mod:`repro_torch.core.select`; default fixed — bit-for-bit).
    """
    mcfg, pod, cfg = resolve_traffic_pod(arch, pod, n_gpus, cfg)
    stream = PodStream(mcfg, pod, cfg, requests,
                       max_decode_slots=max_decode_slots,
                       prefill_chunk_tokens=prefill_chunk_tokens,
                       compute_profile=compute_profile, policy=policy)
    capped = False
    while not stream.drained:
        if steps_cap is not None and len(stream.steps) >= steps_cap:
            capped = True
            break
        stream.advance()

    return TrafficResult(arch=mcfg.name, pod=pod, cfg=cfg,
                         requests=stream.batcher.stats, steps=stream.steps,
                         steps_capped=capped)


# ------------------------------------------------------------------ sweeps
@dataclass(frozen=True)
class TrafficPoint:
    """One point of a serving sweep — fully describes a simulation.

    Frozen and hashable: the point is the sweep key, and (with its seed) it
    *is* the arrival stream, so a point prices identically on the serial
    and the pooled executor.
    """

    arch: str = "granite-moe-1b-a400m"
    rps: float = 8.0
    arrival: str = "poisson"            # poisson | bursty
    n_requests: int = 64
    seed: int = 0
    n_gpus: int = 16
    topology: str = "single_clos"
    leaf_size: int = 0
    oversubscription: float = 1.0
    pod_size: int = 0
    l2_entries: int = 0                 # 0 => translation default
    retention_ns: Optional[float] = None
    steps_cap: Optional[int] = None
    burst_size: int = 8
    burstiness: float = 16.0
    prompt_mean: int = 256
    output_mean: int = 32
    max_decode_slots: int = 32
    prefill_chunk_tokens: int = 512
    pretranslation: bool = False        # paper §6.1 fused probes
    prefetch: bool = False              # paper §6.2 software prefetch
    trace_path: Optional[str] = None    # arrival="trace"
    engine: str = "event"               # SimConfig.engine (bit-for-bit)
    # Path to a saved ComputeProfile JSON (workloads.calibrate): loaded
    # torch-free *inside* whichever process prices the point, so pooled and
    # serial executors resolve identical calibrated windows.  None keeps
    # the roofline windows (bit-for-bit the uncalibrated behavior).
    profile_path: Optional[str] = None
    # Algorithm-selection policy spec ("fixed" | "auto" | "table:<path>",
    # repro_torch.core.select.get_policy) — a string so the point stays hashable;
    # resolved inside whichever process prices the point, like
    # profile_path.  "fixed" is bit-for-bit the pre-policy behavior.
    policy: str = "fixed"

    def requests(self) -> List[Request]:
        kw = dict(prompt_mean=self.prompt_mean, output_mean=self.output_mean,
                  seed=self.seed)
        if self.arrival == "poisson":
            return poisson_requests(self.n_requests, self.rps, **kw)
        if self.arrival == "bursty":
            return bursty_requests(self.n_requests, self.rps,
                                   burst_size=self.burst_size,
                                   burstiness=self.burstiness, **kw)
        if self.arrival == "trace":
            if not self.trace_path:
                raise ValueError("arrival='trace' needs trace_path")
            return trace_requests(self.trace_path, limit=self.n_requests)
        raise ValueError(f"unknown arrival process {self.arrival!r}")

    def sim_config(self) -> SimConfig:
        pod = self.pod_spec()
        cfg = SimConfig(fabric=pod_fabric(pod),
                        tlb_retention_ns=self.retention_ns,
                        engine=self.engine)
        if self.l2_entries:
            tr = cfg.translation
            cfg = cfg.replace(translation=dataclasses.replace(
                tr, l2=dataclasses.replace(tr.l2, entries=self.l2_entries)))
        if self.pretranslation:
            cfg = cfg.replace(pretranslation=PreTranslationConfig(
                enabled=True, lead_time_ns=3000.0, pages_per_flow=0))
        if self.prefetch:
            cfg = cfg.replace(prefetch=PrefetchConfig(enabled=True, depth=2))
        return cfg

    def pod_spec(self) -> PodSpec:
        return PodSpec(n_gpus=self.n_gpus, topology=self.topology,
                       leaf_size=self.leaf_size,
                       oversubscription=self.oversubscription,
                       pod_size=self.pod_size)

    def load_profile(self):
        """The point's :class:`ComputeProfile`, or ``None``.

        Loaded from ``profile_path`` on demand — torch-free (the profile is
        a JSON cache), and called inside the pool worker so the profile
        object itself never crosses the process boundary.
        """
        if not self.profile_path:
            return None
        from ..workloads.calibrate import ComputeProfile
        return ComputeProfile.load(self.profile_path)


def _traffic_point(task: Tuple[TrafficPoint]) -> TrafficResult:
    (pt,) = task
    return simulate_traffic(pt.arch, pt.requests(), pod=pt.pod_spec(),
                            cfg=pt.sim_config(),
                            max_decode_slots=pt.max_decode_slots,
                            prefill_chunk_tokens=pt.prefill_chunk_tokens,
                            steps_cap=pt.steps_cap,
                            compute_profile=pt.load_profile(),
                            policy=pt.policy)


def fan_out_points(points: Sequence, worker, *,
                   workers: Optional[int] = None) -> Dict:
    """Price hashable sweep points through a module-level ``worker``.

    The shared executor behind :func:`sweep_traffic` and the fleet sweep.
    Mirrors :func:`repro_torch.core.ratsim.sweep`: ``workers=None`` sizes the
    pool to the host, ``workers=0`` forces the serial in-process path, and
    both paths return bit-for-bit identical results — each point's arrival
    stream is regenerated from its seed inside whichever process prices it,
    never shipped across the pool boundary.

    Repeated points are priced **once**: the task list is deduplicated up
    front (a point is its own sweep key, so duplicates are necessarily
    identical work), mirroring ``ratsim.sweep``'s in-flight memoization,
    and the returned mapping still covers every input point — equal points
    are equal keys.
    """
    from ..core.ratsim import _spawnable
    unique: List = []
    seen = set()
    for pt in points:
        if pt not in seen:
            seen.add(pt)
            unique.append(pt)
    tasks = [(pt,) for pt in unique]
    results: List = []
    n_workers = (min(len(tasks), os.cpu_count() or 1)
                 if workers is None else workers)
    if n_workers >= 2 and len(tasks) > 1 and _spawnable():
        try:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(max_workers=n_workers,
                                     mp_context=ctx) as pool:
                results = list(pool.map(worker, tasks))
        except (OSError, BrokenProcessPool):
            results = []
    if not results and tasks:
        results = [worker(t) for t in tasks]
    return dict(zip(unique, results))


def sweep_traffic(points: Sequence[TrafficPoint], *,
                  workers: Optional[int] = None
                  ) -> Dict[TrafficPoint, TrafficResult]:
    """Price every :class:`TrafficPoint`, fanned over a process pool.

    See :func:`fan_out_points` for the executor contract (serial ≡ pooled
    bit-for-bit; duplicate points priced once).
    """
    return fan_out_points(points, _traffic_point, workers=workers)
