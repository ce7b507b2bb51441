"""Persistent-TLB simulation sessions (workload replay, DESIGN.md §8).

The paper's headline result — cold Link-TLB misses cost up to 1.4x on small
collectives while warmed caches erase the overhead — is a statement about
*sequences* of collectives: an inference decode loop fires one small MoE
all-to-all per layer per token, and only the very first invocations pay the
cold-walk tax.  :class:`SimSession` holds one :class:`~repro_torch.core.engine.
EpochEngine` per simulated target GPU (and hence one
:class:`~repro_torch.core.tlb.TranslationState`) across successive collective
invocations, so TLB/PWC warmth carries from call to call exactly as it would
on hardware.  :func:`repro_torch.core.engine.simulate` is a thin wrapper: one
session, ``cfg.iterations`` back-to-back runs.

Sessions support:

* heterogeneous call sequences — each :meth:`run` may override the
  collective pattern, the participating GPU count (a TP subgroup inside the
  pod) and the buffer region (``base_offset``), so model-derived workloads
  (:mod:`repro_torch.workloads`) replay straight through;
* inter-collective idle gaps (:meth:`idle`) that advance the clock; when
  ``SimConfig.tlb_retention_ns`` is set, a gap at least that long flushes
  all cached translations, modelling eviction by competing traffic while
  the pod is quiet;
* per-collective statistics — every :meth:`run` returns a
  :class:`CollectiveResult` carrying its own completion time and counter
  deltas, which is what per-token degradation trajectories are made of.

The request-level oracle mirror is :class:`repro_torch.core.ref_des.RefSession`.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .config import SimConfig
from .engine import (EpochEngine, IterationResult, RunResult,
                     flows_for_dst)
from .engine_vec import (VecEngine, flows_from_specs_multi,
                         rebase_flow_arrays, request_counts,
                         run_step_group)
from .patterns import (get_pattern, simulated_dsts, simulated_dsts_arrays)
from .select import get_policy, session_collective
from .tlb import Counters
from .topology import get_topology

ENGINES = ("event", "vectorized")


def _group_fabric(cfg: SimConfig, collective: Optional[str],
                  n_gpus: Optional[int], rank_stride: int):
    """(name, fab_n, pattern) after the per-call group validation."""
    fab = cfg.fabric
    name = collective if collective is not None else cfg.collective
    fab_n = (fab if n_gpus is None or n_gpus == fab.n_gpus
             else dataclasses.replace(fab, n_gpus=n_gpus))
    if fab_n.n_gpus > fab.n_gpus:
        raise ValueError(
            f"collective group of {fab_n.n_gpus} exceeds pod size "
            f"{fab.n_gpus}")
    if rank_stride < 1:
        raise ValueError(f"rank_stride must be >= 1, got {rank_stride}")
    if (fab_n.n_gpus - 1) * rank_stride + 1 > fab.n_gpus:
        raise ValueError(
            f"strided group ({fab_n.n_gpus} ranks x stride {rank_stride}) "
            f"exceeds pod size {fab.n_gpus}")
    return name, fab_n, get_pattern(name)


def _effective_symmetric(cfg: SimConfig, fab_n, rank_stride: int) -> bool:
    """Whether the single-target shortcut is exact for this placement."""
    symmetric = cfg.symmetric
    topo = get_topology(cfg.fabric)
    if symmetric and not topo.flat:
        # On a tiered fabric the single-target shortcut is only exact when
        # every rank of the group sees the same intra/inter tier mix:
        # the whole group inside one tier-0 block, a stride that makes
        # every pair inter-block, or a contiguous group covering whole
        # blocks.  Anything else (a group straddling a partial block, a
        # misaligned stride) mixes tiers per target — simulate every one.
        block = topo.tier0_group()
        g, s = fab_n.n_gpus, rank_stride
        all_intra = (g - 1) * s + 1 <= block
        uniform = s % block == 0 or (s == 1 and g % block == 0)
        if not (all_intra or uniform):
            symmetric = False
    return symmetric


def resolve_collective(cfg: SimConfig, nbytes: int,
                       collective: Optional[str], n_gpus: Optional[int],
                       rank_stride: int = 1):
    """(name, fab_n, step_specs, dsts) for one session run.

    Single source of truth for per-call pattern/group resolution and
    validation, shared by :class:`SimSession` and
    :class:`~repro_torch.core.ref_des.RefSession` so the two sides of the
    oracle-equivalence contract cannot drift.

    ``rank_stride`` places the group's logical ranks onto pod GPUs
    ``0, stride, 2*stride, ...`` instead of ``0..g-1`` — a data-parallel
    replica group whose members sit one per TP island (rank stride = tp).
    On the flat topology placement is immaterial (any rank labeling is
    isomorphic); on hierarchical topologies it decides which flows cross
    tiers, e.g. a strided gradient ring pays the spine on every hop.
    """
    name, fab_n, pattern = _group_fabric(cfg, collective, n_gpus,
                                         rank_stride)
    step_specs = pattern.steps(nbytes, fab_n)
    if rank_stride > 1:
        step_specs = [
            [dataclasses.replace(s, src=s.src * rank_stride,
                                 dst=s.dst * rank_stride) for s in step]
            for step in step_specs]
    symmetric = _effective_symmetric(cfg, fab_n, rank_stride)
    dsts = simulated_dsts(pattern, step_specs, symmetric, fab_n)
    return name, fab_n, step_specs, dsts


def resolve_collective_arrays(cfg: SimConfig, nbytes: int,
                              collective: Optional[str],
                              n_gpus: Optional[int], rank_stride: int = 1):
    """:func:`resolve_collective` in the columnar :class:`~repro_torch.core.
    patterns.StepArrays` form consumed by the vectorized engine.

    Same validation, same stride placement, same symmetric demotion and the
    same target set — only the schedule representation differs.
    """
    name, fab_n, pattern = _group_fabric(cfg, collective, n_gpus,
                                         rank_stride)
    steps = pattern.steps_arrays(nbytes, fab_n)
    if rank_stride > 1:
        steps = [st.with_stride(rank_stride) for st in steps]
    symmetric = _effective_symmetric(cfg, fab_n, rank_stride)
    dsts = simulated_dsts_arrays(pattern, steps, symmetric, fab_n)
    return name, fab_n, steps, dsts


@dataclass
class CollectiveResult:
    """One collective invocation inside a session."""

    label: str
    collective: str
    nbytes: int
    n_gpus: int
    t_start: float        # absolute session time the collective was issued
    t_end: float          # absolute completion time
    counters: Counters    # counter deltas attributable to this invocation
    # run_iteration calls fully served by the vectorized warm fast path
    # (DESIGN.md §15.2); always 0 on the event engine.
    fastpath_calls: int = 0

    @property
    def completion_ns(self) -> float:
        return self.t_end - self.t_start


@dataclass
class _Plan:
    """Cached per-call geometry of one (collective, size, group, offset).

    ``steps[si]`` holds ``(dst, FlowArrays)`` for every target with flows in
    step ``si``; the ``FlowArrays`` (and the ``_Geom`` they accumulate) are
    reused across calls — only ``t_start`` is reassigned per run.  Cache
    keys and invalidation rules: DESIGN.md §15.1.
    """

    name: str
    fab_n: object
    steps: List[List[tuple]]
    trace_dst: Optional[int]
    base_offset: int
    # Target construction order (the event path's per-call order); sessions
    # adopting a process-cached plan instantiate engines from this.
    dsts: tuple = ()


# Process-wide plan cache (DESIGN.md §15.1).  A plan is a pure function of
# (cfg, call signature) — SimConfig is frozen — so fresh sessions (bench
# reps, fleet replicas, sweep points) reuse one derivation instead of
# re-running resolve/steps_arrays/flow materialization each.  Sharing the
# mutable FlowArrays is safe in-process: the only per-call field, t_start,
# is assigned immediately before the engine consumes it, and sessions run
# sequentially.  Unhashable configs simply skip this layer.
_PLAN_CACHE: Dict[tuple, _Plan] = {}
_PLAN_CACHE_MAX = 8192


class SimSession:
    """Warm-state replay of a sequence of collectives on one pod.

    ``compute_profile`` (a :class:`repro_torch.workloads.calibrate.ComputeProfile`
    or anything with a ``window_ns(phase) -> float | None`` method) makes
    the session resolve phase-tagged inter-collective gaps from measured
    kernel timings instead of the caller-supplied roofline value; ``None``
    (the default) leaves every ``gap_ns`` untouched — bit-for-bit the
    pre-calibration behavior.

    ``policy`` (an :class:`~repro_torch.core.select.AlgorithmPolicy` or a spec
    string — see :func:`~repro_torch.core.select.get_policy`) resolves *logical*
    collective names per call, keyed on whether the call's ``base_offset``
    region has been touched since the last retention flush (cold vs warm
    Link-TLB state); ``None`` keeps the pre-policy behavior: only concrete
    registry names are accepted.
    """

    def __init__(self, cfg: SimConfig, *, compute_profile=None, policy=None):
        if cfg.engine not in ENGINES:
            raise ValueError(
                f"unknown engine {cfg.engine!r}; known: {ENGINES}")
        self.cfg = cfg
        self.compute_profile = compute_profile
        self.policy = get_policy(policy)
        self._warm_regions: set = set()   # base_offsets touched since flush
        self._vec = cfg.engine == "vectorized"
        self.t = 0.0
        self.records: List[CollectiveResult] = []
        self._engines: Dict[int, EpochEngine] = {}
        # Geometry plan cache (vectorized engine only, DESIGN.md §15.1):
        # _plans is keyed on the full call signature; _canonical holds one
        # representative per offset-free signature that other offsets are
        # derived from by (exact) integer address translation.  Entries are
        # pure functions of the config — TLB flushes do NOT invalidate them.
        self._plans: Dict[tuple, _Plan] = {}
        self._canonical: Dict[tuple, _Plan] = {}
        try:
            hash(cfg)
            self._cfg_hashable = True
        except TypeError:
            self._cfg_hashable = False
        # Tracing state (first run() only, mirroring simulate's iteration 0).
        self._trace_dst: Optional[int] = None
        self._flow_sizes: List[int] = []
        # Merged-counters total as of the last run() (see run()).
        self._ctr_cache: Optional[Counters] = None

    # -- clock ---------------------------------------------------------------
    def resolve_gap(self, gap_ns: float, phase: str = "",
                    window_parts=()) -> float:
        """The gap actually applied before a call.

        With a compute profile attached, ``window_parts`` — the
        ``(phase, ns)`` decomposition of the gap (see
        ``CollectiveCall.window_parts``) — is re-resolved part by part, so
        carried multi-sublayer windows calibrate exactly as they would have
        at derive time; a bare ``phase`` resolves a single-window gap; a
        part (or phase) the profile does not know keeps its given ns.
        Without a profile the caller's ``gap_ns`` is returned untouched.
        """
        prof = self.compute_profile
        if prof is None:
            return gap_ns
        if window_parts:
            total = 0.0
            for ph, ns in window_parts:
                w = prof.window_ns(ph) if ph else None
                total += w if w is not None else ns
            return total
        if phase:
            w = prof.window_ns(phase)
            if w is not None:
                return w
        return gap_ns

    def idle(self, gap_ns: float) -> None:
        """Advance the session clock by an inter-collective compute/idle gap.

        With ``cfg.tlb_retention_ns`` set, gaps of at least that length
        flush all cached translations (competing traffic evicts the Link-TLB
        working set); shorter gaps leave warmth intact — the hierarchy has
        no self-decay.
        """
        if gap_ns <= 0:
            return
        self.t += gap_ns
        retention = self.cfg.tlb_retention_ns
        if retention is not None and gap_ns >= retention:
            for eng in self._engines.values():
                eng.state.flush()
            self._warm_regions.clear()

    # -- engines -------------------------------------------------------------
    def _engine(self, dst: int) -> EpochEngine:
        eng = self._engines.get(dst)
        if eng is None:
            cls = VecEngine if self._vec else EpochEngine
            eng = self._engines[dst] = cls(self.cfg, dst=dst)
        return eng

    def _counters_total(self) -> Counters:
        total = Counters()
        for eng in self._engines.values():
            total.merge(eng.state.counters)
        return total

    def _fastpath_total(self) -> int:
        return sum(getattr(eng, "fastpath_calls", 0)
                   for eng in self._engines.values())

    # -- geometry plans (vectorized engine, DESIGN.md §15.1) -----------------
    def _plan_for(self, collective: Optional[str], nbytes: int,
                  n_gpus: Optional[int], rank_stride: int,
                  base_offset: int) -> _Plan:
        """The cached per-step flow geometry for one call signature.

        First resolution of an offset-free signature builds the canonical
        plan (one batched :func:`flows_from_specs_multi` pass per step);
        other ``base_offset`` values clone it by shifting ``base_addr`` —
        an exact integer translation, page-aligned shifts carrying the
        epoch/head geometry cache over (:func:`rebase_flow_arrays`).
        """
        key = (collective, nbytes, n_gpus, rank_stride, base_offset)
        plan = self._plans.get(key)
        if plan is not None:
            return plan
        cfg = self.cfg
        gkey = (cfg,) + key if self._cfg_hashable else None
        if gkey is not None:
            plan = _PLAN_CACHE.get(gkey)
            if plan is not None:
                # Engine (and TLB state) per simulated target exists up
                # front, matching the event path's per-call construction
                # order.
                for d in plan.dsts:
                    self._engine(d)
                self._plans[key] = plan
                return plan
        canon = self._canonical.get(key[:4])
        if canon is None and gkey is not None:
            canon = _PLAN_CACHE.get(gkey[:5])
            if canon is not None:
                self._canonical[key[:4]] = canon
        if canon is None:
            name, fab_n, steps, dsts = resolve_collective_arrays(
                cfg, nbytes, collective, n_gpus, rank_stride)
            groups: List[List[tuple]] = []
            for st in steps:
                fad = flows_from_specs_multi(st, cfg, dsts)
                groups.append([(d, fad[d]) for d in dsts
                               if fad[d] is not None])
            present = {d for grp in groups for d, _ in grp}
            trace_dst = next((d for d in dsts if d in present), None)
            if base_offset:
                for grp in groups:
                    for _, fa in grp:
                        fa.base_addr = fa.base_addr + base_offset
            plan = _Plan(name, fab_n, groups, trace_dst, base_offset,
                         tuple(dsts))
            self._canonical[key[:4]] = plan
            if gkey is not None:
                _PLAN_CACHE[gkey[:5]] = plan
        else:
            delta_addr = base_offset - canon.base_offset
            pb = cfg.translation.page_bytes
            groups = [[(d, rebase_flow_arrays(fa, delta_addr, pb))
                       for d, fa in grp] for grp in canon.steps]
            plan = _Plan(canon.name, canon.fab_n, groups, canon.trace_dst,
                         base_offset, canon.dsts)
        if gkey is not None:
            if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
                _PLAN_CACHE.clear()   # wholesale reset; refill is cheap
            _PLAN_CACHE[gkey] = plan
        for d in plan.dsts:
            self._engine(d)
        self._plans[key] = plan
        return plan

    # -- core ----------------------------------------------------------------
    def run(self, nbytes: int, *, collective: Optional[str] = None,
            n_gpus: Optional[int] = None, rank_stride: int = 1,
            gap_ns: float = 0.0,
            base_offset: int = 0, label: str = "",
            phase: str = "", window_parts=()) -> CollectiveResult:
        """Replay one collective starting at the current session time.

        ``collective``/``n_gpus`` override the session defaults per call
        (e.g. a TP all-gather over an 8-GPU subgroup inside a 64-GPU pod);
        ``rank_stride`` places the group on strided pod ranks (a DP replica
        ring spanning TP islands — see :func:`resolve_collective`);
        ``base_offset`` shifts the collective's buffer region inside each
        target's NPA space so distinct logical buffers touch distinct pages;
        ``gap_ns`` is a compute/idle window inserted *before* the collective
        (see :meth:`idle`), re-resolved from the session's compute profile
        when ``phase`` names a calibrated phase (:meth:`resolve_gap`).
        """
        cfg = self.cfg
        fab = cfg.fabric
        gap_ns = self.resolve_gap(gap_ns, phase, window_parts)
        if gap_ns:
            self.idle(gap_ns)
        # Policy resolution after the idle: a gap long enough to flush the
        # TLBs demotes this region to cold before the algorithm is chosen.
        collective = session_collective(
            self.policy, cfg, nbytes, collective, n_gpus,
            warm=base_offset in self._warm_regions)
        self._warm_regions.add(base_offset)

        # Trace only the first collective of the session (simulate's
        # iteration-0 semantics), on the first target that actually
        # produces flows — a symmetric-demoted group's dsts[0] may see
        # only zero-byte specs.
        collect = cfg.collect_trace and not self.records
        # Engine counters mutate only inside run(); the previous call's
        # "after" total is this call's "before" (engines created since hold
        # zeroed counters, and merging zeros is an exact float no-op), so
        # one full merge per call suffices.
        before = self._ctr_cache
        if before is None:
            before = self._counters_total()
        fp_before = self._fastpath_total()
        rb = fab.request_bytes
        t0 = self.t
        t = t0
        if self._vec:
            plan = self._plan_for(collective, nbytes, n_gpus, rank_stride,
                                  base_offset)
            name, fab_n = plan.name, plan.fab_n
            if collect:
                self._trace_dst = plan.trace_dst
            engines = self._engines
            if collect:
                for si, grp in enumerate(plan.steps):
                    comp = t
                    first = si == 0
                    for d, fa in grp:
                        fa.t_start = t
                        trace_this = d == self._trace_dst
                        fi_base = len(self._flow_sizes)
                        if trace_this:
                            self._flow_sizes.extend(request_counts(fa, rb))
                        comp = max(comp, engines[d].run_iteration(
                            fa, trace_this, fi_base=fi_base,
                            first_step=first))
                    t = comp
            else:
                # Hot path: one grouped invocation per step barrier
                # (DESIGN.md §15).
                for si, grp in enumerate(plan.steps):
                    t = run_step_group(engines, grp, t, si == 0)
        else:
            name, fab_n, step_specs, dsts = resolve_collective(
                cfg, nbytes, collective, n_gpus, rank_stride)
            if collect:
                self._trace_dst = next(
                    (d for d in dsts
                     if any(s.dst == d and s.nbytes > 0
                            for step in step_specs for s in step)), None)
            for si, specs in enumerate(step_specs):
                comp = t
                for d in dsts:
                    eng = self._engine(d)
                    flows = flows_for_dst(specs, cfg, d, t_start=t)
                    if base_offset:
                        for f in flows:
                            f.base_addr += base_offset
                    if not flows:
                        continue
                    trace_this = collect and d == self._trace_dst
                    fi_base = len(self._flow_sizes)
                    if trace_this:
                        self._flow_sizes.extend(
                            max(1, math.ceil(f.nbytes / rb)) for f in flows)
                    comp = max(comp, eng.run_iteration(
                        flows, trace_this, fi_base=fi_base,
                        first_step=si == 0))
                t = comp
        self.t = t

        after = self._counters_total()
        self._ctr_cache = after
        rec = CollectiveResult(
            label=label or name, collective=name, nbytes=nbytes,
            n_gpus=fab_n.n_gpus, t_start=t0, t_end=t,
            counters=after.delta(before),
            fastpath_calls=self._fastpath_total() - fp_before)
        self.records.append(rec)
        return rec

    # -- aggregation ---------------------------------------------------------
    def result(self, collective_bytes: Optional[int] = None) -> RunResult:
        """Aggregate the session so far as a :class:`RunResult`.

        Non-destructive: the session can keep running afterwards.  One
        :class:`IterationResult` per collective invocation, counters merged
        over every simulated target, trace (if collected) for the first
        invocation's representative target.
        """
        cfg = self.cfg
        ctr = self._counters_total()

        trace = None
        bounds = None
        if cfg.collect_trace:
            bounds = [0]
            for sz in self._flow_sizes:
                bounds.append(bounds[-1] + sz)
            trace = np.zeros(bounds[-1])
            if self._trace_dst is not None:
                for (fi, i0, arr) in self._engines[self._trace_dst].trace_chunks:
                    trace[bounds[fi] + i0: bounds[fi] + i0 + len(arr)] = arr

        stall_total = sum(e.stall_sum for e in self._engines.values())
        nbytes = (collective_bytes if collective_bytes is not None
                  else (self.records[0].nbytes if self.records else 0))
        return RunResult(
            iterations=[IterationResult(completion_ns=r.completion_ns)
                        for r in self.records],
            counters=ctr, config=cfg, collective_bytes=nbytes,
            trace=trace, trace_flow_bounds=bounds,
            mean_stall_ns=stall_total / (ctr.requests or 1),
            fastpath_calls=self._fastpath_total())
