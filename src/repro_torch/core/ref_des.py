"""Request-level reference DES for the RAT simulator (the oracle).

Simulates every individual request through the same
:class:`~repro_torch.core.tlb.TranslationState` machinery as the page-epoch engine,
but with explicit per-station in-order FIFOs and slot-accurate ingress
buffering instead of closed-form epoch expansion.  Replays exactly the flow
sets the pattern layer (:mod:`repro_torch.core.patterns`) emits — one station-queue
episode per collective step, barriered on the previous step's completion —
and, when the latency-hiding optimizations are enabled, issues the *same*
pre-translation / prefetch probe schedule the engine issues (built from the
shared :func:`~repro_torch.core.engine.epoch_spans` /
:func:`~repro_torch.core.engine.probe_station` helpers), so oracle-equivalence
tests bind for the optimization paths too.

:class:`RefSession` mirrors :class:`repro_torch.core.session.SimSession` — a
persistent-TLB session replaying a sequence of collectives — and
:func:`simulate_ref` is the single-collective wrapper over it.  Too slow for
the paper's 4 GB sweeps (that is the point of the epoch engine).
"""
from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import SimConfig
from .engine import (Flow, IterationResult, RunResult, epoch_spans,
                     flows_for_dst, pretranslate_probes, probe_station)
from .select import get_policy, session_collective
from .session import CollectiveResult, resolve_collective
from .tlb import Counters, TranslationState


class _StationQueue:
    """In-order ingress FIFO of one target station with B buffer slots.

    Requests are admitted in arrival order; each occupies a slot from
    admission until its translation resolves (slots can free out of order —
    MSHR hit-under-miss requests outlast younger already-translated ones)."""

    def __init__(self, entries: int, svc_ns: float):
        self.entries = entries
        self.svc = svc_ns             # link-rate service spacing of the port
        self.reqs: List[tuple] = []   # (nominal_arrival, flow_idx, page, req_idx)
        self.ptr = 0
        self.prev_adm = -float("inf")
        self.retires: List[float] = []  # min-heap of outstanding retire times

    def push(self, item):
        self.reqs.append(item)

    def sort(self):
        self.reqs.sort()

    def next_candidate(self) -> Optional[float]:
        if self.ptr >= len(self.reqs):
            return None
        nom = self.reqs[self.ptr][0]
        # Ingress delivers at most one request per svc (the port's line rate),
        # so a stall can never be re-absorbed by over-rate draining.
        adm = max(nom, self.prev_adm + self.svc)
        if len(self.retires) >= self.entries:
            adm = max(adm, self.retires[0])
        return adm

    def admit(self, adm: float, retire: float):
        self.ptr += 1
        self.prev_adm = adm
        while self.retires and self.retires[0] <= adm:
            heapq.heappop(self.retires)
        heapq.heappush(self.retires, retire)


def _probe_schedule(flows: List[Flow], cfg: SimConfig,
                    first_step: bool) -> List[Tuple[float, int, int]]:
    """(t, station, page) probes for one step, identical to the engine's.

    Pre-translation probes (paper §6.1) fire only on the first step of a
    collective, during the preceding compute window; prefetch probes (§6.2)
    fire at each page-epoch's first arrival for the following ``depth``
    pages.  Stations are aligned to each page's first data request
    (:func:`probe_station`).
    """
    fab = cfg.fabric
    ns = fab.stations_per_gpu
    rb = fab.request_bytes
    page_bytes = cfg.translation.page_bytes
    probes: List[Tuple[float, int, int]] = []
    if not cfg.translation.enabled:
        return probes

    if cfg.pretranslation.enabled and first_step:
        probes.extend(pretranslate_probes(flows, cfg))

    if cfg.prefetch.enabled:
        for (t_first, fi, page, _i0, _i1) in epoch_spans(
                flows, rb, page_bytes):
            f = flows[fi]
            last_page = (f.base_addr + f.nbytes - 1) // page_bytes
            for j in range(1, cfg.prefetch.depth + 1):
                p = page + j
                if p > last_page:
                    break
                probes.append((t_first,
                               probe_station(f, p, page_bytes, rb, ns), p))

    probes.sort()
    return probes


class _RefTarget:
    """One target GPU's DES state (translation persists across steps)."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.state = TranslationState(cfg.translation,
                                      cfg.fabric.stations_per_gpu)
        self.stall_sum = 0.0

    def run_step(self, flows: List[Flow], first_step: bool,
                 trace: Optional[np.ndarray],
                 bounds: Optional[List[int]], fi_base: int) -> float:
        """Replay one step's flows request-by-request; returns completion.

        Fresh station queues per step: the previous step's translations all
        resolved before its completion barrier, so every ingress slot is
        free again by the time the next step's head requests arrive.
        """
        cfg = self.cfg
        fab = cfg.fabric
        rb = fab.request_bytes
        ns = fab.stations_per_gpu
        page_bytes = cfg.translation.page_bytes
        svc = rb / fab.station_bw
        stations = [_StationQueue(fab.ingress_entries, svc)
                    for _ in range(ns)]
        state = self.state

        probes = _probe_schedule(flows, cfg, first_step)
        pi = 0

        for fi, f in enumerate(flows):
            n_req = max(1, math.ceil(f.nbytes / rb))
            a0 = f.t_start + f.oneway_ns
            for i in range(n_req):
                st = (i + f.stripe) % ns
                page = (f.base_addr + i * rb) // page_bytes
                stations[st].push((a0 + i * f.delta_ns, fi, page, i))
        for st in stations:
            st.sort()

        # Global event loop in admission-time order (translation state must
        # observe accesses in non-decreasing time).  Probes interleave by
        # issue time: every probe at or before the next admission fires
        # first, exactly as the engine issues them ahead of the stream.
        heap = []
        for si, st in enumerate(stations):
            c = st.next_candidate()
            if c is not None:
                heapq.heappush(heap, (c, si))
        completion = 0.0
        while heap:
            adm, si = heapq.heappop(heap)
            st = stations[si]
            cur = st.next_candidate()
            if cur is None:
                continue
            if cur > adm + 1e-9:
                heapq.heappush(heap, (cur, si))  # stale entry; re-key
                continue
            while pi < len(probes) and probes[pi][0] <= cur:
                pt, pst, ppage = probes[pi]
                state.access(pst, ppage, pt, is_probe=True)
                state.counters.probes += 1
                pi += 1
            nom, fi, page, i = st.reqs[st.ptr]
            res = state.access(si, page, cur)
            state.counters.add_request(res.klass, res.resolve - cur)
            state.counters.note_max(res.resolve - cur)
            self.stall_sum += max(0.0, cur - nom)
            if trace is not None:
                trace[bounds[fi_base + fi] + i] = res.resolve - cur
            st.admit(cur, res.resolve)
            done = res.resolve + fab.hbm_ns + flows[fi].return_ns
            completion = max(completion, done)
            c = st.next_candidate()
            if c is not None:
                heapq.heappush(heap, (c, si))
        # Probes scheduled beyond the last admission still fire (they warm
        # state for subsequent steps/collectives of the session).
        while pi < len(probes):
            pt, pst, ppage = probes[pi]
            state.access(pst, ppage, pt, is_probe=True)
            state.counters.probes += 1
            pi += 1
        return completion


class RefSession:
    """Oracle mirror of :class:`repro_torch.core.session.SimSession`.

    Same public surface (``run`` / ``idle`` / ``result`` / ``records``),
    request-level physics — including per-call ``policy`` resolution with
    the same cold/warm region keying (via the shared
    :func:`~repro_torch.core.select.session_collective`), so the
    oracle-equivalence contract extends to policy-chosen algorithms.
    Session-equivalence tests replay identical call sequences through both
    and compare.
    """

    def __init__(self, cfg: SimConfig, *, policy=None):
        self.cfg = cfg
        self.policy = get_policy(policy)
        self._warm_regions: set = set()
        self.t = 0.0
        self.records: List[CollectiveResult] = []
        self._targets: Dict[int, _RefTarget] = {}
        self._trace: Optional[np.ndarray] = None
        self._bounds: Optional[List[int]] = None

    def idle(self, gap_ns: float) -> None:
        if gap_ns <= 0:
            return
        self.t += gap_ns
        retention = self.cfg.tlb_retention_ns
        if retention is not None and gap_ns >= retention:
            for tg in self._targets.values():
                tg.state.flush()
            self._warm_regions.clear()

    def _target(self, dst: int) -> _RefTarget:
        tg = self._targets.get(dst)
        if tg is None:
            tg = self._targets[dst] = _RefTarget(self.cfg)
        return tg

    def _counters_total(self) -> Counters:
        total = Counters()
        for tg in self._targets.values():
            total.merge(tg.state.counters)
        return total

    def run(self, nbytes: int, *, collective: Optional[str] = None,
            n_gpus: Optional[int] = None, rank_stride: int = 1,
            gap_ns: float = 0.0,
            base_offset: int = 0, label: str = "") -> CollectiveResult:
        cfg = self.cfg
        fab = cfg.fabric
        if gap_ns:
            self.idle(gap_ns)
        collective = session_collective(
            self.policy, cfg, nbytes, collective, n_gpus,
            warm=base_offset in self._warm_regions)
        self._warm_regions.add(base_offset)
        name, fab_n, step_specs, dsts = resolve_collective(
            cfg, nbytes, collective, n_gpus, rank_stride)
        rb = fab.request_bytes

        # Trace only the first collective of the session, representative
        # target, same rule as the engine session.
        collect = cfg.collect_trace and not self.records
        step_nflows: List[int] = []
        if collect:
            self._bounds = [0]
            for specs in step_specs:
                flows = flows_for_dst(specs, cfg, dsts[0], 0.0)
                step_nflows.append(len(flows))
                for f in flows:
                    self._bounds.append(
                        self._bounds[-1] + max(1, math.ceil(f.nbytes / rb)))
            self._trace = np.zeros(self._bounds[-1])

        before = self._counters_total()
        t0 = self.t
        t = t0
        fi_base = 0
        for si, specs in enumerate(step_specs):
            comp = t
            for d in dsts:
                flows = flows_for_dst(specs, cfg, d, t_start=t)
                if base_offset:
                    for f in flows:
                        f.base_addr += base_offset
                if not flows:
                    continue
                trace_this = collect and d == dsts[0]
                comp = max(comp, self._target(d).run_step(
                    flows, si == 0,
                    self._trace if trace_this else None,
                    self._bounds, fi_base))
            t = comp
            if collect:
                fi_base += step_nflows[si]
        self.t = t

        rec = CollectiveResult(
            label=label or name, collective=name, nbytes=nbytes,
            n_gpus=fab_n.n_gpus, t_start=t0, t_end=t,
            counters=self._counters_total().delta(before))
        self.records.append(rec)
        return rec

    def result(self, collective_bytes: Optional[int] = None) -> RunResult:
        ctr = self._counters_total()
        stall_sum = sum(tg.stall_sum for tg in self._targets.values())
        nbytes = (collective_bytes if collective_bytes is not None
                  else (self.records[0].nbytes if self.records else 0))
        return RunResult(
            iterations=[IterationResult(completion_ns=r.completion_ns)
                        for r in self.records],
            counters=ctr, config=self.cfg, collective_bytes=nbytes,
            trace=self._trace, trace_flow_bounds=self._bounds,
            mean_stall_ns=stall_sum / max(1, ctr.requests))


def simulate_ref(nbytes: int, cfg: SimConfig) -> RunResult:
    """Oracle simulation of ``cfg.collective`` (same flow sets as the engine)."""
    sess = RefSession(cfg)
    for _ in range(cfg.iterations):
        sess.run(nbytes)
    return sess.result(collective_bytes=nbytes)
