"""Page-epoch simulation engine for collectives over a UALink pod.

Collective schedules (the all-pairs AllToAll of the paper, plus the ring /
recursive-doubling / tree patterns of :mod:`repro_torch.core.patterns`) are
deterministic streaming traffic: in each dependency step every source GPU
concurrently streams chunks to its step peers, requests stripe round-robin
across the 16 UALink stations, and each (flow, page) forms an *epoch* whose
internal request timing is closed-form.  The engine therefore schedules only
epoch-level events — O(flows x pages) of them — and expands per-request
statistics analytically, which is exact for these workloads (see DESIGN.md
§3) and scales to the paper's 4 GB x 64 GPU sweeps in pure Python.

Backpressure model: each target station has a finite ingress buffer
(``FabricConfig.ingress_entries``).  Requests occupy a slot from arrival until
their translation resolves; a page walk that outlasts the buffer stalls the
whole port via credit backpressure, which is what couples Reverse Address
Translation latency into end-to-end collective time (paper Fig. 4).  Stall
windows of concurrent walks on one station are shared, not summed.

A request-level reference DES (:mod:`repro_torch.core.ref_des`) implements the same
physics request-by-request and is used by the test suite to validate this
engine at small collective sizes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import SimConfig
from .patterns import FlowSpec
from .tlb import TranslationState, Counters, L1_HIT, L1_HUM, INF
from .topology import get_topology


@dataclass
class Flow:
    """One (source -> target) stream of the all-pairs schedule."""

    src: int
    dst: int
    base_addr: int      # NPA of the region this flow writes at the target
    nbytes: int
    t_start: float      # issue time of request 0 at the source CU
    delta_ns: float     # request inter-issue spacing (per-flow BW share)
    stripe: int         # station offset for round-robin striping
    oneway_ns: float = 0.0  # source CU -> target station (topology path)
    return_ns: float = 0.0  # target -> source ack (topology path)


@dataclass
class IterationResult:
    completion_ns: float
    ideal_completion_ns: Optional[float] = None
    counters: Optional[Counters] = None

    @property
    def degradation(self) -> float:
        return (self.completion_ns / self.ideal_completion_ns
                if self.ideal_completion_ns else float("nan"))


@dataclass
class RunResult:
    """Output of one simulation run (possibly several iterations)."""

    iterations: List[IterationResult]
    counters: Counters
    config: SimConfig
    collective_bytes: int
    # Per-request RAT latency trace (ns), ordered by (flow, request index),
    # only populated when cfg.collect_trace.
    trace: Optional[np.ndarray] = None
    trace_flow_bounds: Optional[List[int]] = None
    mean_stall_ns: float = 0.0
    # run_iteration calls fully served by the vectorized warm fast path
    # (DESIGN.md §15.2); always 0 on the event engine.
    fastpath_calls: int = 0

    @property
    def completion_ns(self) -> float:
        return self.iterations[0].completion_ns

    @property
    def total_ns(self) -> float:
        return sum(it.completion_ns for it in self.iterations)

    @property
    def mean_rat_ns(self) -> float:
        return self.counters.mean_rat_ns

    def breakdown(self) -> Dict[str, float]:
        """Mean round-trip latency components per request (paper Fig. 6).

        Fabric components are the tier-0 (intra-tier) path latencies; on
        hierarchical topologies flows crossing upper tiers pay more (see
        ``Flow.oneway_ns``/``return_ns``), which shows up in completion
        time rather than in this per-request decomposition.
        """
        fab = self.config.fabric
        return {
            "oneway_ns": fab.oneway_ns,
            "rat_ns": self.counters.mean_rat_ns,
            "stall_ns": self.mean_stall_ns,
            "hbm_ns": fab.hbm_ns,
            "return_ns": fab.return_ns,
        }


def flows_for_dst(specs: List[FlowSpec], cfg: SimConfig, dst: int,
                  t_start: float) -> List[Flow]:
    """Materialize one step's :class:`FlowSpec` set as flows at ``dst``.

    Per-flow bandwidth share: a source's concurrent outgoing flows of the
    step split its station pool evenly, so the inter-request spacing is
    ``request_bytes * out_degree / gpu_bw`` (the all-pairs ``n - 1`` case of
    the seed engine generalized to arbitrary step out-degrees).  On
    hierarchical topologies a flow crossing a capacity-limited tier is
    additionally paced by its share of *that tier's* per-source capacity —
    a source's flows crossing an oversubscribed uplink split the uplink,
    not the flat station pool — and each flow carries the topology's
    per-path request/ack latencies (DESIGN.md §10).
    """
    fab = cfg.fabric
    topo = get_topology(fab)
    flat = topo.flat
    out_deg: Dict[int, int] = {}
    tier_deg: Dict[Tuple[int, int], int] = {}
    for s in specs:
        out_deg[s.src] = out_deg.get(s.src, 0) + 1
        if not flat:
            k = (s.src, topo.tier(s.src, s.dst))
            tier_deg[k] = tier_deg.get(k, 0) + 1
    dst_base = (dst + 1) << 42  # distinct 4 TB NPA region per target GPU
    oneway = fab.oneway_ns
    ret = fab.return_ns
    flows = []
    for s in specs:
        if s.dst != dst or s.nbytes <= 0:
            continue
        delta = fab.request_bytes * out_deg[s.src] / fab.gpu_bw
        if not flat:
            tier = topo.tier(s.src, dst)
            cap = topo.tier_capacity(tier)
            if cap is not None:
                shaped = fab.request_bytes * tier_deg[(s.src, tier)] / cap
                if shaped > delta:
                    delta = shaped
            oneway = topo.path_latency_ns(s.src, dst)
            ret = topo.return_latency_ns(dst, s.src)
        flows.append(Flow(
            src=s.src, dst=dst,
            base_addr=dst_base + s.offset,
            nbytes=s.nbytes,
            t_start=t_start,
            delta_ns=delta,
            stripe=s.src % fab.stations_per_gpu,
            oneway_ns=oneway,
            return_ns=ret,
        ))
    return flows


def epoch_spans(flows: List[Flow], rb: int, page_bytes: int):
    """(first_arrival, flow_idx, page, i0, i1) spans, sorted by arrival.

    One span per (flow, page): requests ``i0..i1-1`` of flow ``flow_idx``
    touch ``page``.  Arrivals use each flow's own topology path latency
    (``Flow.oneway_ns``).  Shared by the epoch engine and the reference
    DES's probe-schedule construction so both issue identical prefetch
    probes.
    """
    eps = []
    for fi, f in enumerate(flows):
        n_req = max(1, math.ceil(f.nbytes / rb))
        a0 = f.t_start + f.oneway_ns
        first_page = f.base_addr // page_bytes
        last_page = (f.base_addr + f.nbytes - 1) // page_bytes
        for page in range(first_page, last_page + 1):
            lo = max(f.base_addr, page * page_bytes)
            hi = min(f.base_addr + f.nbytes, (page + 1) * page_bytes)
            i0 = (lo - f.base_addr) // rb
            i1 = min(n_req, math.ceil((hi - f.base_addr) / rb))
            if i1 <= i0:
                continue
            eps.append((a0 + i0 * f.delta_ns, fi, page, i0, i1))
    eps.sort()
    return eps


def probe_station(f: Flow, page: int, page_bytes: int, rb: int,
                  ns: int) -> int:
    """Station where ``page``'s first real request of flow ``f`` lands.

    Request ``i`` of a flow stripes to station ``(i + f.stripe) % ns``; the
    first request touching ``page`` has index ``i0 = (lo - base) // rb``
    (``lo`` = first byte of the page inside the flow's range).  Translation
    probes must target exactly this station so they warm the L1 that the
    page's first data request will actually query.
    """
    lo = max(f.base_addr, page * page_bytes)
    i0 = (lo - f.base_addr) // rb
    return (i0 + f.stripe) % ns


def pretranslate_probes(flows: List[Flow], cfg: SimConfig):
    """Yield (t, station, page) pre-translation probes for one collective.

    Paper §6.1: probes issue during the preceding compute window, starting
    ``lead_time_ns`` before the collective, paced every
    ``probe_issue_interval_ns``, warming the first ``pages_per_flow`` pages
    of every flow (0 => all).  Single source of truth for the engine and
    the reference DES, so oracle-equivalence holds by construction.
    """
    pre = cfg.pretranslation
    fab = cfg.fabric
    ns = fab.stations_per_gpu
    rb = fab.request_bytes
    page_bytes = cfg.translation.page_bytes
    if not flows:
        return
    t = flows[0].t_start - pre.lead_time_ns
    k = 0
    for f in flows:
        first_page = f.base_addr // page_bytes
        last_page = (f.base_addr + f.nbytes - 1) // page_bytes
        n_pages = last_page - first_page + 1
        limit = n_pages if pre.pages_per_flow <= 0 else min(
            n_pages, pre.pages_per_flow)
        for j in range(limit):
            page = first_page + j
            yield (t + k * pre.probe_issue_interval_ns,
                   probe_station(f, page, page_bytes, rb, ns), page)
            k += 1


@dataclass
class _Station:
    """Per-station ingress bookkeeping for the backpressure model."""

    skew: float = 0.0          # accumulated ingress stall (sigma)
    release: float = -INF      # end of the currently-covered stall window
    consumed: int = 0          # requests processed so far (for buffer gating)
    total: int = 0             # total requests this iteration


class EpochEngine:
    """Simulates one target GPU of the pod (exact under all-pairs symmetry)."""

    def __init__(self, cfg: SimConfig, dst: int = 0):
        self.cfg = cfg
        self.dst = dst
        fab = cfg.fabric
        self.state = TranslationState(cfg.translation, fab.stations_per_gpu)
        self.stations = [_Station() for _ in range(fab.stations_per_gpu)]
        self.page_bytes = cfg.translation.page_bytes
        self.svc = fab.request_bytes / fab.station_bw  # station service time
        self.buffer_cover = fab.ingress_entries * self.svc
        self.trace_chunks: List[Tuple[int, int, np.ndarray]] = []
        self.stall_sum = 0.0
        self.stall_n = 0

    # -- epoch construction --------------------------------------------------
    def _epochs(self, flows: List[Flow]):
        """Yield (first_arrival, flow_idx, page, i0, i1) sorted by time."""
        fab = self.cfg.fabric
        return epoch_spans(flows, fab.request_bytes, self.page_bytes)

    # -- core ----------------------------------------------------------------
    def run_iteration(self, flows: List[Flow], collect_trace: bool,
                      fi_base: int = 0, first_step: bool = True) -> float:
        """Simulate one step's flow set; returns absolute completion time.

        Called once per collective step (and per iteration); translation
        state persists across calls (TLBs stay warm), station ingress
        bookkeeping resets — each step's stream starts from an empty port,
        matching the reference DES (DESIGN.md §5.2).  ``fi_base`` offsets
        trace flow indices when a run spans several steps; ``first_step``
        marks the first step of an iteration — pre-translation probes fire
        only there, since mid-collective steps are back-to-back barriers
        with no compute window to hide probes in.
        """
        cfg = self.cfg
        fab = cfg.fabric
        rb = fab.request_bytes
        ns = fab.stations_per_gpu
        l1_lat = cfg.translation.l1.hit_latency_ns if cfg.translation.enabled else 0.0
        ctr = self.state.counters
        completion = 0.0

        pre = cfg.pretranslation
        if pre.enabled and cfg.translation.enabled and first_step:
            self._pretranslate(flows)

        epochs = self._epochs(flows)
        # Per-station request totals (for ingress-buffer occupancy gating).
        for st in self.stations:
            st.skew = 0.0
            st.release = -INF
            st.consumed = 0
            st.total = 0
        for f in flows:
            n_req = max(1, math.ceil(f.nbytes / rb))
            base, extra = divmod(n_req, ns)
            for s_off in range(ns):
                station = (s_off + f.stripe) % ns
                self.stations[station].total += base + (1 if s_off < extra else 0)

        for (t_first, fi, page, i0, i1) in epochs:
            f = flows[fi]
            d = f.delta_ns
            a0 = f.t_start + f.oneway_ns

            # Software prefetch (paper §6.2): as this page's stream begins,
            # request translation of the next page(s) of this flow's region.
            if cfg.prefetch.enabled and cfg.translation.enabled:
                self._prefetch(f, page, t_first)

            trace = (np.empty(i1 - i0) if collect_trace else None)

            # Per-station sub-series of this epoch's requests.
            for s_off in range(min(ns, i1 - i0)):
                i_s0 = i0 + s_off
                station = (i_s0 + f.stripe) % ns
                n_s = (i1 - i_s0 + ns - 1) // ns  # requests on this station
                st = self.stations[station]
                t0 = a0 + i_s0 * d + st.skew     # effective head arrival
                res = self.state.access(station, page, t0)
                rat0 = res.resolve - t0
                ctr.add_request(res.klass, rat0)
                ctr.note_max(rat0)
                last_resolve = res.resolve

                # Ingress-buffer backpressure: a translation wait longer than
                # the buffer cover stalls the port (UALink credit flow
                # control).  Only applies when enough requests remain to fill
                # the buffer; overlapping walks share the stall window via
                # `release`, and the stall persists (ingress runs at exactly
                # link rate in all-pairs steady state, so there is no slack
                # to re-absorb the bubble).
                wait = res.resolve - (t0 + l1_lat)
                if (wait > 0 and cfg.translation.enabled
                        and st.total - st.consumed >= fab.ingress_entries):
                    block_from = max(t0 + self.buffer_cover, st.release)
                    if res.resolve > block_from:
                        bubble = res.resolve - block_from
                        st.skew += bubble
                        st.release = res.resolve
                        self.stall_sum += bubble
                        self.stall_n += 1
                st.consumed += n_s

                if collect_trace:
                    trace[i_s0 - i0] = rat0

                if n_s > 1:
                    # Tail: arrivals a_k = t0 + k*stride (k=1..n_s-1), with
                    # the skew accrued so far (constant within an epoch).
                    stride = ns * d
                    fill = res.l1_fill
                    # Requests with a_k + l1_lat < fill stall until the fill
                    # (MSHR hit-under-miss); the rest are plain L1 hits.
                    # #{k >= 1 : k < (fill - l1_lat - t0)/stride}
                    if fill > -INF:
                        x = (fill - l1_lat - t0) / stride
                        k_hum = max(0, min(n_s - 1, math.ceil(x) - 1))
                    else:
                        k_hum = 0
                    if k_hum > 0:
                        # sum over k=1..k_hum of (fill - a_k)
                        hum_sum = (k_hum * (fill - t0)
                                   - stride * k_hum * (k_hum + 1) / 2)
                        ctr.add_request(L1_HUM, hum_sum, n=k_hum)
                        ctr.note_max(fill - (t0 + stride))
                        last_resolve = max(last_resolve, fill)
                    n_hit = n_s - 1 - k_hum
                    if n_hit > 0:
                        ctr.add_request(L1_HIT, n_hit * l1_lat, n=n_hit)
                        last_resolve = max(
                            last_resolve,
                            t0 + (n_s - 1) * stride + l1_lat)
                    if collect_trace:
                        ks = np.arange(1, n_s)
                        arr = t0 + ks * stride
                        lat = np.maximum(arr + l1_lat,
                                         fill if fill > -INF else 0.0) - arr
                        trace[i_s0 - i0 + ks * ns] = np.maximum(lat, l1_lat)

                done = last_resolve + fab.hbm_ns + f.return_ns
                if done > completion:
                    completion = done

            if collect_trace:
                self.trace_chunks.append((fi_base + fi, i0, trace))

        return completion

    # -- optimizations ---------------------------------------------------------
    def _pretranslate(self, flows: List[Flow]) -> None:
        """Paper §6.1: fused pre-translation during the preceding compute.

        Probes target the station where each page's *first data request*
        will land (:func:`probe_station`), so the probe warms exactly the L1
        that request queries.
        """
        for (t, st, page) in pretranslate_probes(flows, self.cfg):
            self.state.access(st, page, t, is_probe=True)
            self.state.counters.probes += 1

    def _prefetch(self, f: Flow, page: int, t: float) -> None:
        """Paper §6.2: software-guided next-page TLB prefetch."""
        fab = self.cfg.fabric
        ns = fab.stations_per_gpu
        last_page = (f.base_addr + f.nbytes - 1) // self.page_bytes
        for j in range(1, self.cfg.prefetch.depth + 1):
            p = page + j
            if p > last_page:
                break
            st = probe_station(f, p, self.page_bytes, fab.request_bytes, ns)
            self.state.access(st, p, t, is_probe=True)
            self.state.counters.probes += 1


def simulate(nbytes: int, cfg: SimConfig) -> RunResult:
    """Simulate ``cfg.collective`` of ``nbytes`` per GPU under ``cfg``.

    Thin wrapper over :class:`repro_torch.core.session.SimSession`: one session is
    created, ``cfg.iterations`` back-to-back invocations of the collective
    are replayed through it (translation state stays warm across
    iterations, exactly as the pre-session engine behaved), and the
    aggregate is returned.  The pattern layer supplies per-step flow sets;
    steps are dependency barriers (step k+1's flows start at step k's
    completion).  Symmetric patterns simulate one representative target
    (exact — every GPU is loaded identically); asymmetric ones (broadcast)
    simulate every receiving target regardless of ``cfg.symmetric``.
    """
    from .session import SimSession  # local import: session builds on engine

    sess = SimSession(cfg)
    for _ in range(cfg.iterations):
        sess.run(nbytes)
    return sess.result(collective_bytes=nbytes)
