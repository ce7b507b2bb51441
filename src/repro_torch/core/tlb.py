"""Reverse Address Translation hierarchy model (target-GPU side).

Implements the paper's baseline hierarchy (Fig. 3): per-station L1 Link TLBs
with MSHRs -> shared L2 Link TLB (with its own pending-walk coalescing) ->
page-walk caches -> shared pool of parallel page-table walkers.  Fill policy
is mostly-inclusive: a completed walk populates both the L2 and the
requesting station's L1; L2 evictions do not back-invalidate L1s.

The model is event-free: callers (the page-epoch engine and the request-level
reference DES) invoke :meth:`TranslationState.access` in non-decreasing time
order and the state machine returns the translation-resolve time plus the
classification used for the paper's Fig. 7/8 breakdowns.  Determinism of the
streaming workloads makes this exact: arrival times never depend on
translation outcomes (the fabric model is latency-additive; see DESIGN.md §2).
"""
from __future__ import annotations

import heapq
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Tuple

from .config import TranslationConfig

INF = float("inf")

# Request classification (paper Figs. 7 and 8).
L1_HIT = "l1_hit"
L1_HUM = "l1_mshr_hum"      # hit-under-miss in the station's MSHR
L2_HIT = "l2_hit"
L2_HUM = "l2_hum"           # pending walk already launched by another station
WALK = "walk"               # L2 miss -> page walk (PWC hits may shorten it)
CLASSES = (L1_HIT, L1_HUM, L2_HIT, L2_HUM, WALK)


class LRUCache:
    """Set-associative (or fully-associative) LRU cache of hashable keys.

    Fills are committed lazily: :meth:`fill` records (key, fill_time) and a
    later :meth:`lookup` at ``t >= fill_time`` observes the entry.  This lets
    callers process accesses in arrival order while fills complete in the
    future.
    """

    def __init__(self, entries: int, assoc: int):
        self.entries = entries
        self.assoc = assoc if assoc > 0 else entries
        self.n_sets = max(1, entries // self.assoc)
        self._sets = [OrderedDict() for _ in range(self.n_sets)]
        self._staged: Dict[object, float] = {}

    def _set_for(self, key) -> OrderedDict:
        return self._sets[hash(key) % self.n_sets]

    def _commit(self, t: float) -> None:
        if not self._staged:
            return
        # Commit in fill-time order (stable on ties, so simultaneous fills
        # keep their staging order): LRU recency — and therefore eviction
        # order — must reflect when entries actually landed, not the order
        # callers happened to stage them in.
        ready = [(ft, k) for k, ft in self._staged.items() if ft <= t]
        ready.sort(key=lambda e: e[0])
        for ft, k in ready:
            del self._staged[k]
            s = self._set_for(k)
            if k in s:
                s.move_to_end(k)
            else:
                if len(s) >= self.assoc:
                    s.popitem(last=False)  # LRU eviction
                s[k] = ft

    def lookup(self, key, t: float) -> bool:
        self._commit(t)
        s = self._set_for(key)
        if key in s:
            s.move_to_end(key)
            return True
        return False

    def fill(self, key, fill_time: float) -> None:
        prev = self._staged.get(key)
        if prev is None or fill_time < prev:
            self._staged[key] = fill_time


@dataclass
class Counters:
    """Aggregate statistics for one simulation run."""

    requests: int = 0
    by_class: Dict[str, int] = field(
        default_factory=lambda: {c: 0 for c in CLASSES})
    rat_ns_sum: float = 0.0
    rat_ns_max: float = 0.0
    walks: int = 0
    walk_mem_reads: int = 0
    pwc_hits: int = 0
    pwc_misses: int = 0
    probes: int = 0               # pre-translation / prefetch probes issued
    mshr_stall_ns: float = 0.0

    def add_request(self, klass: str, rat_ns: float, n: int = 1) -> None:
        self.requests += n
        self.by_class[klass] += n
        self.rat_ns_sum += rat_ns
        # rat_ns is the sum over n requests; max tracked by callers per-epoch.

    def note_max(self, rat_ns: float) -> None:
        if rat_ns > self.rat_ns_max:
            self.rat_ns_max = rat_ns

    def merge(self, other: "Counters") -> None:
        """Accumulate another target GPU's counters into this one."""
        self.requests += other.requests
        for k in self.by_class:
            self.by_class[k] += other.by_class[k]
        self.rat_ns_sum += other.rat_ns_sum
        self.rat_ns_max = max(self.rat_ns_max, other.rat_ns_max)
        self.walks += other.walks
        self.walk_mem_reads += other.walk_mem_reads
        self.pwc_hits += other.pwc_hits
        self.pwc_misses += other.pwc_misses
        self.probes += other.probes
        self.mshr_stall_ns += other.mshr_stall_ns

    def copy(self) -> "Counters":
        c = Counters(
            requests=self.requests, by_class=dict(self.by_class),
            rat_ns_sum=self.rat_ns_sum, rat_ns_max=self.rat_ns_max,
            walks=self.walks, walk_mem_reads=self.walk_mem_reads,
            pwc_hits=self.pwc_hits, pwc_misses=self.pwc_misses,
            probes=self.probes, mshr_stall_ns=self.mshr_stall_ns)
        return c

    def delta(self, since: "Counters") -> "Counters":
        """Counters accumulated after the ``since`` snapshot was taken.

        ``rat_ns_max`` is cumulative, not differentiable: the returned value
        is the running max (exact when the max occurred after the snapshot).
        """
        return Counters(
            requests=self.requests - since.requests,
            by_class={k: self.by_class[k] - since.by_class[k]
                      for k in self.by_class},
            rat_ns_sum=self.rat_ns_sum - since.rat_ns_sum,
            rat_ns_max=self.rat_ns_max,
            walks=self.walks - since.walks,
            walk_mem_reads=self.walk_mem_reads - since.walk_mem_reads,
            pwc_hits=self.pwc_hits - since.pwc_hits,
            pwc_misses=self.pwc_misses - since.pwc_misses,
            probes=self.probes - since.probes,
            mshr_stall_ns=self.mshr_stall_ns - since.mshr_stall_ns)

    @property
    def mean_rat_ns(self) -> float:
        return self.rat_ns_sum / self.requests if self.requests else 0.0


class PTWPool:
    """Shared pool of ``n`` parallel page-table walkers (min-heap of free times).

    Two-phase protocol: :meth:`start` claims the earliest-free walker and
    returns the actual walk start time (``max(t, free)``); the caller
    computes the walk latency *from that start time* — PWC lookups are
    timestamped when the walker actually issues them, not when the request
    arrived — and then :meth:`finish` returns the walker to the pool.
    Every ``start`` must be paired with exactly one ``finish``.
    """

    def __init__(self, n: int):
        self._free = [0.0] * n
        heapq.heapify(self._free)

    def start(self, t: float) -> float:
        """Claim a walker for a walk requested at ``t``; returns start time."""
        free = heapq.heappop(self._free)
        return max(t, free)

    def finish(self, busy_until: float) -> None:
        """Release the claimed walker, busy until ``busy_until``."""
        heapq.heappush(self._free, busy_until)


@dataclass
class AccessResult:
    resolve: float        # time the NPA->SPA translation is available
    klass: str            # one of CLASSES
    l1_fill: float        # time this station's L1 holds the entry (INF never)


class TranslationState:
    """Full Reverse Address Translation state for ONE target GPU."""

    def __init__(self, cfg: TranslationConfig, n_stations: int):
        self.cfg = cfg
        self.n_stations = n_stations
        self.l1 = [LRUCache(cfg.l1.entries, cfg.l1.assoc)
                   for _ in range(n_stations)]
        self.l2 = LRUCache(cfg.l2.entries, cfg.l2.assoc)
        self.pwc = [LRUCache(e, cfg.pwc.assoc) for e in cfg.pwc.entries]
        self.ptw = PTWPool(cfg.n_ptw)
        # page -> walk completion time while a walk is in flight (L2-level
        # coalescing); entries are pruned lazily.
        self.l2_pending: Dict[int, float] = {}
        # (station, page) -> L1 fill time for in-flight entries (MSHR).
        self.l1_pending: Dict[Tuple[int, int], float] = {}
        self.counters = Counters()

    def flush(self) -> None:
        """Invalidate all cached translations (TLBs, PWCs, pending walks).

        Models long inter-collective idle gaps in a replay session: competing
        traffic (local CUDA graphs, other tenants' collectives) evicts the
        Link-TLB working set while the pod is quiet.  Counters and walker-pool
        occupancy are preserved — only cached state is lost.
        """
        cfg = self.cfg
        self.l1 = [LRUCache(cfg.l1.entries, cfg.l1.assoc)
                   for _ in range(self.n_stations)]
        self.l2 = LRUCache(cfg.l2.entries, cfg.l2.assoc)
        self.pwc = [LRUCache(e, cfg.pwc.assoc) for e in cfg.pwc.entries]
        self.l2_pending.clear()
        self.l1_pending.clear()

    # -- page walk ---------------------------------------------------------
    def _walk_latency(self, page: int, t: float) -> float:
        """Latency of a page walk starting at ``t`` (PWC lookups + PT reads).

        Upper levels probe their PWC (hit: lookup latency only; miss: lookup
        + memory read, then fill).  The leaf PTE read always goes to memory.
        """
        c = self.cfg
        lat = 0.0
        addr = page * c.page_bytes
        for lvl, cache in enumerate(self.pwc):
            region = addr // c.pwc.coverage_bytes[lvl]
            lat += c.pwc.lookup_latency_ns
            if cache.lookup((lvl, region), t + lat):
                self.counters.pwc_hits += 1
            else:
                self.counters.pwc_misses += 1
                lat += c.mem_access_ns
                self.counters.walk_mem_reads += 1
                cache.fill((lvl, region), t + lat)
        # Leaf PTE fetch.
        lat += c.mem_access_ns
        self.counters.walk_mem_reads += 1
        return lat

    # -- main entry point ---------------------------------------------------
    def access(self, station: int, page: int, t: float,
               is_probe: bool = False) -> AccessResult:
        """One translation request arriving at ``station`` at time ``t``.

        Returns the resolve time and classification.  Mutates TLB/PWC/PTW
        state.  Callers must invoke in non-decreasing ``t`` order per GPU.
        """
        c = self.cfg
        if not c.enabled:
            return AccessResult(resolve=t, klass=L1_HIT, l1_fill=-INF)

        t1 = t + c.l1.hit_latency_ns
        if self.l1[station].lookup(page, t1):
            return AccessResult(resolve=t1, klass=L1_HIT, l1_fill=-INF)

        key = (station, page)
        pend = self.l1_pending.get(key)
        if pend is not None:
            if pend <= t1:
                del self.l1_pending[key]  # lazily retire; entry is in L1 now
                # (the lazy LRU commit in lookup() above would have hit if the
                # fill landed; landing exactly between lookup and now counts
                # as an MSHR hit resolving immediately)
                return AccessResult(resolve=max(t1, pend), klass=L1_HUM,
                                    l1_fill=pend)
            return AccessResult(resolve=max(t1, pend), klass=L1_HUM,
                                l1_fill=pend)

        # L1 miss -> allocate MSHR, go to L2.
        t2 = t1 + c.l2.hit_latency_ns
        if self.l2.lookup(page, t2):
            self.l1[station].fill(page, t2)
            self.l1_pending[key] = t2
            return AccessResult(resolve=t2, klass=L2_HIT, l1_fill=t2)

        walk_done = self.l2_pending.get(page)
        if walk_done is not None and walk_done > t2:
            # Another station already launched the walk: coalesce at L2.
            self.l1[station].fill(page, walk_done)
            self.l1_pending[key] = walk_done
            return AccessResult(resolve=walk_done, klass=L2_HUM,
                                l1_fill=walk_done)
        if walk_done is not None:
            del self.l2_pending[page]

        # Full miss: launch a page walk on the shared walker pool.  The
        # walker may start later than the request time (pool saturation);
        # PWC lookups and PT reads are timed from the actual walk start.
        start = self.ptw.start(t2)
        walk_lat = self._walk_latency(page, start)
        self.ptw.finish(start + walk_lat)
        done = start + walk_lat
        self.counters.walks += 1
        self.l2_pending[page] = done
        self.l2.fill(page, done)
        self.l1[station].fill(page, done)
        self.l1_pending[key] = done
        return AccessResult(resolve=done, klass=WALK, l1_fill=done)
