"""Vectorized batch engine: the page-epoch model as array arithmetic.

Drop-in replacement for :class:`repro_torch.core.engine.EpochEngine` selected via
``SimConfig.engine="vectorized"`` (DESIGN.md §12).  The event engine spends
its time in two places: materializing O(n^2) per-flow Python objects at
pod scale, and walking a Python loop over every (epoch, station) head of
large collectives.  This engine removes both:

* flow/epoch/head geometry — spacing, arrival times, page spans, station
  striping, ingress totals — is precomputed as numpy arrays
  (:func:`flows_from_specs` plus the span construction in
  :meth:`VecEngine.run_iteration`);
* only the inherently sequential part remains a Python loop: one
  :meth:`VecTranslationState.access` state-machine call per epoch head (the
  TLB hierarchy is stateful — each access's outcome depends on every prior
  access), reading pre-converted native scalars;
* all per-head tail expansion (hit-under-miss counts, latency sums, trace
  rows, completion) is deferred to vectorized postprocessing.

Two serving-scale optimizations sit on top (DESIGN.md §15):

* **Geometry memoization** — everything ``run_iteration`` derives from a
  :class:`FlowArrays` except the arrival *times* is invariant under the
  call's ``t_start``: page spans, the epoch sort order, head striping,
  ingress totals.  The first call caches it as a :class:`_Geom` on the
  ``FlowArrays``; later calls only re-add the new start time.  Arrival
  times enter the epoch sort, and float addition is monotone but not
  strictly so — the build records the *hazard* pairs (adjacent epochs
  whose relative order could collapse or separate under a different
  offset) and every reuse re-checks exactly those pairs, falling back to
  a full re-sort when one trips.  Bit-for-bit holds because every reused
  expression keeps the original operand order (``a0[fi] + i0*delta[fi]``
  becomes ``a0[fi] + cached_rel`` with identical operands).
* **Warm fast path** — when a call's every (station, page) head is
  L1-resident (an exact ``resident`` mirror set on :class:`_VLRU`) and no
  staged fill commits inside the call's time window, every ``access`` is a
  first-branch L1 hit that mutates nothing but LRU recency.  The per-head
  Python loop is then replaced by an all-hit vectorized expansion plus a
  batched recency update in last-occurrence order (the order an
  ``OrderedDict`` ends up in after the per-head ``move_to_end`` sequence) —
  bit-for-bit by construction.  Engagements are counted on
  ``VecEngine.fastpath_calls`` and surfaced through ``RunResult``.

Bit-for-bit equivalence with the event engine is a hard contract, enforced
by ``tests/test_engine_diff.py``.  It holds because every float expression
keeps the event engine's exact operand order (elementwise numpy float64 ops
are IEEE-identical to scalar Python), accumulations use ``np.cumsum`` (a
strict left fold, matching the scalar ``+=`` chain — the terms the event
engine skips contribute exact-zero no-ops), and the optimized LRU below
reproduces the original's lazy-commit order exactly.

:class:`VecTranslationState` is an operation-for-operation port of
:class:`repro_torch.core.tlb.TranslationState` with two structural speedups that
provably preserve the observable sequence of cache operations:

* ``_VLRU`` commits staged fills from a min-heap ordered by
  ``(fill_time, staging_index)`` instead of re-scanning and stably sorting
  the staged dict on every lookup.  The original's order is fill-time with
  dict-insertion tie-break, and dict position is preserved when a fill is
  re-staged earlier — exactly the ``(fill_time, first_staging_index)``
  order the heap pops in (stale heap entries are skipped by generation
  check).
* ``l1_maybe``/``l2_maybe`` record every page ever fill-staged per cache
  since the last flush.  A page absent from the set cannot be resident, so
  its lookup is a guaranteed miss and is skipped entirely.  Deferring the
  skipped lookup's lazy commits is safe: commits are totally ordered by
  ``(fill_time, staging_index)`` and every *taken* lookup first commits all
  fills up to its own time, so the interleaving of commits, hits
  (recency updates) and evictions that the caches observe is unchanged.
"""
from __future__ import annotations

import heapq
import math
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import SimConfig, TranslationConfig
from .patterns import StepArrays
from .tlb import CLASSES, Counters, INF, L1_HIT, L1_HUM, PTWPool
from .topology import get_topology

# Integer class codes for the hot path (postprocessing maps them back to
# the string keys of Counters.by_class).  Order matches tlb.CLASSES.
_L1_HIT, _L1_HUM, _L2_HIT, _L2_HUM, _WALK = range(5)


class _VLRU:
    """Set-associative lazy-commit LRU, heap-committed.

    Same observable semantics as :class:`repro_torch.core.tlb.LRUCache` (see the
    module docstring for the order argument); O(log staged) per commit
    instead of an O(staged) scan-and-sort per lookup.

    ``resident`` mirrors the union of the set dicts' keys exactly (updated
    only where membership changes: commit-insert and evict).  It answers
    "would this lookup hit, given no commits fire first?" in O(1) without
    touching recency — the predicate the warm fast path batches over.
    """

    __slots__ = ("entries", "assoc", "n_sets", "_sets", "_staged", "_heap",
                 "_seq", "resident", "_mut")

    def __init__(self, entries: int, assoc: int,
                 mut: Optional[List[int]] = None):
        self.entries = entries
        self.assoc = assoc if assoc > 0 else entries
        self.n_sets = max(1, entries // self.assoc)
        self._sets = [OrderedDict() for _ in range(self.n_sets)]
        self._staged: Dict[object, Tuple[float, int]] = {}
        self._heap: List[Tuple[float, int, object]] = []
        self._seq = 0
        self.resident: set = set()
        # Shared mutation-epoch cell (one per owning state): bumped on
        # every staging and on every commit batch, i.e. whenever residency
        # or the heap can change.  Recency moves deliberately do NOT bump
        # it — they never change a fast-path verdict.
        self._mut = mut if mut is not None else [0]

    def _commit(self, t: float) -> None:
        h = self._heap
        if not (h and h[0][0] <= t):
            return
        self._mut[0] += 1
        staged = self._staged
        sets = self._sets
        n_sets = self.n_sets
        assoc = self.assoc
        resident = self.resident
        pop = heapq.heappop
        while h and h[0][0] <= t:
            ft, seq, k = pop(h)
            if staged.get(k) != (ft, seq):
                continue                   # superseded by an earlier re-fill
            del staged[k]
            s = sets[hash(k) % n_sets]
            if k in s:
                s.move_to_end(k)
            else:
                if len(s) >= assoc:
                    old, _ = s.popitem(last=False)  # LRU eviction
                    resident.discard(old)
                s[k] = ft
                resident.add(k)

    def lookup(self, key, t: float) -> bool:
        h = self._heap
        if h and h[0][0] <= t:
            self._commit(t)
        s = self._sets[hash(key) % self.n_sets]
        if key in s:
            s.move_to_end(key)
            return True
        return False

    def fill(self, key, fill_time: float) -> None:
        self._mut[0] += 1
        prev = self._staged.get(key)
        if prev is None:
            seq = self._seq
            self._seq = seq + 1
            self._staged[key] = (fill_time, seq)
            heapq.heappush(self._heap, (fill_time, seq, key))
        elif fill_time < prev[0]:
            # Earlier re-fill keeps the original staging index, exactly as
            # a dict value update keeps the key's position.
            self._staged[key] = (fill_time, prev[1])
            heapq.heappush(self._heap, (fill_time, prev[1], key))


class VecTranslationState:
    """Optimized port of :class:`repro_torch.core.tlb.TranslationState`.

    Identical decision tree and float arithmetic; hot-path accesses return a
    plain ``(resolve, class_code, l1_fill)`` tuple instead of an
    ``AccessResult``.  Interface used by :class:`~repro_torch.core.session.
    SimSession` (``counters``, ``flush``) is preserved.
    """

    def __init__(self, cfg: TranslationConfig, n_stations: int):
        self.cfg = cfg
        self.n_stations = n_stations
        self._l1_lat = cfg.l1.hit_latency_ns
        self._l2_lat = cfg.l2.hit_latency_ns
        # One mutation-epoch cell shared by every cache of this state: any
        # staging or commit anywhere bumps it, so an unchanged epoch proves
        # every L1's residency set *and* heap are exactly as last observed.
        self.mut: List[int] = [0]
        self.l1 = [_VLRU(cfg.l1.entries, cfg.l1.assoc, self.mut)
                   for _ in range(n_stations)]
        self.l2 = _VLRU(cfg.l2.entries, cfg.l2.assoc, self.mut)
        self.pwc = [_VLRU(e, cfg.pwc.assoc, self.mut)
                    for e in cfg.pwc.entries]
        self.ptw = PTWPool(cfg.n_ptw)
        self.l2_pending: Dict[int, float] = {}
        # MSHR fills keyed (station, page) in the original; split per
        # station here (same key space, no tuple hashing on the hot path).
        self.l1_pending: List[Dict[int, float]] = [
            {} for _ in range(n_stations)]
        self.counters = Counters()
        # Pages ever fill-staged per cache since the last flush: absence
        # proves a miss, so the lookup (and its deferred-safe lazy commit)
        # is skipped.
        self.l1_maybe = [set() for _ in range(n_stations)]
        self.l2_maybe: set = set()

    def flush(self) -> None:
        """Invalidate cached translations; keep counters and PTW occupancy
        (mirrors :meth:`repro_torch.core.tlb.TranslationState.flush`)."""
        cfg = self.cfg
        self.mut[0] += 1
        self.l1 = [_VLRU(cfg.l1.entries, cfg.l1.assoc, self.mut)
                   for _ in range(self.n_stations)]
        self.l2 = _VLRU(cfg.l2.entries, cfg.l2.assoc, self.mut)
        self.pwc = [_VLRU(e, cfg.pwc.assoc, self.mut)
                    for e in cfg.pwc.entries]
        self.l2_pending.clear()
        self.l1_pending = [{} for _ in range(self.n_stations)]
        self.l1_maybe = [set() for _ in range(self.n_stations)]
        self.l2_maybe = set()

    def _walk_latency(self, page: int, t: float) -> float:
        c = self.cfg
        ctr = self.counters
        lat = 0.0
        addr = page * c.page_bytes
        for lvl, cache in enumerate(self.pwc):
            region = addr // c.pwc.coverage_bytes[lvl]
            lat += c.pwc.lookup_latency_ns
            if cache.lookup((lvl, region), t + lat):
                ctr.pwc_hits += 1
            else:
                ctr.pwc_misses += 1
                lat += c.mem_access_ns
                ctr.walk_mem_reads += 1
                cache.fill((lvl, region), t + lat)
        lat += c.mem_access_ns
        ctr.walk_mem_reads += 1
        return lat

    def access(self, station: int, page: int,
               t: float) -> Tuple[float, int, float]:
        """One translation request; callers gate on ``cfg.enabled``."""
        t1 = t + self._l1_lat
        maybe = self.l1_maybe[station]
        if page in maybe and self.l1[station].lookup(page, t1):
            return (t1, _L1_HIT, -INF)

        pending = self.l1_pending[station]
        pend = pending.get(page)
        if pend is not None:
            if pend <= t1:
                del pending[page]
                return (t1, _L1_HUM, pend)       # max(t1, pend) == t1
            return (pend, _L1_HUM, pend)         # max(t1, pend) == pend

        t2 = t1 + self._l2_lat
        if page in self.l2_maybe and self.l2.lookup(page, t2):
            self.l1[station].fill(page, t2)
            maybe.add(page)
            pending[page] = t2
            return (t2, _L2_HIT, t2)

        walk_done = self.l2_pending.get(page)
        if walk_done is not None:
            if walk_done > t2:
                self.l1[station].fill(page, walk_done)
                maybe.add(page)
                pending[page] = walk_done
                return (walk_done, _L2_HUM, walk_done)
            del self.l2_pending[page]

        start = self.ptw.start(t2)
        walk_lat = self._walk_latency(page, start)
        self.ptw.finish(start + walk_lat)
        done = start + walk_lat
        self.counters.walks += 1
        self.l2_pending[page] = done
        self.l2.fill(page, done)
        self.l2_maybe.add(page)
        self.l1[station].fill(page, done)
        maybe.add(page)
        pending[page] = done
        return (done, _WALK, done)


def _fp_structs(st_l: List[int], hpage_l: List[int]):
    """Warm-fast-path precomputation over the head sequence.

    Returns ``(stations, pairs)``:

    * ``stations`` — the distinct stations the call touches (page-free, so
      shifted clones share it);
    * ``pairs`` — the distinct (station, page) touches ordered by *last*
      occurrence in the head sequence.  Applying ``move_to_end`` in that
      order leaves each L1 set's ``OrderedDict`` in exactly the state the
      per-head loop's all-hit lookup sequence would (earlier touches of a
      re-touched page are overtaken by its last touch; distinct sets
      never interleave)."""
    seen = set()
    pairs: List[Tuple[int, int]] = []
    for sp in zip(reversed(st_l), reversed(hpage_l)):
        if sp not in seen:
            seen.add(sp)
            pairs.append(sp)
    pairs.reverse()
    stations = list({s: None for s, _ in pairs})
    return stations, pairs


def _qg_structs(st_l: List[int], hpage_l: List[int], H: int):
    """Group heads by (station, page) for the quiet-window path.

    Returns ``(h2g, gfirst, order_last, gst, sts)``: per-head group index,
    each group's first head index, group indices sorted by *last* head
    index (the batched-recency order), per-group station, and the distinct
    stations.  Everything here is invariant under a uniform page shift
    (groups are defined by equality, and translation preserves equality),
    so shifted clones share it; only the per-group page ids differ."""
    d: Dict[Tuple[int, int], int] = {}
    h2g = np.empty(H, dtype=np.int64)
    gfirst: List[int] = []
    glast: List[int] = []
    gst: List[int] = []
    i = 0
    for sp in zip(st_l, hpage_l):
        gi = d.get(sp)
        if gi is None:
            gi = len(gfirst)
            d[sp] = gi
            gfirst.append(i)
            glast.append(i)
            gst.append(sp[0])
        else:
            glast[gi] = i
        h2g[i] = gi
        i += 1
    order_last = np.argsort(np.asarray(glast, dtype=np.int64),
                            kind="stable")
    sts = list({s: None for s in gst})
    return (h2g, np.asarray(gfirst, dtype=np.int64), order_last, gst, sts)


class _Geom:
    """t_start-invariant geometry of one :class:`FlowArrays` (sorted order).

    Everything :meth:`VecEngine.run_iteration` derives from the flow set
    except the absolute arrival times: epoch spans in the event engine's
    sort order, head geometry, ingress totals, prefetch targets, and the
    warm-fast-path structures.  Times are reconstructed per call as
    ``a0[fi] + rel`` with the *same* operands the uncached expression used,
    so reuse is bit-for-bit.

    The cached sort order was produced under one ``t_start``.  Under
    another, IEEE float-add monotonicity guarantees relative arrival order
    can only change at the recorded ``hazards`` (uniform-latency flows) or
    where the per-call strictness check fails (``tie_ok``, mixed-latency
    flows); both trigger a rebuild at the new ``t_start``.
    """

    __slots__ = ("e_fi", "page", "i0", "i1", "e_rel", "tie_ok", "hazards",
                 "uniform", "ow_c", "E", "hcum", "H", "h_e", "h_is0",
                 "h_fi", "h_ns", "h_ns_m1", "h_ns_m1f", "h_rel",
                 "h_stride", "h_ret", "tail", "tail_all", "tail_prod",
                 "n_tot",
                 "totals_l", "st_l", "ns_l", "hpage_l", "h0_l", "h1_l",
                 "pf_cols", "rel_max", "rel_min", "no_bp", "sc_lists",
                 "fp_enabled", "fp_sts", "fp_pairs", "fp_s_hit",
                 "fp_hits", "fp_tail_add", "fp_scalars", "fp_src",
                 "qg", "qg2", "qg_pages", "fp_epoch", "fp_hmin", "fp_mutc",
                 "fp_chk")

    def shifted(self, dp: int) -> "_Geom":
        """This geometry translated by ``dp`` pages (a page-aligned
        ``base_addr`` shift).  Page spans, request indexing, arrival
        spacing and the sort order are invariant under a uniform page
        translation — only the page *ids* (and the structures keyed on
        them: prefetch targets, fast-path sets whose L1 set index is
        ``hash(page) % n_sets``) change."""
        g = _Geom.__new__(_Geom)
        g.e_fi = self.e_fi
        g.page = self.page + dp
        g.i0 = self.i0
        g.i1 = self.i1
        g.e_rel = self.e_rel
        g.tie_ok = self.tie_ok
        g.hazards = self.hazards
        g.uniform = self.uniform
        g.ow_c = self.ow_c
        g.E = self.E
        g.hcum = self.hcum
        g.H = self.H
        g.h_e = self.h_e
        g.h_is0 = self.h_is0
        g.h_fi = self.h_fi
        g.h_ns = self.h_ns
        g.h_ns_m1 = self.h_ns_m1
        g.h_ns_m1f = self.h_ns_m1f
        g.h_rel = self.h_rel
        g.h_stride = self.h_stride
        g.h_ret = self.h_ret
        g.tail = self.tail
        g.tail_all = self.tail_all
        g.tail_prod = self.tail_prod
        g.n_tot = self.n_tot
        g.totals_l = self.totals_l
        g.st_l = self.st_l
        g.ns_l = self.ns_l
        g.h0_l = self.h0_l
        g.h1_l = self.h1_l
        g.rel_max = self.rel_max
        g.rel_min = self.rel_min
        g.no_bp = self.no_bp
        g.sc_lists = self.sc_lists
        g.fp_enabled = self.fp_enabled
        g.fp_s_hit = self.fp_s_hit
        g.fp_hits = self.fp_hits
        g.fp_tail_add = self.fp_tail_add
        g.fp_scalars = self.fp_scalars
        g.fp_sts = self.fp_sts
        g.qg = self.qg
        g.qg2 = self.qg2
        # Page-keyed caches stay lazy on clones: the per-head page list is
        # rebuilt on demand (a numpy gather beats shifting the list), and
        # the fast-path pairs materialize on the clone's first fast-path
        # attempt — from the parent's pairs when it has built them (a
        # listcomp over the distinct touches), else from the head arrays.
        # Eagerly shifting here charged every clone for a structure most
        # prefill clones only ever decline against.
        g.hpage_l = None
        g.fp_pairs = None
        g.fp_src = (self, dp)
        g.qg_pages = None
        g.fp_epoch = -1
        g.fp_hmin = -INF
        g.fp_mutc = None
        g.fp_chk = None
        g.pf_cols = self.pf_cols
        if self.pf_cols:
            g.pf_cols = [(valid, stj, [p + dp for p in pj])
                         for (valid, stj, pj) in self.pf_cols]
        return g


@dataclass
class FlowArrays:
    """One step's flows at one target as parallel columns.

    Row ``i`` carries exactly the fields of the ``i``-th
    :class:`~repro_torch.core.engine.Flow` that :func:`~repro_torch.core.engine.
    flows_for_dst` would build (same order: spec order filtered to this
    target).  ``geom`` is the lazily built t_start-invariant
    :class:`_Geom` cache; sessions reuse ``FlowArrays`` across calls by
    re-assigning ``t_start`` only.
    """

    src: np.ndarray        # int64
    base_addr: np.ndarray  # int64, NPA region base + spec offset
    nbytes: np.ndarray     # int64, all > 0
    t_start: float
    delta: np.ndarray      # float64 inter-request spacing
    stripe: np.ndarray     # int64 station striping offset
    oneway: np.ndarray     # float64 request-path latency
    ret: np.ndarray        # float64 ack-path latency
    geom: Optional[_Geom] = field(default=None, repr=False, compare=False)

    def __len__(self) -> int:
        return len(self.src)


def flows_from_specs(step: StepArrays, cfg: SimConfig, dst: int,
                     t_start: float) -> Optional[FlowArrays]:
    """Vectorized :func:`repro_torch.core.engine.flows_for_dst`.

    Bandwidth shares count *all* of the step's flows (zero-byte and
    other-target flows included), matching the event engine; only flows
    landing at ``dst`` with positive bytes are materialized.  Returns
    ``None`` for an empty flow set (the event path's ``[]``).
    """
    fab = cfg.fabric
    topo = get_topology(fab)
    sel = (step.dst == dst) & (step.nbytes > 0)
    if not sel.any():
        return None
    src = step.src[sel]
    nb = step.nbytes[sel]
    off = step.offset[sel]
    rb = fab.request_bytes
    delta = (rb * step.out_deg()[src]) / fab.gpu_bw
    if topo.flat:
        oneway = np.full(len(src), fab.oneway_ns)
        ret = np.full(len(src), fab.return_ns)
    else:
        # Per-(source, tier) degrees are a per-step aggregate over ALL
        # specs; cached on the StepArrays (steps are built per run, under
        # one fabric config, so the cache never crosses topologies).
        if step._tier_cache is None:
            tier_all = topo.tier_arr(step.src, step.dst)
            ntier = int(tier_all.max()) + 1 if len(tier_all) else 1
            step._tier_cache = (ntier,
                                np.bincount(step.src * ntier + tier_all))
        ntier, tdeg = step._tier_cache
        tier_sel = topo.tier_arr(src, dst)
        for tv in np.unique(tier_sel):
            cap = topo.tier_capacity(int(tv))
            if cap is None:
                continue
            m = tier_sel == tv
            shaped = (rb * tdeg[src[m] * ntier + tv]) / cap
            delta[m] = np.maximum(delta[m], shaped)
        oneway = topo.path_latency_arr(src, dst)
        ret = topo.return_latency_arr(dst, src)
    return FlowArrays(src=src, base_addr=((dst + 1) << 42) + off, nbytes=nb,
                      t_start=t_start, delta=delta,
                      stripe=src % fab.stations_per_gpu,
                      oneway=oneway, ret=ret)


def flows_from_specs_multi(step: StepArrays, cfg: SimConfig,
                           dsts: List[int],
                           t_start: float = 0.0) -> Dict[int,
                                                         Optional[FlowArrays]]:
    """Batched :func:`flows_from_specs` over every simulated target.

    One vectorized pass — bandwidth shares, tier shaping and per-path
    latencies are computed once over the union of all targets' flows and
    split per destination afterwards (row order within a destination is
    spec order, exactly as the per-dst build), so the per-target
    ``FlowArrays`` are element-for-element identical to ``len(dsts)``
    separate :func:`flows_from_specs` calls at a fraction of the passes.
    """
    fab = cfg.fabric
    topo = get_topology(fab)
    out: Dict[int, Optional[FlowArrays]] = {int(d): None for d in dsts}
    sel = (step.nbytes > 0) & np.isin(step.dst,
                                      np.asarray(list(dsts), dtype=np.int64))
    if not sel.any():
        return out
    src = step.src[sel]
    dstv = step.dst[sel]
    nb = step.nbytes[sel]
    off = step.offset[sel]
    rb = fab.request_bytes
    delta = (rb * step.out_deg()[src]) / fab.gpu_bw
    if topo.flat:
        oneway = np.full(len(src), fab.oneway_ns)
        ret = np.full(len(src), fab.return_ns)
    else:
        if step._tier_cache is None:
            tier_all = topo.tier_arr(step.src, step.dst)
            ntier = int(tier_all.max()) + 1 if len(tier_all) else 1
            step._tier_cache = (ntier,
                                np.bincount(step.src * ntier + tier_all))
        ntier, tdeg = step._tier_cache
        tier_sel = topo.tier_arr(src, dstv)
        for tv in np.unique(tier_sel):
            cap = topo.tier_capacity(int(tv))
            if cap is None:
                continue
            m = tier_sel == tv
            shaped = (rb * tdeg[src[m] * ntier + tv]) / cap
            delta[m] = np.maximum(delta[m], shaped)
        oneway = topo.path_latency_arr(src, dstv)
        ret = topo.return_latency_arr(dstv, src)
    stripe = src % fab.stations_per_gpu
    base = ((dstv + 1) << 42) + off
    for d in dsts:
        idx = np.flatnonzero(dstv == d)
        if len(idx):
            out[int(d)] = FlowArrays(
                src=src[idx], base_addr=base[idx], nbytes=nb[idx],
                t_start=t_start, delta=delta[idx], stripe=stripe[idx],
                oneway=oneway[idx], ret=ret[idx])
    return out


def rebase_flow_arrays(fa: FlowArrays, delta_addr: int,
                       page_bytes: int) -> FlowArrays:
    """Clone ``fa`` with ``base_addr`` shifted by ``delta_addr`` bytes.

    Integer address adds are exact, so the clone is what
    :func:`flows_from_specs` would have built at the shifted region.  When
    the shift is page-aligned the (expensive) cached geometry carries over
    via :meth:`_Geom.shifted`; otherwise it is rebuilt on first use.
    """
    out = FlowArrays(src=fa.src, base_addr=fa.base_addr + delta_addr,
                     nbytes=fa.nbytes, t_start=fa.t_start, delta=fa.delta,
                     stripe=fa.stripe, oneway=fa.oneway, ret=fa.ret)
    dp, rem = divmod(delta_addr, page_bytes)
    if rem == 0 and fa.geom is not None:
        out.geom = fa.geom.shifted(dp)
    return out


def request_counts(fa: FlowArrays, rb: int) -> List[int]:
    """Per-flow request counts (``max(1, ceil(nbytes / rb))``, exact)."""
    return np.maximum(1, np.ceil(fa.nbytes / rb).astype(np.int64)).tolist()


def run_step_group(engines: dict, grp: List[tuple], t: float,
                   first_step: bool) -> float:
    """Price one step's per-destination flow sets in a single invocation.

    Destinations are independent between step barriers — every target has
    its own stations, TLB state and counters — so the step completion is a
    pure max over per-destination completions and the destination fold can
    live here instead of in :meth:`SimSession.run`'s inner loop.  The
    group call is the serving hot path: it skips the per-destination trace
    bookkeeping (the caller keeps the explicit loop for the one traced
    call per session) and amortizes the loop overhead of thousands of
    decode steps.
    """
    comp = t
    for d, fa in grp:
        fa.t_start = t
        c = engines[d].run_iteration(fa, False, first_step=first_step)
        if c > comp:
            comp = c
    return comp


class VecEngine:
    """Vectorized twin of :class:`repro_torch.core.engine.EpochEngine`.

    Same construction signature and the same surface
    :class:`~repro_torch.core.session.SimSession` drives (``state``,
    ``stall_sum``/``stall_n``, ``trace_chunks``, ``run_iteration``), but
    ``run_iteration`` consumes a :class:`FlowArrays` instead of a
    ``List[Flow]``.  ``fastpath_calls`` counts ``run_iteration`` calls the
    warm fast path fully served (DESIGN.md §15.2).
    """

    def __init__(self, cfg: SimConfig, dst: int = 0):
        self.cfg = cfg
        self.dst = dst
        fab = cfg.fabric
        self.state = VecTranslationState(cfg.translation,
                                         fab.stations_per_gpu)
        self.page_bytes = cfg.translation.page_bytes
        self.svc = fab.request_bytes / fab.station_bw
        self.buffer_cover = fab.ingress_entries * self.svc
        self.trace_chunks: List[Tuple[int, int, np.ndarray]] = []
        self.stall_sum = 0.0
        self.stall_n = 0
        self.fastpath_calls = 0
        # Per-call prologue constants (configs are frozen dataclasses, so
        # hoisting the attribute chains out of run_iteration is safe).
        self._fab = fab
        self._ns = fab.stations_per_gpu
        self._enabled = cfg.translation.enabled
        self._l1lat = (cfg.translation.l1.hit_latency_ns
                       if self._enabled else 0.0)
        self._pre_en = cfg.pretranslation.enabled and self._enabled

    # -- optimizations -------------------------------------------------------
    def _pretranslate(self, fa: FlowArrays) -> None:
        """Vectorized probe construction; sequential replay in issue order
        (same (t, station, page) stream as ``pretranslate_probes``)."""
        pre = self.cfg.pretranslation
        fab = self.cfg.fabric
        ns = fab.stations_per_gpu
        rb = fab.request_bytes
        pb = self.page_bytes
        base = fa.base_addr
        first_page = base // pb
        n_pages = (base + fa.nbytes - 1) // pb - first_page + 1
        ppf = pre.pages_per_flow
        limit = n_pages if ppf <= 0 else np.minimum(n_pages, ppf)
        total = int(limit.sum())
        if not total:
            return
        pf = np.repeat(np.arange(len(fa)), limit)
        cum = np.concatenate(([0], np.cumsum(limit)))
        j = np.arange(total) - cum[:-1][pf]
        pg = first_page[pf] + j
        b = base[pf]
        st = ((np.maximum(b, pg * pb) - b) // rb + fa.stripe[pf]) % ns
        t0 = fa.t_start - pre.lead_time_ns
        times = t0 + np.arange(total) * pre.probe_issue_interval_ns
        access = self.state.access
        for s, p, t in zip(st.tolist(), pg.tolist(), times.tolist()):
            access(s, p, t)
        self.state.counters.probes += total

    # -- geometry cache ------------------------------------------------------
    def _build_geom(self, fa: FlowArrays) -> _Geom:
        """Build the t_start-invariant :class:`_Geom` of ``fa``.

        The epoch sort uses the *current* ``fa.t_start`` (the cached order
        is exact for it by construction); reuses under other start times
        validate against ``hazards``/``tie_ok`` first.
        """
        cfg = self.cfg
        fab = cfg.fabric
        rb = fab.request_bytes
        ns = fab.stations_per_gpu
        pb = self.page_bytes
        base = fa.base_addr
        nb = fa.nbytes
        delta = fa.delta
        stripe = fa.stripe
        n_req = np.maximum(1, np.ceil(nb / rb).astype(np.int64))
        a0 = fa.t_start + fa.oneway

        # ---- epoch spans: vectorized epoch_spans(), same sort order ------
        first_page = base // pb
        last_page = (base + nb - 1) // pb
        npages = last_page - first_page + 1
        cum = np.concatenate(([0], np.cumsum(npages)))
        e_fi = np.repeat(np.arange(len(fa)), npages)
        page = first_page[e_fi] + (np.arange(int(cum[-1])) - cum[:-1][e_fi])
        b_f = base[e_fi]
        lo = np.maximum(b_f, page * pb)
        hi = np.minimum(b_f + nb[e_fi], (page + 1) * pb)
        i0 = (lo - b_f) // rb
        i1 = np.minimum(n_req[e_fi],
                        np.ceil((hi - b_f) / rb).astype(np.int64))
        keep = i1 > i0
        e_fi, page, i0, i1 = e_fi[keep], page[keep], i0[keep], i1[keep]
        e_rel = i0 * delta[e_fi]
        t_first = a0[e_fi] + e_rel
        # Tuple sort (t_first, fi, page): (fi, page) pairs are unique, so
        # the lexsort total order equals the event engine's list.sort().
        order = np.lexsort((page, e_fi, t_first))
        e_fi, page, i0, i1, e_rel = (
            e_fi[order], page[order], i0[order], i1[order], e_rel[order])
        E = len(e_fi)

        g = _Geom()
        g.e_fi, g.page, g.i0, g.i1, g.e_rel = e_fi, page, i0, i1, e_rel
        g.E = E

        # ---- order-stability metadata ------------------------------------
        ow = fa.oneway
        g.uniform = bool((ow == ow[0]).all()) if len(ow) else True
        g.ow_c = float(ow[0]) if len(ow) else 0.0
        g.tie_ok = None
        g.hazards = []
        if E > 1:
            tie_lt = ((e_fi[:-1] < e_fi[1:]) |
                      ((e_fi[:-1] == e_fi[1:]) & (page[:-1] < page[1:])))
            if g.uniform:
                # With one shared path latency, arrival order tracks the
                # relative offsets: a pair can only misorder where strict
                # offsets collapse to a float tie against the tiebreak
                # (rel< but key>) or a build-time tie separates (rel>).
                bad = (((e_rel[:-1] < e_rel[1:]) & ~tie_lt)
                       | (e_rel[:-1] > e_rel[1:]))
                g.hazards = [(float(e_rel[i]), float(e_rel[i + 1]),
                              bool(tie_lt[i]))
                             for i in np.flatnonzero(bad)]
            else:
                g.tie_ok = tie_lt

        # ---- heads: per-(epoch, station) sub-series geometry -------------
        e_nh = np.minimum(ns, i1 - i0)
        hcum = np.concatenate(([0], np.cumsum(e_nh)))
        H = int(hcum[-1])
        h_e = np.repeat(np.arange(E), e_nh)
        h_is0 = i0[h_e] + (np.arange(H) - hcum[:-1][h_e])
        h_fi = e_fi[h_e]
        g.hcum, g.H = hcum, H
        g.h_e = h_e
        g.h_is0, g.h_fi = h_is0, h_fi
        h_st = (h_is0 + stripe[h_fi]) % ns
        g.h_ns = (i1[h_e] - h_is0 + ns - 1) // ns
        g.h_ns_m1 = g.h_ns - 1
        g.h_ns_m1f = g.h_ns_m1.astype(np.float64)
        g.h_rel = h_is0 * delta[h_fi]
        g.h_stride = ns * delta[h_fi]
        g.h_ret = fa.ret[h_fi]
        g.tail = g.h_ns > 1
        g.tail_all = bool(g.tail.all())
        g.tail_prod = g.h_ns_m1 * g.h_stride
        g.n_tot = int(g.h_ns.sum())
        g.st_l = h_st.tolist()
        g.ns_l = g.h_ns.tolist()
        g.hpage_l = page[h_e].tolist()
        g.h0_l = hcum[:-1].tolist()
        g.h1_l = hcum[1:].tolist()

        # ---- per-station ingress totals ----------------------------------
        totals = np.zeros(ns, dtype=np.int64)
        bq, extra = np.divmod(n_req, ns)
        soff = np.arange(ns)
        np.add.at(totals, (soff[None, :] + stripe[:, None]) % ns,
                  bq[:, None] + (soff[None, :] < extra[:, None]))
        g.totals_l = totals.tolist()

        # ---- prefetch probe targets (paper §6.2), per epoch --------------
        g.pf_cols = []
        if cfg.prefetch.enabled:
            b_e = base[e_fi]
            lp_e = last_page[e_fi]
            stripe_e = stripe[e_fi]
            for j in range(1, cfg.prefetch.depth + 1):
                pj = page + j
                valid = pj <= lp_e
                st_j = ((np.maximum(b_e, pj * pb) - b_e) // rb
                        + stripe_e) % ns
                g.pf_cols.append((valid.tolist(), st_j.tolist(),
                                  pj.tolist()))

        # ---- warm-fast-path structures -----------------------------------
        # Page-keyed parts (station_pages/pairs) and the scalar-loop lists
        # are built lazily on first fast-path attempt; everything here is
        # page-free, so page-shifted clones share it by reference.
        g.rel_max = float(g.h_rel.max()) if H else 0.0
        g.rel_min = float(g.h_rel.min()) if H else 0.0
        # With every station's ingress total below the buffer depth, the
        # backpressure predicate (totals - consumed >= ingress) can never
        # fire: skew stays exactly 0.0 and the skew/consumed bookkeeping
        # is droppable wholesale (t0b + 0.0 == t0b for the nonnegative
        # arrival times flows produce).
        g.no_bp = all(t < fab.ingress_entries for t in g.totals_l)
        g.sc_lists = None
        g.fp_sts = None
        g.fp_pairs = None
        g.fp_src = None
        g.qg = None
        g.qg2 = None
        g.qg_pages = None
        g.fp_scalars = None
        g.fp_s_hit = 0
        g.fp_hits = None
        g.fp_tail_add = None
        g.fp_epoch = -1
        g.fp_hmin = -INF
        g.fp_mutc = None
        g.fp_chk = None
        g.fp_enabled = bool(cfg.translation.enabled and not g.pf_cols)
        if g.fp_enabled:
            l1_lat = cfg.translation.l1.hit_latency_ns
            g.fp_s_hit = int(g.h_ns_m1.sum())
            g.fp_hits = g.h_ns_m1 * l1_lat
            g.fp_tail_add = np.where(g.tail, g.tail_prod, 0.0)
        return g

    # -- core ----------------------------------------------------------------
    def run_iteration(self, fa: FlowArrays, collect_trace: bool,
                      fi_base: int = 0, first_step: bool = True) -> float:
        """Price one step's flow set; returns absolute completion time.

        Semantics identical to ``EpochEngine.run_iteration``: translation
        state persists across calls, per-station ingress bookkeeping
        resets, pre-translation probes fire only on ``first_step``.
        """
        fab = self._fab
        ns = self._ns
        enabled = self._enabled
        l1_lat = self._l1lat
        ctr = self.state.counters

        if first_step and self._pre_en and len(fa):
            self._pretranslate(fa)

        # Uniform-latency geometries defer materializing the h_t0b array
        # (h_t0b is None, k0 set): the scalar fast path never needs it, and
        # every consumer below reconstructs it as ``g.h_rel + k0`` — the
        # same expression, so laziness is observationally free.
        g = fa.geom
        if g is None:
            g = fa.geom = self._build_geom(fa)
            t_first = None
            if g.uniform:
                k0 = fa.t_start + g.ow_c
                h_t0b = None
            else:
                a0 = fa.t_start + fa.oneway
                t_first = a0[g.e_fi] + g.e_rel
                h_t0b = a0[g.h_fi] + g.h_rel
        elif g.uniform:
            # a0 is one shared value; the sort key is a monotone function
            # of the cached rel offsets, so only the recorded hazard pairs
            # can invalidate the cached order at this start time.
            k0 = fa.t_start + g.ow_c
            for r0, r1, tok in g.hazards:
                x0 = k0 + r0
                x1 = k0 + r1
                if not (x0 < x1 or (x0 == x1 and tok)):
                    g = fa.geom = self._build_geom(fa)
                    k0 = fa.t_start + g.ow_c
                    break
            t_first = None
            h_t0b = None
        else:
            a0 = fa.t_start + fa.oneway
            t_first = a0[g.e_fi] + g.e_rel
            if g.E > 1:
                d = np.diff(t_first)
                if not bool(np.all((d > 0) | ((d == 0) & g.tie_ok))):
                    g = fa.geom = self._build_geom(fa)
                    t_first = a0[g.e_fi] + g.e_rel
            h_t0b = a0[g.h_fi] + g.h_rel
        H = g.H

        if not enabled:
            if h_t0b is None:
                h_t0b = g.h_rel + k0
            # Ideal translation: every request resolves instantly; no
            # sequential state at all.  resolve == t0, rat == 0, no stalls.
            ctr.requests += g.n_tot
            ctr.by_class[L1_HIT] += g.n_tot
            tail = g.tail
            last = h_t0b.copy()
            last[tail] = np.maximum(
                last[tail], h_t0b[tail] + g.tail_prod[tail] + l1_lat)
            completion = (float((last + fab.hbm_ns + g.h_ret).max())
                          if H else 0.0)
            if completion < 0.0:
                completion = 0.0
            if collect_trace:
                self._write_trace(fi_base, g.e_fi, g.i0, g.i1, g.hcum,
                                  g.h_is0, g.h_ns, h_t0b, np.zeros(H),
                                  np.full(H, -INF), g.h_stride, ns, l1_lat)
            return completion

        # ---- warm fast path (DESIGN.md §15.2) ----------------------------
        # Every head is a first-branch L1 hit iff (a) no staged fill
        # commits at or before any head's lookup time and (b) every
        # (station, page) the call touches is resident.  Then the access
        # loop's only state change is LRU recency, applied batched below;
        # outputs are the all-hit expansion with zero skew and no stalls.
        if g.fp_enabled and H and not collect_trace:
            # max/min of h_t0b without the array: addition is commutative
            # and fl(k0 + rel) is monotone in rel, achieved at the argmax,
            # so fl(k0 + rel_max) IS max_i fl(k0 + rel_i) (same for min).
            if h_t0b is None:
                t1_max = (k0 + g.rel_max) + l1_lat
            else:
                t1_max = float(h_t0b.max()) + l1_lat
            l1s = self.state.l1
            mut_c = self.state.mut
            if (g.fp_mutc is mut_c and g.fp_epoch == mut_c[0]
                    and t1_max < g.fp_hmin and g.fp_chk[0] is l1s):
                # Epoch skip: no staging and no commit happened anywhere in
                # this state since the last full check, so every L1's
                # resident set and heap are exactly as observed then — the
                # same pages are still resident and the (unchanged)
                # earliest staged commit still lies beyond this window.
                # Recency moves don't bump the epoch; they can't change
                # either fact.  Verdict carries over without the loops.
                # The group (and so this memo) is shared by every session
                # that adopts its plan: another state's failed check
                # rebuilds the rows for its own L1s and leaves fp_mutc
                # alone, so the rows must be this state's too.
                rows = g.fp_chk[1]
                ok = True
            else:
                pairs = g.fp_pairs
                if pairs is None:
                    src = g.fp_src
                    if src is not None and src[0].fp_pairs is not None:
                        parent, dp = src
                        g.fp_sts = parent.fp_sts
                        pairs = [(s, p + dp) for s, p in parent.fp_pairs]
                    else:
                        hpage_l = g.hpage_l
                        if hpage_l is None:
                            hpage_l = g.hpage_l = g.page[g.h_e].tolist()
                        g.fp_sts, pairs = _fp_structs(g.st_l, hpage_l)
                    g.fp_pairs = pairs
                # Pre-resolved probe rows (cache, heap, resident set,
                # L1 set dict, page) per distinct touch, keyed on the
                # state's l1 list identity: a flush replaces that list, and
                # heaps / resident sets / set dicts are mutated in place,
                # never swapped, for a given _VLRU.
                chk = g.fp_chk
                if chk is None or chk[0] is not l1s:
                    rows = [(c, c._heap, c.resident,
                             c._sets[hash(p) % c.n_sets], p)
                            for s, p in pairs for c in (l1s[s],)]
                    g.fp_chk = (l1s, rows)
                else:
                    rows = chk[1]
                t1_min = None
                hmin = INF
                ok = True
                for c, hp, res_set, sd, p in rows:
                    if hp and hp[0][0] <= t1_max:
                        # Staged fills commit inside the window.  Those due
                        # before the *earliest* lookup can be committed now:
                        # the first access at this station commits exactly
                        # them, in the same heap order, before its own
                        # lookup — and no hit can touch this station's
                        # recency before that access.  So the drain is
                        # unobservable even if the fast path is then
                        # declined.
                        if t1_min is None:
                            t1_min = ((k0 + g.rel_min) + l1_lat
                                      if h_t0b is None
                                      else float(h_t0b.min()) + l1_lat)
                        if hp[0][0] <= t1_min:
                            c._commit(t1_min)
                        if hp and hp[0][0] <= t1_max:
                            ok = False
                            break
                    if p not in res_set:
                        ok = False
                        break
                    if hp and hp[0][0] < hmin:
                        hmin = hp[0][0]
                if ok:
                    g.fp_mutc = mut_c
                    g.fp_epoch = mut_c[0]
                    g.fp_hmin = hmin
            if ok:
                self.fastpath_calls += 1
                for row in rows:
                    row[3].move_to_end(row[4])
                n_all = H + g.fp_s_hit
                ctr.requests += n_all
                ctr.by_class[L1_HIT] += n_all
                if h_t0b is None and H <= 64:
                    # Scalar body for small uniform calls: the per-head
                    # expressions below are the numpy branch's, one float
                    # at a time with identical operand order, so the two
                    # bodies are interchangeable bit-for-bit.
                    sc = g.fp_scalars
                    if sc is None:
                        sc = g.fp_scalars = (
                            g.h_rel.tolist(), g.fp_hits.tolist(),
                            g.fp_tail_add.tolist(), g.h_ret.tolist())
                    rel_l, hits_l, tl_l, ret_l = sc
                    run = ctr.rat_ns_sum
                    m = -INF
                    comp = -INF
                    hbm = fab.hbm_ns
                    for i in range(H):
                        t0b = k0 + rel_l[i]
                        rat0 = (t0b + l1_lat) - t0b
                        run = run + rat0
                        run = run + hits_l[i]
                        if rat0 > m:
                            m = rat0
                        cand = (((t0b + tl_l[i]) + l1_lat) + hbm) + ret_l[i]
                        if cand > comp:
                            comp = cand
                    ctr.rat_ns_sum = run
                    if m > ctr.rat_ns_max:
                        ctr.rat_ns_max = m
                    if comp < 0.0:
                        comp = 0.0
                    return comp
                if h_t0b is None:
                    h_t0b = g.h_rel + k0
                res = h_t0b + l1_lat
                rat0 = res - h_t0b
                # Same left fold as the slow path with the exact-zero
                # hit-under-miss terms dropped (x + 0.0 == x).
                contrib = np.empty(2 * H + 1)
                contrib[0] = ctr.rat_ns_sum
                contrib[1::2] = rat0
                contrib[2::2] = g.fp_hits
                ctr.rat_ns_sum = float(np.cumsum(contrib)[-1])
                m = float(rat0.max())
                if m > ctr.rat_ns_max:
                    ctr.rat_ns_max = m
                # last = max(res, t0 + tail_prod + l1) elementwise; the
                # tail term dominates wherever it exists (tail_prod >= 0
                # and float add is monotone), and adding exact 0.0 on
                # non-tail heads reproduces res, so one fused expression
                # equals the slow path's masked maximum.
                last = (h_t0b + g.fp_tail_add) + l1_lat
                completion = float((last + fab.hbm_ns + g.h_ret).max())
                if completion < 0.0:
                    completion = 0.0
                return completion

        pf_cols = g.pf_cols
        if pf_cols and t_first is None:
            t_first = g.e_rel + k0
        if h_t0b is None:
            h_t0b = g.h_rel + k0

        # ---- sequential core: one state-machine access per head ----------
        access = self.state.access
        st_l = g.st_l
        t0b_l = h_t0b.tolist()
        ns_l = g.ns_l
        hpage_l = g.hpage_l
        if hpage_l is None:
            hpage_l = g.hpage_l = g.page[g.h_e].tolist()
        state = self.state
        maybe_l = state.l1_maybe
        pend_l = state.l1_pending
        l1s = state.l1
        neg_inf = -INF

        if g.no_bp and not pf_cols and H and H <= 160 and not collect_trace:
            # ---- fused scalar slow path (no-backpressure, small H) -------
            # Same access sequence and the same per-head tail-expansion
            # expressions as the vectorized block below, evaluated one
            # float at a time in head order — interchangeable bit-for-bit.
            # skew/consumed bookkeeping is dropped (see _Geom.no_bp).
            sc = g.sc_lists
            if sc is None:
                sc = g.sc_lists = (g.h_ns_m1.tolist(),
                                   g.h_stride.tolist(), g.h_ret.tolist())
            m1_l, stride_l, ret_l = sc
            ceil = math.ceil
            hbm = fab.hbm_ns
            run = ctr.rat_ns_sum
            rmax = neg_inf
            hmax = neg_inf
            comp = neg_inf
            s_hum = 0
            s_hit = 0
            k5 = [0, 0, 0, 0, 0]
            # Same repeat memo as the large no-backpressure loop below —
            # see the comment there for the safe-window argument.
            od = OrderedDict
            safe_l: List[Optional[float]] = [None] * ns
            memo_l: List[Optional[dict]] = [None] * ns
            for s, pg, t0b, m1, stride, ret in zip(
                    st_l, hpage_l, t0b_l, m1_l, stride_l, ret_l):
                t1 = t0b + l1_lat
                su = safe_l[s]
                if su is None:
                    hp = l1s[s]._heap
                    su = safe_l[s] = hp[0][0] if hp else INF
                    memo = memo_l[s] = {}
                else:
                    memo = memo_l[s]
                kls = -1
                if t1 < su:
                    v = memo.get(pg)
                    if v is not None:
                        if v.__class__ is od:
                            v.move_to_end(pg)
                            resolve = t1
                            kls = 0
                            fill = neg_inf
                        elif t1 < v:
                            resolve = v
                            fill = v
                            kls = 1
                if kls < 0:
                    cl = l1s[s]
                    if pg in maybe_l[s]:
                        hp = cl._heap
                        if hp and hp[0][0] <= t1:
                            cl._commit(t1)
                        sd = cl._sets[hash(pg) % cl.n_sets]
                        if pg in sd:
                            sd.move_to_end(pg)
                            resolve = t1
                            kls = 0
                            fill = neg_inf
                    if kls < 0:
                        pending = pend_l[s]
                        pend = pending.get(pg)
                        if pend is not None:
                            kls = 1
                            fill = pend
                            if pend <= t1:
                                del pending[pg]
                                resolve = t1
                            else:
                                resolve = pend
                        else:
                            resolve, kls, fill = access(s, pg, t0b)
                    hp = cl._heap
                    safe_l[s] = hp[0][0] if hp else INF
                    if t1 >= su:
                        memo.clear()
                    if kls == 0:
                        memo[pg] = sd
                    else:
                        memo[pg] = (resolve
                                    if kls == 1 and resolve != t1 else 0.0)
                k5[kls] += 1
                rat0 = resolve - t0b
                run = run + rat0
                if rat0 > rmax:
                    rmax = rat0
                last = resolve
                if m1 > 0:
                    k = 0
                    if fill > neg_inf:
                        kf = ceil(((fill - l1_lat) - t0b) / stride) - 1.0
                        m1f = float(m1)
                        if kf > m1f:
                            kf = m1f
                        if kf < 0.0:
                            kf = 0.0
                        k = int(kf)
                        if k > 0:
                            run = run + (k * (fill - t0b)
                                         - stride * k * (k + 1) / 2)
                            hc = fill - (t0b + stride)
                            if hc > hmax:
                                hmax = hc
                            if fill > last:
                                last = fill
                            s_hum += k
                    nh = m1 - k
                    if nh > 0:
                        run = run + nh * l1_lat
                        cand = (t0b + m1 * stride) + l1_lat
                        if cand > last:
                            last = cand
                        s_hit += nh
                c2 = (last + hbm) + ret
                if c2 > comp:
                    comp = c2
            ctr.requests += H + s_hum + s_hit
            by = ctr.by_class
            for idx, name in enumerate(CLASSES):
                if k5[idx]:
                    by[name] += k5[idx]
            by[L1_HUM] += s_hum
            by[L1_HIT] += s_hit
            ctr.rat_ns_sum = run
            m = ctr.rat_ns_max
            if rmax > m:
                m = rmax
            if hmax > m:
                m = hmax
            ctr.rat_ns_max = m
            if comp < 0.0:
                comp = 0.0
            return comp

        # ---- quiet-window grouped path (DESIGN.md §15.3) -----------------
        # Large no-backpressure calls where every *station's* lookup
        # window is narrower than the L2 hit latency: any fill staged on a
        # station *during* the call lands at least one L2 latency past the
        # staging access's lookup, i.e. strictly after every lookup at
        # that station — so at stations whose heaps are also quiet past
        # their window, no commit can fire for the whole call and
        # residency/MSHR state are frozen.  Each (station, page) group's
        # outcome then follows from its start-of-call state: resident
        # groups are all-hit, pending-past-the-window groups all
        # hit-under-miss, and a cold group resolves to whatever fill its
        # first head stages (always past the window, hence still pending
        # when read back).  Only those first heads — plus every head at a
        # non-quiet station or of a stale-pending group — run the
        # sequential machinery, in head order, preserving the exact
        # L2/PTW/commit interleaving the event engine sees.
        if g.no_bp and not pf_cols and H and not collect_trace:
            l2_lat = state._l2_lat
            # Per-station lookup windows.  The quiet argument is local to
            # a station: L1 residency/MSHR state is per station, and a
            # fill staged during the call lands at least one L2 hit
            # latency past the *staging* access's lookup — which is at or
            # after that station's first lookup.  So it suffices that each
            # station's own window is narrower than the L2 latency (the
            # old whole-call check is the degenerate one-window case);
            # large calls whose heads interleave many stations pass even
            # when the call-wide span is far wider.
            q2 = g.qg2
            if q2 is None:
                st_arr = np.asarray(st_l, dtype=np.int64)
                so = np.argsort(st_arr, kind="stable")
                sst = st_arr[so]
                starts = np.flatnonzero(np.diff(sst, prepend=-1) != 0)
                q2 = g.qg2 = (so, starts, sst[starts].tolist())
            so, starts, sts_l = q2
            hb = h_t0b[so]
            # min/max commute with the monotone ``+ l1_lat``, so these are
            # exactly the per-station min/max over the per-head t1 values.
            t1f = np.minimum.reduceat(hb, starts) + l1_lat
            t1l = np.maximum.reduceat(hb, starts) + l1_lat
            if bool((t1f + l2_lat > t1l).all()):
                win = dict(zip(sts_l, zip(t1f.tolist(), t1l.tolist())))
                qg = g.qg
                if qg is None:
                    qg = g.qg = _qg_structs(st_l, hpage_l, H)
                h2g, gfirst, order_last, gst, qsts = qg
                gp = g.qg_pages
                if gp is None:
                    gp = g.qg_pages = g.page[g.h_e[gfirst]].tolist()
                quiet = {}
                for s in qsts:
                    tf_s, tl_s = win[s]
                    c = l1s[s]
                    hp = c._heap
                    q = True
                    if hp and hp[0][0] <= tl_s:
                        # Same unobservable pre-commit drain as the warm
                        # fast path: the first access at this station
                        # commits at least this much, in heap order,
                        # before anything can observe the station.
                        if hp[0][0] <= tf_s:
                            c._commit(tf_s)
                        q = not (hp and hp[0][0] <= tl_s)
                    quiet[s] = q
                U = len(gst)
                gcls_l = [0] * U
                gF = [0.0] * U
                for gi in range(U):
                    s = gst[gi]
                    if not quiet[s]:
                        gcls_l[gi] = 3
                        continue
                    pg = gp[gi]
                    if pg in l1s[s].resident:
                        # Resident implies maybe-listed on every fill
                        # path; the guard keeps the corner exact anyway.
                        if pg not in maybe_l[s]:
                            gcls_l[gi] = 3
                        continue
                    pend = pend_l[s].get(pg)
                    if pend is None:
                        gcls_l[gi] = 2
                    elif pend > win[s][1]:
                        gcls_l[gi] = 1
                        gF[gi] = pend
                    else:
                        gcls_l[gi] = 3
                gcls = np.asarray(gcls_l, dtype=np.int64)
                hc = gcls[h2g]
                # All-hit default columns: only class-0 heads keep them —
                # classes 1/2 are overwritten batched below, class 3 and
                # cold leaders by the sequential loop.  (h_t0b + l1_lat)
                # masked afterwards equals the old masked elementwise add.
                res_a = h_t0b + l1_lat
                fill_a = np.full(H, neg_inf)
                cls_a = np.where(hc == 2, 1, hc)
                p1 = hc == 3
                lead = gfirst[gcls == 2]
                if len(lead):
                    p1[lead] = True
                for i in np.flatnonzero(p1).tolist():
                    s = st_l[i]
                    pg = hpage_l[i]
                    t0b = t0b_l[i]
                    t1 = t0b + l1_lat
                    kls = -1
                    if pg in maybe_l[s]:
                        c = l1s[s]
                        hp = c._heap
                        if hp and hp[0][0] <= t1:
                            c._commit(t1)
                        sd = c._sets[hash(pg) % c.n_sets]
                        if pg in sd:
                            sd.move_to_end(pg)
                            resolve = t1
                            kls = 0
                            fill = neg_inf
                    if kls < 0:
                        pending = pend_l[s]
                        pend = pending.get(pg)
                        if pend is not None:
                            kls = 1
                            fill = pend
                            if pend <= t1:
                                del pending[pg]
                                resolve = t1
                            else:
                                resolve = pend
                        else:
                            resolve, kls, fill = access(s, pg, t0b)
                    res_a[i] = resolve
                    fill_a[i] = fill
                    cls_a[i] = kls
                need = (hc == 1) | ((hc == 2) & ~p1)
                if need.any():
                    # A cold group's leader staged its fill past the
                    # window, so it is still pending here; every remaining
                    # head is a hit-under-miss on it.
                    for gi in np.flatnonzero(gcls == 2).tolist():
                        gF[gi] = pend_l[gst[gi]][gp[gi]]
                    hF = np.asarray(gF)[h2g]
                    res_a[need] = hF[need]
                    fill_a[need] = hF[need]
                # Batched recency: one move per resident group in
                # last-touch order reproduces the loop's net effect — at
                # quiet stations only resident groups' heads touch
                # recency, and no commit interleaves with them.
                for gi in order_last.tolist():
                    if gcls_l[gi] == 0:
                        c = l1s[gst[gi]]
                        pg = gp[gi]
                        c._sets[hash(pg) % c.n_sets].move_to_end(pg)
                kcnt = np.bincount(cls_a, minlength=5)
                return self._finish(g, ctr, res_a, fill_a, h_t0b, kcnt,
                                    l1_lat, fab, False, fi_base, ns)

        skew = [0.0] * ns
        release = [-INF] * ns
        consumed = [0] * ns
        totals_l = g.totals_l
        ingress = fab.ingress_entries
        cover = self.buffer_cover
        stall_sum = self.stall_sum
        stall_n = self.stall_n
        # Heads run strictly in flat order (epoch-sorted, station sub-order
        # inside each epoch), so per-head outputs are append-only.
        res_l: List[float] = []
        fill_l: List[float] = []
        t0_l: List[float] = []
        kc = [0, 0, 0, 0, 0]          # per-class head counts, CLASSES order
        res_app, fill_app = res_l.append, fill_l.append
        t0_app = t0_l.append
        t0_arr = None
        probes = 0
        if pf_cols:
            # Epoch-structured walk: each epoch's prefetch probes fire at
            # its first arrival, before its heads.
            h0_l = g.h0_l
            h1_l = g.h1_l
            tf_l = t_first.tolist()
            for e in range(g.E):
                tf = tf_l[e]
                for (valid, stj, pj) in pf_cols:
                    if valid[e]:
                        access(stj[e], pj[e], tf)
                        probes += 1
                for h in range(h0_l[e], h1_l[e]):
                    s = st_l[h]
                    t0 = t0b_l[h] + skew[s]
                    resolve, kls, fill = access(s, hpage_l[h], t0)
                    res_app(resolve)
                    fill_app(fill)
                    t0_app(t0)
                    kc[kls] += 1
                    # Ingress-buffer backpressure (same predicate
                    # expressions as the event engine, term for term).
                    if (resolve - (t0 + l1_lat) > 0
                            and totals_l[s] - consumed[s] >= ingress):
                        block_from = t0 + cover
                        r = release[s]
                        if r > block_from:
                            block_from = r
                        if resolve > block_from:
                            bubble = resolve - block_from
                            skew[s] += bubble
                            release[s] = resolve
                            stall_sum += bubble
                            stall_n += 1
                    consumed[s] += ns_l[h]
        elif g.no_bp:
            # No-backpressure loop: skew provably stays 0.0, so t0 is the
            # precomputed t0b array and the predicate/consumed bookkeeping
            # drops out.  Access branches inlined as in the general loop.
            #
            # Repeat memo: while a head's lookup time stays below the
            # station's next staged-commit time (``safe`` tracks the heap
            # top as of the station's last slow head), no commit can have
            # changed residency in between, so a repeat of an earlier
            # head's (station, page) resolves identically:
            #  * an L1 hit repeats as an L1 hit at its own t1 — the only
            #    state change is the recency move, replayed through the
            #    memoized set dict (identical to the full branch's
            #    move_to_end, minus the probes);
            #  * a still-pending MSHR fill repeats as the same
            #    hit-under-miss (its own fill time is the memoized value,
            #    past the lookup, so the entry wasn't deleted).
            # Any head that may have committed (t1 >= safe) kills the
            # station's memo.  ~90% of churn-call heads repeat one of a
            # handful of pairs, so this replaces the branch chain with one
            # dict probe for most of the call.  Both replay kinds share the
            # dict, tagged by value type: an L1 set dict replays a hit, a
            # float replays a still-pending fill (a pair's kind is stable
            # within a safe window — changing it requires a commit, which
            # ends the window).
            t0_arr = h_t0b
            od = OrderedDict
            safe_l: List[Optional[float]] = [None] * ns
            memo_l: List[Optional[dict]] = [None] * ns
            for s, pg, t0b in zip(st_l, hpage_l, t0b_l):
                t1 = t0b + l1_lat
                su = safe_l[s]
                if su is None:
                    hp = l1s[s]._heap
                    su = safe_l[s] = hp[0][0] if hp else INF
                    memo = memo_l[s] = {}
                else:
                    memo = memo_l[s]
                if t1 < su:
                    v = memo.get(pg)
                    if v is not None:
                        if v.__class__ is od:
                            v.move_to_end(pg)
                            res_app(t1)
                            fill_app(neg_inf)
                            kc[0] += 1
                            continue
                        if t1 < v:
                            res_app(v)
                            fill_app(v)
                            kc[1] += 1
                            continue
                cl = l1s[s]
                kls = -1
                if pg in maybe_l[s]:
                    hp = cl._heap
                    if hp and hp[0][0] <= t1:
                        cl._commit(t1)
                    sd = cl._sets[hash(pg) % cl.n_sets]
                    if pg in sd:
                        sd.move_to_end(pg)
                        resolve = t1
                        kls = 0
                        fill = neg_inf
                if kls < 0:
                    pending = pend_l[s]
                    pend = pending.get(pg)
                    if pend is not None:
                        kls = 1
                        fill = pend
                        if pend <= t1:
                            del pending[pg]
                            resolve = t1
                        else:
                            resolve = pend
                    else:
                        resolve, kls, fill = access(s, pg, t0b)
                hp = cl._heap
                safe_l[s] = hp[0][0] if hp else INF
                if t1 >= su:
                    memo.clear()
                if kls == 0:
                    memo[pg] = sd
                else:
                    # A delete or a staged fill forces the next same-page
                    # head back through the chain (0.0 never replays).
                    memo[pg] = resolve if kls == 1 and resolve != t1 else 0.0
                res_app(resolve)
                fill_app(fill)
                kc[kls] += 1
        else:
            # The first two branches of VecTranslationState.access (L1 hit
            # and MSHR hit-under-miss — ~all steady-state traffic) are
            # inlined; the method handles L2 and walks.  Falling through
            # to access() after an inlined miss is stateless: re-checking
            # the committed-to time commits nothing more, and a missed set
            # probe touches no recency.
            for s, pg, t0b, nsh in zip(st_l, hpage_l, t0b_l, ns_l):
                t0 = t0b + skew[s]
                t1 = t0 + l1_lat
                kls = -1
                if pg in maybe_l[s]:
                    c = l1s[s]
                    hp = c._heap
                    if hp and hp[0][0] <= t1:
                        c._commit(t1)
                    sd = c._sets[hash(pg) % c.n_sets]
                    if pg in sd:
                        sd.move_to_end(pg)
                        resolve = t1
                        kls = 0
                        fill = neg_inf
                if kls < 0:
                    pending = pend_l[s]
                    pend = pending.get(pg)
                    if pend is not None:
                        kls = 1
                        fill = pend
                        if pend <= t1:
                            del pending[pg]
                            resolve = t1
                        else:
                            resolve = pend
                    else:
                        resolve, kls, fill = access(s, pg, t0)
                res_app(resolve)
                fill_app(fill)
                t0_app(t0)
                kc[kls] += 1
                if (resolve - t1 > 0
                        and totals_l[s] - consumed[s] >= ingress):
                    block_from = t0 + cover
                    r = release[s]
                    if r > block_from:
                        block_from = r
                    if resolve > block_from:
                        bubble = resolve - block_from
                        skew[s] += bubble
                        release[s] = resolve
                        stall_sum += bubble
                        stall_n += 1
                consumed[s] += nsh
        self.stall_sum = stall_sum
        self.stall_n = stall_n
        if probes:
            ctr.probes += probes
        res = np.asarray(res_l)
        fill = np.asarray(fill_l)
        t0 = t0_arr if t0_arr is not None else np.asarray(t0_l)
        return self._finish(g, ctr, res, fill, t0, kc, l1_lat, fab,
                            collect_trace, fi_base, ns)

    def _finish(self, g, ctr, res, fill, t0, kcnt, l1_lat, fab,
                collect_trace, fi_base, ns) -> float:
        """Deferred vectorized tail expansion over per-head outputs.

        Shared by the sequential core and the quiet-window grouped path:
        everything past the access loop depends only on the per-head
        (resolve, fill, class) columns, not on how they were produced.
        """
        H = g.H
        rat0 = res - t0
        tail = g.tail
        h_stride = g.h_stride
        if kcnt[0]:
            finite = fill > -INF
            fill_safe = np.where(finite, fill, 0.0)
            tf = finite if g.tail_all else tail & finite
        else:
            # Only L1 hits record a -INF fill, so with none of them every
            # fill is finite: the finite mask and the zero substitution
            # are elementwise identities and can be skipped.
            fill_safe = fill
            tf = None if g.tail_all else tail
        # k_hum = max(0, min(n_s - 1, ceil((fill - l1_lat - t0)/stride) - 1))
        # computed in float (exact: the clamp bounds are far below 2^53).
        kf = np.ceil((fill_safe - l1_lat - t0) / h_stride) - 1.0
        kf = np.maximum(np.minimum(kf, g.h_ns_m1f), 0.0)
        k_hum = (kf if tf is None else np.where(tf, kf, 0.0)).astype(np.int64)
        hum = k_hum * (fill_safe - t0) - h_stride * k_hum * (k_hum + 1) / 2
        hum = np.where(k_hum > 0, hum, 0.0)
        # h_ns_m1 is zero exactly where tail is False and k_hum is masked
        # to zero there, so the plain difference equals the old
        # tail-masked form element for element.
        n_hit = g.h_ns_m1 - k_hum
        hits = n_hit * l1_lat

        s_hum = int(k_hum.sum())
        s_hit = int(n_hit.sum())
        ctr.requests += H + s_hum + s_hit
        by = ctr.by_class
        for idx, name in enumerate(CLASSES):
            if kcnt[idx]:
                by[name] += int(kcnt[idx])
        by[L1_HUM] += s_hum
        by[L1_HIT] += s_hit

        # rat_ns_sum: strict left fold over [rat0, hum, hits] per head, in
        # head order, seeded with the running value — cumsum is sequential,
        # and the zero terms the event engine skips are exact no-ops.
        contrib = np.empty(3 * H + 1)
        contrib[0] = ctr.rat_ns_sum
        contrib[1::3] = rat0
        contrib[2::3] = hum
        contrib[3::3] = hits
        ctr.rat_ns_sum = float(np.cumsum(contrib)[-1])

        if H:
            m = max(ctr.rat_ns_max, float(rat0.max()))
            hmax = float(np.where(k_hum > 0,
                                  fill_safe - (t0 + h_stride), -INF).max())
            if hmax > m:
                m = hmax
            ctr.rat_ns_max = m

        last = res.copy()
        khm = k_hum > 0
        last[khm] = np.maximum(last[khm], fill[khm])
        nhm = n_hit > 0
        last[nhm] = np.maximum(
            last[nhm],
            t0[nhm] + (g.h_ns[nhm] - 1) * h_stride[nhm] + l1_lat)
        completion = float((last + fab.hbm_ns + g.h_ret).max()) if H else 0.0
        if completion < 0.0:
            completion = 0.0

        if collect_trace:
            self._write_trace(fi_base, g.e_fi, g.i0, g.i1, g.hcum, g.h_is0,
                              g.h_ns, t0, rat0, fill, h_stride, ns, l1_lat,
                              res=None)
        return completion

    # -- tracing -------------------------------------------------------------
    def _write_trace(self, fi_base, e_fi, i0, i1, hcum, h_is0, h_ns, t0,
                     rat0, fill, h_stride, ns, l1_lat, res=None) -> None:
        """Per-epoch trace rows, same expressions as the event engine."""
        for e in range(len(e_fi)):
            tr = np.empty(int(i1[e] - i0[e]))
            for h in range(int(hcum[e]), int(hcum[e + 1])):
                pos = int(h_is0[h] - i0[e])
                tr[pos] = rat0[h]
                nsh = int(h_ns[h])
                if nsh > 1:
                    ks = np.arange(1, nsh)
                    arr = t0[h] + ks * h_stride[h]
                    f = fill[h]
                    lat = np.maximum(arr + l1_lat,
                                     f if f > -INF else 0.0) - arr
                    tr[pos + ks * ns] = np.maximum(lat, l1_lat)
            self.trace_chunks.append((fi_base + int(e_fi[e]), int(i0[e]), tr))
