"""Collective traffic patterns for the RAT simulator (DESIGN.md §5).

The paper evaluates Reverse Address Translation only on the all-pairs
AllToAll schedule; this module generalizes the simulator to the collective
algorithms that dominate real training/inference traffic.  A
:class:`CollectivePattern` emits, for each *step* of the algorithm, the set
of (src, dst) flows arriving at every target GPU — the engine and the
reference DES replay exactly these flow sets, so oracle-equivalence tests
bind for every pattern.

Semantics shared by all patterns (DESIGN.md §5.1):

  * ``nbytes`` is the per-GPU buffer size of the collective (the amount of
    data each participant holds/ends with), so sizes are comparable across
    patterns.  Chunked algorithms move ``nbytes // n_gpus`` per chunk.
  * A *step* is a dependency barrier: every flow of step ``k+1`` starts only
    after all flows of step ``k`` complete (ring/tree algorithms forward data
    they received in the previous step).
  * ``FlowSpec.offset`` is the byte offset inside the destination GPU's
    receive region; it determines which pages (and hence which Link-TLB
    entries) the flow touches.  Patterns that revisit the same region across
    steps (e.g. recursive doubling) hit warm TLB entries after step 0 —
    exactly the locality difference this abstraction exists to expose.
  * Patterns with ``symmetric=True`` load every GPU identically in every
    step, so simulating a single representative target is exact; asymmetric
    patterns (broadcast) force the engine into every-target mode regardless
    of ``SimConfig.symmetric``.

Only addresses and byte counts matter to the translation model, so
reduction semantics are not modelled: ring ReduceScatter and ring AllGather
emit identical flow sets, and "AllReduce" costs are pure communication time
(no reduction FLOPs).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Type

import numpy as np

from .config import FabricConfig
from .topology import get_topology


@dataclass(frozen=True)
class FlowSpec:
    """One (src -> dst) stream within a single collective step.

    ``offset`` addresses the flow inside dst's receive region; the engine
    turns it into an NPA by adding the per-GPU region base.
    """

    src: int
    dst: int
    nbytes: int
    offset: int


@dataclass
class StepArrays:
    """One collective step as parallel columns (vectorized engine form).

    Row ``i`` is exactly ``steps()[k][i]`` — same flows, same order — so the
    event engine and the vectorized engine consume the *same* schedule, just
    materialized as arrays instead of per-flow objects.  ``out_deg``/
    ``tier_deg`` are lazily cached per-step aggregates (they depend only on
    the step, not on the simulated target).
    """

    src: np.ndarray       # int64
    dst: np.ndarray       # int64
    nbytes: np.ndarray    # int64
    offset: np.ndarray    # int64
    _out_deg: Optional[np.ndarray] = field(default=None, repr=False)
    _tier_cache: Optional[tuple] = field(default=None, repr=False)

    @classmethod
    def from_specs(cls, step: List[FlowSpec]) -> "StepArrays":
        n = len(step)
        return cls(
            src=np.fromiter((s.src for s in step), np.int64, n),
            dst=np.fromiter((s.dst for s in step), np.int64, n),
            nbytes=np.fromiter((s.nbytes for s in step), np.int64, n),
            offset=np.fromiter((s.offset for s in step), np.int64, n))

    def with_stride(self, stride: int) -> "StepArrays":
        """Logical ranks placed on strided pod GPUs (resolve_collective)."""
        return StepArrays(src=self.src * stride, dst=self.dst * stride,
                          nbytes=self.nbytes, offset=self.offset)

    def out_deg(self) -> np.ndarray:
        """Per-source concurrent-flow count of this step (ALL flows — the
        event engine counts zero-byte flows toward the bandwidth split)."""
        if self._out_deg is None:
            self._out_deg = np.bincount(
                self.src, minlength=int(self.src.max()) + 1 if len(self.src)
                else 1)
        return self._out_deg


# Concrete pattern registry and logical equivalence classes, populated at
# class-definition site by @register_pattern (DESIGN.md §14).  A *logical*
# collective names the communication result ("allreduce"); its class lists
# the registered algorithms that produce it, in registration order.  Four of
# the five logical classes are named after their canonical member, so those
# names are simultaneously a concrete registry key and a logical class key —
# resolution order is defined by the policy layer (repro_torch.core.select).
PATTERNS: Dict[str, Type["CollectivePattern"]] = {}
LOGICAL: Dict[str, List[str]] = {}


def register_pattern(cls=None, *, logical: Optional[str] = None):
    """Class decorator registering a :class:`CollectivePattern`.

    Registers ``cls`` under ``cls.name`` in :data:`PATTERNS` and appends it
    to the ``logical`` equivalence class in :data:`LOGICAL` (default: its
    own name forms a singleton class).  Registry and class membership live
    at the definition site, so adding an algorithm is one decorated class.
    """
    def _register(cls):
        name = cls.name
        if name in PATTERNS:
            raise ValueError(f"duplicate collective pattern {name!r}")
        PATTERNS[name] = cls
        LOGICAL.setdefault(logical or name, []).append(name)
        return cls
    return _register(cls) if cls is not None else _register


def logical_of(name: str) -> str:
    """The logical equivalence class a concrete pattern belongs to."""
    for logical, members in LOGICAL.items():
        if name in members:
            return logical
    raise ValueError(
        f"unknown collective {name!r}; known: {sorted(PATTERNS)}")


def candidates_for(logical: str, fab: FabricConfig) -> List[str]:
    """Concrete algorithms that can produce ``logical`` on this fabric.

    ``fab`` carries the topology *and* the participating GPU count, which is
    what per-pattern feasibility depends on (power-of-two ranks for
    recursive doubling, group divisibility for the hierarchical variants).
    Registration order; a concrete name is accepted and answers with the
    rest of its own equivalence class.
    """
    if logical not in LOGICAL:
        if logical in PATTERNS:
            logical = logical_of(logical)
        else:
            raise ValueError(
                f"unknown collective {logical!r}; known: {sorted(PATTERNS)}"
                f"; logical classes: {sorted(LOGICAL)}")
    return [name for name in LOGICAL[logical]
            if PATTERNS[name].feasible(fab)]


class CollectivePattern:
    """Base class: a collective algorithm as per-step flow sets."""

    name: str = "abstract"
    symmetric: bool = True

    @classmethod
    def feasible(cls, fab: FabricConfig) -> bool:
        """Whether this algorithm can run on ``fab`` (group size/topology
        preconditions); infeasible patterns are excluded from
        :func:`candidates_for` instead of raising inside :meth:`steps`."""
        return fab.n_gpus >= 2

    def steps(self, nbytes: int, fab: FabricConfig) -> List[List[FlowSpec]]:
        """Flow sets of each dependency step, in execution order."""
        raise NotImplementedError

    def steps_arrays(self, nbytes: int,
                     fab: FabricConfig) -> List[StepArrays]:
        """The same schedule as :meth:`steps`, as :class:`StepArrays`.

        The base fallback converts the object form row-for-row (exact for
        every pattern); hot patterns override with native array
        construction that never materializes per-flow objects.
        """
        return [StepArrays.from_specs(step)
                for step in self.steps(nbytes, fab)]

    def total_bytes(self, nbytes: int, fab: FabricConfig) -> int:
        """Total bytes crossing the fabric (all steps, all pairs)."""
        return sum(s.nbytes for step in self.steps(nbytes, fab) for s in step)

    def representative_dst(self, fab: FabricConfig) -> int:
        """The target GPU simulated in symmetric mode."""
        return 0


@register_pattern(logical="all_to_all")
class AllToAll(CollectivePattern):
    """All-pairs/direct AllToAll (MSCCLang): the paper's workload.

    One step; every GPU streams one ``nbytes // n`` chunk to every peer
    concurrently.  This is the seed engine's hard-wired schedule, kept
    bit-for-bit identical as the default pattern.
    """

    name = "all_to_all"

    def steps(self, nbytes, fab):
        n = fab.n_gpus
        chunk = nbytes // n  # self-chunk stays local
        step = [FlowSpec(src=src, dst=dst, nbytes=chunk, offset=src * chunk)
                for dst in range(n) for src in range(n) if src != dst]
        return [step]

    def steps_arrays(self, nbytes, fab):
        # Native array construction preserving steps()'s dst-major order
        # (``for dst ... for src ... if src != dst``) — the O(n^2) listcomp
        # dominates pod-scale sweep points, so the vectorized engine never
        # pays it.
        n = fab.n_gpus
        chunk = nbytes // n
        r = np.arange(n, dtype=np.int64)
        dst = np.repeat(r, n)
        src = np.tile(r, n)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        return [StepArrays(src=src, dst=dst,
                           nbytes=np.full(len(src), chunk, dtype=np.int64),
                           offset=src * chunk)]


@register_pattern(logical="allreduce")
class RingAllReduce(CollectivePattern):
    """Bandwidth-optimal ring AllReduce: reduce-scatter then allgather.

    2(n-1) steps; in every step each GPU sends one ``nbytes // n`` chunk to
    its ring successor.  The chunk index rotates, so each step touches a
    different slice of the target's buffer — for buffers smaller than
    ``n_gpus`` pages, successive chunks share pages and warm the TLBs.
    """

    name = "ring_allreduce"

    def steps(self, nbytes, fab):
        n = fab.n_gpus
        chunk = nbytes // n
        steps = []
        # Reduce-scatter phase: step s, GPU r forwards chunk (r - s) mod n.
        for s in range(n - 1):
            steps.append([
                FlowSpec(src=r, dst=(r + 1) % n, nbytes=chunk,
                         offset=((r - s) % n) * chunk)
                for r in range(n)])
        # Allgather phase: GPU r owns reduced chunk (r + 1) mod n and
        # circulates it; step s forwards chunk (r + 1 - s) mod n.
        for s in range(n - 1):
            steps.append([
                FlowSpec(src=r, dst=(r + 1) % n, nbytes=chunk,
                         offset=((r + 1 - s) % n) * chunk)
                for r in range(n)])
        return steps


@register_pattern(logical="allreduce")
class RecursiveDoublingAllReduce(CollectivePattern):
    """Latency-optimal recursive-doubling AllReduce (power-of-two pods).

    log2(n) steps; in step s each GPU exchanges the *full* buffer with
    partner ``rank XOR 2**s``.  Every step rewrites the same region, so all
    pages are warm after step 0 — but the partner (and hence the station
    striping) changes each step, exercising the per-station L1 / shared L2
    split of the hierarchy.
    """

    name = "rd_allreduce"

    @classmethod
    def feasible(cls, fab):
        n = fab.n_gpus
        return n >= 2 and not (n & (n - 1))

    def steps(self, nbytes, fab):
        n = fab.n_gpus
        if n < 2 or n & (n - 1):
            raise ValueError(
                f"rd_allreduce requires a power-of-two GPU count, got {n}")
        return [[FlowSpec(src=r, dst=r ^ (1 << s), nbytes=nbytes, offset=0)
                 for r in range(n)]
                for s in range(n.bit_length() - 1)]


@register_pattern(logical="all_gather")
class RingAllGather(CollectivePattern):
    """Ring AllGather: each GPU ends with the ``nbytes`` concatenation.

    n-1 steps; GPU r starts owning chunk r (``nbytes // n``) and forwards
    chunk (r - s) mod n to its successor in step s.
    """

    name = "all_gather"

    def steps(self, nbytes, fab):
        n = fab.n_gpus
        chunk = nbytes // n
        return [[FlowSpec(src=r, dst=(r + 1) % n, nbytes=chunk,
                          offset=((r - s) % n) * chunk)
                 for r in range(n)]
                for s in range(n - 1)]


@register_pattern(logical="reduce_scatter")
class RingReduceScatter(RingAllGather):
    """Ring ReduceScatter: traffic-identical to ring AllGather.

    The translation model only sees addresses and bytes, so the reduction
    on arrival is free; kept as a distinct named pattern for API clarity
    (and so reduction-aware extensions have a seam to hook into).
    """

    name = "reduce_scatter"


@register_pattern(logical="broadcast")
class BinomialBroadcast(CollectivePattern):
    """Binomial-tree broadcast from root 0 (any GPU count).

    ceil(log2(n)) steps; in step s every rank below ``2**s`` that has the
    data forwards the full buffer to ``rank + 2**s``.  Asymmetric: each
    non-root GPU receives exactly once, so the engine simulates every
    receiving target and the step barrier models the forwarding dependency.
    """

    name = "broadcast"
    symmetric = False

    def steps(self, nbytes, fab):
        n = fab.n_gpus
        steps = []
        s = 0
        while (1 << s) < n:
            step = [FlowSpec(src=r, dst=r + (1 << s), nbytes=nbytes, offset=0)
                    for r in range(1 << s) if r + (1 << s) < n]
            if step:
                steps.append(step)
            s += 1
        return steps


@register_pattern(logical="all_to_all")
class HierarchicalAllToAll(CollectivePattern):
    """Two-level AllToAll: intra-group gather, then inter-group exchange.

    The group is derived from the fabric topology
    (:meth:`~repro_torch.core.topology.Topology.local_group`): the historical
    ``gpus_per_node`` node split on the flat default, the *leaf* on
    ``two_tier`` — so the intra phase stays on the cheap tier and only the
    aggregated exchange crosses the spine.

    Phase 1: within each ``g``-GPU group, GPU i hands local peer p the
    chunks destined for p's rail (one ``nbytes // n`` chunk per group) —
    (g-1) flows of ``nbytes // g`` per GPU into a staging region above the
    final buffer.  Phase 2: each GPU exchanges aggregated group-chunks with
    its (n/g - 1) rail counterparts — flows of ``g * nbytes // n`` landing
    at the final buffer offset of the sender's group.  Fewer, larger flows
    per step than direct AllToAll: fewer cold pages per step at the cost of
    2x fabric volume (approximately; exactly (g-1)/g + (m-1)/m of nbytes
    per GPU vs (n-1)/n).
    """

    name = "hier_all_to_all"

    def _group(self, fab: FabricConfig) -> int:
        return get_topology(fab).local_group()

    @classmethod
    def feasible(cls, fab):
        if fab.n_gpus < 2:
            return False
        g = cls()._group(fab)
        return g > 0 and fab.n_gpus % g == 0

    def steps(self, nbytes, fab):
        n, g = fab.n_gpus, self._group(fab)
        if g <= 0 or n % g:
            raise ValueError(
                f"{self.name} needs n_gpus divisible by the topology group "
                f"(got {n} / {g})")
        m = n // g  # nodes
        chunk = nbytes // n
        steps = []
        if g > 1:
            intra = []
            for src in range(n):
                node = src // g
                for p in range(g):
                    dst = node * g + p
                    if dst != src:
                        intra.append(FlowSpec(
                            src=src, dst=dst, nbytes=m * chunk,
                            offset=nbytes + (src % g) * m * chunk))
            steps.append(intra)
        if m > 1:
            inter = []
            for src in range(n):
                p, node = src % g, src // g
                for k in range(m):
                    if k != node:
                        inter.append(FlowSpec(
                            src=src, dst=k * g + p, nbytes=g * chunk,
                            offset=node * g * chunk))
            steps.append(inter)
        return steps


@register_pattern(logical="all_to_all")
class MultiPodAllToAll(HierarchicalAllToAll):
    """Pod-granular two-phase AllToAll for ``multi_pod`` topologies.

    Same two-phase structure as :class:`HierarchicalAllToAll` but grouped
    at the *pod* (:meth:`~repro_torch.core.topology.Topology.pod_group`): phase 1
    stages chunks with intra-pod rail peers on the cheap Clos tier, phase 2
    exchanges pod-aggregated chunks with rail counterparts across the
    scale-out hop — exactly (pods - 1) oversubscribed crossings per GPU
    instead of the (n - n/pods) a direct AllToAll would pay.  On the flat
    default topology the pod group degenerates to ``gpus_per_node`` and the
    pattern coincides with ``hier_all_to_all``.
    """

    name = "multipod_all_to_all"

    def _group(self, fab: FabricConfig) -> int:
        return get_topology(fab).pod_group()


def kv_block(fab: FabricConfig) -> int:
    """Prefill-side GPU count of the KV-transfer pair (DESIGN.md §16).

    On ``multi_pod`` this is the pod: the transfer crosses the scale-out
    hop from pod 0 to pod 1.  Topologies without a real pod boundary split
    the fabric in half, so the pattern stays runnable (and comparable)
    everywhere — it just doesn't cross an oversubscribed tier there.
    """
    pods = get_topology(fab).n_pods()
    return fab.n_gpus // pods if pods >= 2 else fab.n_gpus // 2


@register_pattern(logical="kv_transfer")
class KVTransfer(CollectivePattern):
    """Rail-aligned KV-cache push across the ``multi_pod`` scale-out hop.

    The disaggregated-serving handoff (DESIGN.md §16): the KV cache a
    prefill pod produced, sharded one ``nbytes`` slice per prefill GPU,
    moves to the decode pod that will generate tokens against it.  Rank i
    of pod 0 streams its full shard to rank i of pod 1 — one step,
    ``pod_size`` concurrent flows, every one crossing the oversubscribed
    inter-pod tier and paying reverse translation at the *decode* pod's
    Link-MMU.  Each decode GPU receives into offset 0 of its KV arena, so
    the first transfer after a flush walks every page of the shard and
    later transfers into the same arena run warm — the two-regime
    mechanism fig18 measures.

    Asymmetric by construction (prefill ranks receive nothing), so the
    engine simulates every receiving decode target.
    """

    name = "kv_transfer"
    symmetric = False

    @classmethod
    def feasible(cls, fab):
        return fab.n_gpus >= 2 and kv_block(fab) >= 1 \
            and 2 * kv_block(fab) <= fab.n_gpus

    def steps(self, nbytes, fab):
        block = kv_block(fab)
        return [[FlowSpec(src=i, dst=block + i, nbytes=nbytes, offset=0)
                 for i in range(block)]]


@register_pattern(logical="kv_transfer")
class KVTransferStriped(KVTransfer):
    """Re-sharding KV push: every prefill rank stripes to every decode rank.

    Same payload as :class:`KVTransfer` (``block * nbytes`` total) but
    each prefill rank splits its shard into ``block`` stripes, one per
    decode rank — the layout changes pods, which is what a decode pod with
    a different TP split needs.  Each decode GPU receives ``block``
    small flows instead of one large one: same pages walked, finer-grained
    arrival, more concurrent flows per source splitting the inter-pod
    capacity — the trade the selection policy (DESIGN.md §14) prices.
    """

    name = "kv_transfer_striped"

    def steps(self, nbytes, fab):
        block = kv_block(fab)
        stripe = nbytes // block
        return [[FlowSpec(src=i, dst=block + j, nbytes=stripe,
                          offset=i * stripe)
                 for i in range(block) for j in range(block)]]


def get_pattern(name: str) -> CollectivePattern:
    """Instantiate a registered pattern by name."""
    try:
        return PATTERNS[name]()
    except KeyError:
        raise ValueError(
            f"unknown collective {name!r}; known: {sorted(PATTERNS)}"
            f"; logical classes: {sorted(LOGICAL)} (logical names resolve "
            f"through a policy — repro_torch.core.select)") from None


def simulated_dsts(pattern: CollectivePattern, step_specs, symmetric: bool,
                   fab: FabricConfig) -> List[int]:
    """Target GPUs a simulator must model for this pattern.

    Shared by the epoch engine and the reference DES — oracle-equivalence
    tests only bind if both sides simulate the same target set.
    """
    if symmetric and pattern.symmetric:
        return [pattern.representative_dst(fab)]
    return sorted({s.dst for step in step_specs for s in step}) or [0]


def simulated_dsts_arrays(pattern: CollectivePattern,
                          step_arrays: List[StepArrays], symmetric: bool,
                          fab: FabricConfig) -> List[int]:
    """:func:`simulated_dsts` for the :class:`StepArrays` schedule form."""
    if symmetric and pattern.symmetric:
        return [pattern.representative_dst(fab)]
    ds: set = set()
    for st in step_arrays:
        ds.update(np.unique(st.dst).tolist())
    return sorted(ds) or [0]


def analytic_volume(name: str, nbytes: int, fab: FabricConfig) -> int:
    """Closed-form total fabric bytes of a collective (conservation oracle).

    Independent of :meth:`CollectivePattern.steps` so tests can check the
    emitted flow sets against it.
    """
    n = fab.n_gpus
    chunk = nbytes // n
    if name == "all_to_all":
        return n * (n - 1) * chunk
    if name == "ring_allreduce":
        return 2 * (n - 1) * n * chunk
    if name == "rd_allreduce":
        return (n.bit_length() - 1) * n * nbytes
    if name in ("all_gather", "reduce_scatter"):
        return (n - 1) * n * chunk
    if name == "broadcast":
        return (n - 1) * nbytes
    if name in ("hier_all_to_all", "multipod_all_to_all"):
        topo = get_topology(fab)
        g = (topo.local_group() if name == "hier_all_to_all"
             else topo.pod_group())
        m = n // g
        return n * ((g - 1) * m * chunk + (m - 1) * g * chunk)
    if name in ("kv_transfer", "kv_transfer_striped"):
        block = kv_block(fab)
        if name == "kv_transfer":
            return block * nbytes
        return block * block * (nbytes // block)
    raise ValueError(f"no analytic volume for {name!r}")
