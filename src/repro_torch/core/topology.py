"""Fabric topologies for the RAT simulator (DESIGN.md §10).

The paper's pod is a single-level Clos: every src→dst pair sees one constant
fabric latency (``FabricConfig.oneway_ns``) and every source's flows share
one flat station pool.  Emerging scale-up fabrics are hierarchical — leaf
switches under an (often oversubscribed) spine tier, or several Clos pods
joined over a scale-out hop — and both the extra tier latency and the
tier-shared bandwidth reshape where translation stalls land.

A :class:`Topology` answers, for a given :class:`~repro_torch.core.config.
FabricConfig`, three questions the flow-materialization layer asks:

* ``path_latency_ns(src, dst)`` / ``return_latency_ns(dst, src)`` — the
  one-way request and ack latencies of the (src, dst) pair.  Single source
  of truth for the epoch engine *and* the reference DES, so per-topology
  oracle equivalence holds by construction.
* ``tier(src, dst)`` + ``tier_capacity(tier)`` — which latency/bandwidth
  tier the pair crosses, and the per-source byte/ns capacity of that tier
  (``None`` = unconstrained beyond the flat station pool).  A source's
  concurrent flows crossing a capacity-limited tier split *that tier's*
  bandwidth; the engine takes the max of the station-pool share and the
  tier share (DESIGN.md §10.2).
* ``tier0_group()`` / ``local_group()`` / ``pod_group()`` — GPU-group sizes
  hierarchical collective patterns and the EP/TP/DP placement logic derive
  their phase structure from.

``single_clos`` is the bit-for-bit default: tier 0 everywhere, latencies
exactly ``FabricConfig.oneway_ns``/``return_ns``, no tier capacity — the
engine's arithmetic reduces to the pre-topology expressions.
"""
from __future__ import annotations

import functools
from typing import TYPE_CHECKING, Dict, Optional, Type

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .config import FabricConfig


class Topology:
    """One pod topology bound to a concrete :class:`FabricConfig`.

    ``flat`` marks the degenerate single-tier case: the engine skips tier
    bookkeeping entirely on flat topologies, which is what keeps the
    ``single_clos`` default bit-for-bit identical to the pre-topology code.
    """

    name: str = "abstract"
    flat: bool = False

    def __init__(self, fab: "FabricConfig"):
        self.fab = fab

    # -- latency -----------------------------------------------------------
    def path_latency_ns(self, src: int, dst: int) -> float:
        """Source CU -> target station latency of one request."""
        raise NotImplementedError

    def return_latency_ns(self, dst: int, src: int) -> float:
        """Target -> source ack latency (symmetric path, minus the CU hop)."""
        raise NotImplementedError

    # -- bandwidth tiers ---------------------------------------------------
    def tier(self, src: int, dst: int) -> int:
        """Bandwidth/latency tier the (src, dst) pair crosses (0 = lowest)."""
        return 0

    def tier_capacity(self, tier: int) -> Optional[float]:
        """Per-source bytes/ns capacity of ``tier``; None = unconstrained.

        Tier 0 is never constrained beyond the flat station pool; an
        oversubscribed upper tier divides the source GPU's aggregate
        bandwidth by its oversubscription factor.
        """
        return None

    # -- vectorized forms (repro_torch.core.engine_vec) --------------------------
    # The scalar methods above stay the single source of truth: the base
    # fallbacks evaluate them per element, so a custom topology is correct
    # (if slow) by construction, and the overrides below are pure selects on
    # the same precomputed values — never re-derived arithmetic.
    def tier_arr(self, src: np.ndarray, dst) -> np.ndarray:
        """``tier(src[i], dst[i])`` for paired index arrays (or scalar dst)."""
        dst_b = np.broadcast_to(np.asarray(dst, dtype=np.int64), src.shape)
        return np.fromiter((self.tier(int(s), int(d))
                            for s, d in zip(src, dst_b)),
                           dtype=np.int64, count=len(src))

    def path_latency_arr(self, src: np.ndarray, dst) -> np.ndarray:
        """``path_latency_ns(src[i], dst[i])`` (scalar dst broadcasts)."""
        dst_b = np.broadcast_to(np.asarray(dst, dtype=np.int64), src.shape)
        return np.fromiter((self.path_latency_ns(int(s), int(d))
                            for s, d in zip(src, dst_b)),
                           dtype=np.float64, count=len(src))

    def return_latency_arr(self, dst, src: np.ndarray) -> np.ndarray:
        """``return_latency_ns(dst[i], src[i])`` (scalar dst broadcasts)."""
        dst_b = np.broadcast_to(np.asarray(dst, dtype=np.int64), src.shape)
        return np.fromiter((self.return_latency_ns(int(d), int(s))
                            for d, s in zip(dst_b, src)),
                           dtype=np.float64, count=len(src))

    # -- group structure ---------------------------------------------------
    def tier0_group(self) -> int:
        """Largest GPU group whose all-pairs traffic stays tier-0.

        This is the group tensor-parallel collectives should be mapped onto
        (:func:`repro_torch.workloads.derive.resolve_pod`).
        """
        return self.fab.n_gpus

    def local_group(self) -> int:
        """Intra phase group of :class:`~repro_torch.core.patterns.
        HierarchicalAllToAll` (the historical ``gpus_per_node`` node split
        on the flat default; the leaf on ``two_tier``)."""
        return self.fab.gpus_per_node

    def pod_group(self) -> int:
        """Pod group of :class:`~repro_torch.core.patterns.MultiPodAllToAll`."""
        return self.fab.gpus_per_node

    # -- pod partition (disaggregated placement, DESIGN.md §16) ------------
    # Only ``multi_pod`` has a real pod boundary; every other topology is
    # one pod, so cross-pod placement questions degenerate to "rank 0's
    # pod" and the KV-transfer pattern reports itself infeasible.
    def n_pods(self) -> int:
        """Number of scale-out pods the fabric is partitioned into."""
        return 1

    def pod_of(self, rank: int) -> int:
        """Pod index a GPU rank lives in (0 on single-pod topologies)."""
        return 0

    def describe(self) -> str:
        return self.name


class SingleClos(Topology):
    """The paper's single-level Clos: one tier, one constant latency."""

    name = "single_clos"
    flat = True

    def path_latency_ns(self, src: int, dst: int) -> float:
        return self.fab.oneway_ns

    def return_latency_ns(self, dst: int, src: int) -> float:
        return self.fab.return_ns

    def tier_arr(self, src, dst):
        return np.zeros(len(src), dtype=np.int64)

    def path_latency_arr(self, src, dst):
        return np.full(len(src), self.fab.oneway_ns)

    def return_latency_arr(self, dst, src):
        return np.full(len(src), self.fab.return_ns)


class _BlockTopology(Topology):
    """Two-tier block partition: GPUs `r // block` share the cheap tier.

    Both registered hierarchical topologies are block partitions — a leaf
    under a spine, or a Clos pod behind a scale-out hop — differing only in
    which config fields supply the block size, the extra inter-block
    latency, and the per-source oversubscription of the crossing.
    Subclasses set those three in ``_params``.  Ack paths re-cross the same
    switches and the CU/d2d hops are symmetric, so per tier the return sum
    equals the request sum.
    """

    def _params(self, fab: "FabricConfig"):
        """(block_size, extra_inter_latency_ns, oversubscription)."""
        raise NotImplementedError

    def __init__(self, fab: "FabricConfig"):
        super().__init__(fab)
        block, extra_ns, oversub = self._params(fab)
        # A group smaller than one block fits inside it (session subgroups).
        self.block = min(block, fab.n_gpus) if block > 0 else fab.n_gpus
        if self.block <= 0 or fab.n_gpus % self.block:
            raise ValueError(
                f"{self.name} needs n_gpus divisible by the block size "
                f"(got {fab.n_gpus} / {self.block})")
        self._inter_ns = fab.oneway_ns + extra_ns
        self._cross_cap = fab.gpu_bw / oversub

    def tier(self, src: int, dst: int) -> int:
        return 0 if src // self.block == dst // self.block else 1

    def path_latency_ns(self, src: int, dst: int) -> float:
        return (self.fab.oneway_ns
                if src // self.block == dst // self.block
                else self._inter_ns)

    def return_latency_ns(self, dst: int, src: int) -> float:
        return (self.fab.return_ns
                if src // self.block == dst // self.block
                else self._inter_ns)

    def tier_capacity(self, tier: int) -> Optional[float]:
        return self._cross_cap if tier == 1 else None

    def tier_arr(self, src, dst):
        dst_b = np.asarray(dst, dtype=np.int64)
        return (src // self.block != dst_b // self.block).astype(np.int64)

    def path_latency_arr(self, src, dst):
        dst_b = np.asarray(dst, dtype=np.int64)
        intra = src // self.block == dst_b // self.block
        return np.where(intra, self.fab.oneway_ns, self._inter_ns)

    def return_latency_arr(self, dst, src):
        dst_b = np.asarray(dst, dtype=np.int64)
        intra = src // self.block == dst_b // self.block
        return np.where(intra, self.fab.return_ns, self._inter_ns)

    def tier0_group(self) -> int:
        return self.block


class TwoTier(_BlockTopology):
    """Leaf/spine pod: ``leaf_size`` GPUs per leaf switch under a spine.

    Intra-leaf pairs cross one leaf switch (tier 0: the flat latency).
    Inter-leaf pairs climb to the spine and back down through the target's
    leaf — two extra switch crossings (``spine_latency_ns`` for the spine,
    ``switch_latency_ns`` for the second leaf) — and a source's inter-leaf
    flows share its leaf-uplink capacity ``gpu_bw / oversubscription``
    instead of the full station pool.
    """

    name = "two_tier"

    def _params(self, fab):
        leaf = fab.leaf_size if fab.leaf_size > 0 else fab.gpus_per_node
        return (leaf, fab.spine_latency_ns + fab.switch_latency_ns,
                fab.oversubscription)

    def local_group(self) -> int:
        return self.block

    def describe(self) -> str:
        return (f"two_tier(leaf={self.block}, "
                f"oversub={self.fab.oversubscription:g})")


class MultiPod(_BlockTopology):
    """Several single-Clos pods joined over a scale-out hop.

    Intra-pod pairs see the flat single-Clos behavior; inter-pod pairs add
    ``interpod_latency_ns`` (the scale-out switch + longer reach) and a
    source's cross-pod flows share ``gpu_bw / interpod_oversubscription``
    (the pod's egress ports are far scarcer than its internal links).
    """

    name = "multi_pod"

    def _params(self, fab):
        return (fab.pod_size, fab.interpod_latency_ns,
                fab.interpod_oversubscription)

    def pod_group(self) -> int:
        return self.block

    def n_pods(self) -> int:
        return self.fab.n_gpus // self.block

    def pod_of(self, rank: int) -> int:
        return rank // self.block

    def describe(self) -> str:
        return (f"multi_pod(pod={self.block}, "
                f"oversub={self.fab.interpod_oversubscription:g})")


TOPOLOGIES: Dict[str, Type[Topology]] = {
    cls.name: cls for cls in (SingleClos, TwoTier, MultiPod)
}


@functools.lru_cache(maxsize=512)
def _build(fab: "FabricConfig") -> Topology:
    try:
        cls = TOPOLOGIES[fab.topology]
    except KeyError:
        raise ValueError(
            f"unknown topology {fab.topology!r}; "
            f"known: {sorted(TOPOLOGIES)}") from None
    return cls(fab)


def get_topology(fab: "FabricConfig") -> Topology:
    """The (cached) :class:`Topology` instance of a fabric config.

    ``FabricConfig`` is frozen/hashable, and topologies are immutable after
    construction, so instances are shared freely across engines, sessions
    and sweep points of the same config.
    """
    return _build(fab)
