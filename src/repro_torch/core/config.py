"""Configuration dataclasses for the Reverse Address Translation (RAT) simulator.

Defaults follow Table 1 of the paper ("Analyzing Reverse Address Translation
Overheads in Multi-GPU Scale-Up Pods"): a UALink single-level Clos pod with
16 stations per GPU (800 Gbps per station), a per-station L1 Link TLB, a
shared per-GPU L2 Link TLB, page-walk caches and a shared pool of parallel
page-table walkers.  All times are nanoseconds, sizes are bytes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

KB = 1024
MB = 1024 * KB
GB = 1024 * MB


@dataclass(frozen=True)
class TLBConfig:
    """A single TLB level (L1 per-station or L2 per-GPU)."""

    entries: int
    assoc: int  # 0 => fully associative
    hit_latency_ns: float
    mshr_entries: int = 0  # 0 => no MSHR at this level


@dataclass(frozen=True)
class PWCConfig:
    """Page-walk caches: one cache per upper page-table level.

    ``entries[i]`` caches the pointer produced by walk step ``i``; coverage[i]
    is the address span one entry maps (bytes).  With 2 MB pages the leaf PTE
    read always goes to memory (it fills the Link TLBs, not the PWC), so for a
    5-level x86-style table a 2 MB walk performs ``len(entries)`` cached
    lookups plus one uncached leaf read.
    """

    entries: tuple = (16, 32, 64, 128)
    assoc: int = 2
    lookup_latency_ns: float = 50.0
    # Root / PML5E / PML4E / PDPTE pointer coverage for a 5-level table with
    # 2 MB pages; the leaf PDE read (the translation itself) is never PWC
    # cached — it fills the Link TLBs.
    coverage_bytes: tuple = (1 << 57, 1 << 48, 1 << 39, 1 << 30)

    def __post_init__(self):
        assert len(self.entries) == len(self.coverage_bytes)


@dataclass(frozen=True)
class TranslationConfig:
    """The Reverse Address Translation hierarchy at the target GPU."""

    l1: TLBConfig = TLBConfig(entries=32, assoc=0, hit_latency_ns=50.0,
                              mshr_entries=256)
    l2: TLBConfig = TLBConfig(entries=512, assoc=2, hit_latency_ns=100.0,
                              mshr_entries=512)
    pwc: PWCConfig = PWCConfig()
    n_ptw: int = 100              # parallel page-table walkers (shared/GPU)
    page_bytes: int = 2 * MB
    mem_access_ns: float = 270.0  # local fabric (120) + HBM (150) per PT read
    enabled: bool = True          # False => ideal (zero-overhead) translation


@dataclass(frozen=True)
class FabricConfig:
    """UALink pod: per-station bandwidth, latencies, and the pod topology.

    The paper's fabric is a single-level Clos (``topology="single_clos"``,
    the default — every pair sees :attr:`oneway_ns`).  The topology layer
    (:mod:`repro_torch.core.topology`) generalizes this to hierarchical pods:
    ``"two_tier"`` (leaf/spine with an oversubscribed uplink) and
    ``"multi_pod"`` (Clos pods joined over a scale-out hop), parameterized
    by the tier fields below.
    """

    n_gpus: int = 16
    gpus_per_node: int = 4
    stations_per_gpu: int = 16
    station_gbps: float = 800.0        # 4 lanes x 200 Gbps
    switch_latency_ns: float = 300.0   # single-level Clos ULS
    d2d_latency_ns: float = 300.0      # die-to-die (NIC/station crossing)
    local_fabric_ns: float = 120.0     # CU -> NoC (paper: constant, all-miss)
    hbm_ns: float = 150.0              # HBM access at the target
    request_bytes: int = 256           # UALink flit-batched remote store
    # -- topology (repro_torch.core.topology) ------------------------------------
    topology: str = "single_clos"      # registry name of the pod topology
    leaf_size: int = 0                 # two_tier: GPUs per leaf switch
                                       # (0 => gpus_per_node)
    spine_latency_ns: float = 300.0    # two_tier: spine-switch crossing
    oversubscription: float = 1.0      # two_tier: leaf->spine uplink
                                       # oversubscription factor
    pod_size: int = 0                  # multi_pod: GPUs per pod (0 => all)
    interpod_latency_ns: float = 900.0      # multi_pod: scale-out hop
    interpod_oversubscription: float = 4.0  # multi_pod: pod egress scarcity
    # Per-station ingress buffering at the target (requests resident from
    # arrival until their translation resolves).  When a pending walk holds
    # more than this many requests the station exerts credit backpressure
    # upstream, stalling the whole port (UALink credit-based flow control).
    # Default equals the paper's 256-entry L1 MSHR: the MSHR target slots are
    # exactly the resource that holds untranslated in-flight requests.
    ingress_entries: int = 256

    @property
    def station_bw(self) -> float:
        """Bytes/ns of one station."""
        return self.station_gbps / 8.0  # Gbps -> bytes/ns  (100 GB/s)

    @property
    def gpu_bw(self) -> float:
        """Aggregate bytes/ns of one GPU (requests stripe over stations)."""
        return self.station_bw * self.stations_per_gpu

    @property
    def oneway_ns(self) -> float:
        """Source CU -> target station: local fabric + d2d + switch + d2d."""
        return (self.local_fabric_ns + self.d2d_latency_ns
                + self.switch_latency_ns + self.d2d_latency_ns)

    @property
    def return_ns(self) -> float:
        """Target -> source ack path (symmetric, minus the CU hop)."""
        return (self.d2d_latency_ns + self.switch_latency_ns
                + self.d2d_latency_ns + self.local_fabric_ns)


@dataclass(frozen=True)
class PreTranslationConfig:
    """Paper §6.1: fused pre-translation kernels.

    Translation-only probe requests are issued during the compute phase that
    precedes the collective, warming Link TLBs before data arrives.
    ``lead_time_ns`` is how long before the collective the fused kernel starts
    issuing probes; ``pages_per_flow`` limits how deep it warms each flow
    (0 => all pages of the collective)."""

    enabled: bool = False
    lead_time_ns: float = 2000.0
    pages_per_flow: int = 1
    probe_issue_interval_ns: float = 10.0


@dataclass(frozen=True)
class PrefetchConfig:
    """Paper §6.2: software-guided TLB prefetching.

    When a flow first touches page ``k`` the prefetcher requests translation of
    pages ``k+1 .. k+depth`` (next-page prediction from the static layout of
    the collective's buffers)."""

    enabled: bool = False
    depth: int = 1


@dataclass(frozen=True)
class SimConfig:
    fabric: FabricConfig = field(default_factory=FabricConfig)
    translation: TranslationConfig = field(default_factory=TranslationConfig)
    pretranslation: PreTranslationConfig = field(
        default_factory=PreTranslationConfig)
    prefetch: PrefetchConfig = field(default_factory=PrefetchConfig)
    # Collective traffic pattern, by registry name (repro_torch.core.patterns):
    # "all_to_all" (the paper's workload, default), "ring_allreduce",
    # "rd_allreduce", "all_gather", "reduce_scatter", "broadcast",
    # "hier_all_to_all", "multipod_all_to_all".
    collective: str = "all_to_all"
    iterations: int = 1          # back-to-back collective iterations
    # Session replay (repro_torch.core.session): an inter-collective idle gap of at
    # least this many ns flushes all cached translations, modelling eviction
    # by competing traffic while the pod is quiet.  None => TLB entries
    # survive arbitrarily long gaps (the hierarchy has no self-decay).
    tlb_retention_ns: Optional[float] = None
    symmetric: bool = True       # simulate a single target GPU (symmetric
                                 # patterns load every GPU identically);
                                 # False simulates every target
    collect_trace: bool = False  # keep per-request latency arrays (figs 9/10)
    # Simulation engine: "event" (the reference per-epoch Python loop) or
    # "vectorized" (repro_torch.core.engine_vec — batched numpy arithmetic with a
    # minimal sequential TLB core; bit-for-bit identical results, ~10x+
    # faster on sweep-scale points).  Threaded through ratsim, sessions,
    # workload replay and serving.
    engine: str = "event"

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    def ideal(self) -> "SimConfig":
        return self.replace(
            translation=dataclasses.replace(self.translation, enabled=False))


def paper_config(n_gpus: int = 16, **kw) -> SimConfig:
    """The paper's Table-1 baseline for a given pod size."""
    fab = FabricConfig(n_gpus=n_gpus)
    return SimConfig(fabric=fab, **kw)
