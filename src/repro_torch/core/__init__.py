"""The Reverse Address Translation simulator of the port, and its
collective schedules (counterparts of ``repro.core``).

The simulator (``config``, ``topology``, ``patterns``, ``tlb``, both
engines, ``session``, ``select``, ``ref_des``, ``ratsim``, ``cost_model``
and the ``scheduler``'s :class:`TranslationAwareScheduler`) is host code in
numpy float64, copied from the reference with every float expression in
its operand order: the parity tests hold the two packages bit for bit.  It
imports no torch, so ``ratsim.sweep``'s spawned workers and the replay
path load none.  ``overlap`` holds the torch schedules a
:class:`CollectivePlan` drives, and is imported on its own.
"""
from .config import (SimConfig, FabricConfig, TranslationConfig, TLBConfig,
                     PWCConfig, PreTranslationConfig, PrefetchConfig,
                     paper_config, KB, MB, GB)
from .engine import simulate, RunResult
from .patterns import (CollectivePattern, FlowSpec, PATTERNS, LOGICAL,
                       register_pattern, candidates_for, logical_of,
                       get_pattern, analytic_volume)
from .ratsim import run, compare, session, sweep, Comparison
from .ref_des import RefSession, simulate_ref
from .scheduler import CollectivePlan, TranslationAwareScheduler
from .select import (AlgorithmPolicy, AutoPolicy, FixedPolicy, PolicyTable,
                     Resolution, build_policy_table, get_policy, size_bucket)
from .session import CollectiveResult, SimSession
from .topology import Topology, TOPOLOGIES, get_topology

__all__ = [
    "SimConfig", "FabricConfig", "TranslationConfig", "TLBConfig",
    "PWCConfig", "PreTranslationConfig", "PrefetchConfig", "paper_config",
    "KB", "MB", "GB", "simulate", "RunResult", "run", "compare", "session",
    "sweep", "Comparison", "simulate_ref", "RefSession", "SimSession",
    "CollectiveResult", "CollectivePattern", "FlowSpec",
    "PATTERNS", "LOGICAL", "register_pattern", "candidates_for",
    "logical_of", "get_pattern", "analytic_volume",
    "AlgorithmPolicy", "AutoPolicy", "FixedPolicy", "PolicyTable",
    "Resolution", "build_policy_table", "get_policy", "size_bucket",
    "Topology", "TOPOLOGIES", "get_topology",
    "CollectivePlan", "TranslationAwareScheduler",
]
