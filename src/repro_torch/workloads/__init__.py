"""Workload replay of the port: model-derived collective sequences
replayed through persistent-TLB sessions, with compute windows from the
roofline or timed on the H100.

``derive`` emits the collectives of decode, prefill and train steps of the
registry's architectures, ``replay`` runs them through the port's
simulator (:mod:`repro_torch.core`) and ``calibrate`` times the port's
kernels on the card into a :class:`ComputeProfile`.  ``python -m
repro_torch.workloads --arch ... --shape ...`` prints the per-step
warm-vs-cold degradation trajectory; ``--calibrate`` measures the windows
first.  Importing the package loads no torch: ``calibrate`` imports it
only inside its measurers.
"""
from .calibrate import (ComputeProfile, PhaseWindow, calibrate,
                        default_cache_path)
from .derive import (CollectiveCall, PodSpec, StepEmitter, WorkloadTrace,
                     derive_workload, layer_param_bytes, layer_roofline_ns,
                     moe_a2a_bytes, pod_fabric, resolve_pod, step_shape)
from .replay import ReplayResult, StepStats, buffer_layout, replay

__all__ = [
    "CollectiveCall", "PodSpec", "StepEmitter", "WorkloadTrace",
    "derive_workload", "layer_param_bytes", "layer_roofline_ns",
    "moe_a2a_bytes", "pod_fabric", "resolve_pod", "step_shape",
    "ReplayResult", "StepStats", "buffer_layout", "replay",
    "ComputeProfile", "PhaseWindow", "calibrate", "default_cache_path",
]
