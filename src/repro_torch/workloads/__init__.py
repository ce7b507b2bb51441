"""Calibration harness of the port: compute windows timed on the H100.

``python -m repro_torch.workloads --arch ...`` measures the port's kernels
and writes a :class:`ComputeProfile` JSON that the jax-free
``python -m repro.workloads --profile`` replays.  The simulator itself is
not copied.
"""
from .calibrate import (ComputeProfile, PhaseWindow, calibrate,
                        default_cache_path)
from .derive import (PodSpec, layer_roofline_ns, moe_a2a_bytes, resolve_pod,
                     step_shape)

__all__ = [
    "ComputeProfile", "PhaseWindow", "calibrate", "default_cache_path",
    "PodSpec", "layer_roofline_ns", "moe_a2a_bytes", "resolve_pod",
    "step_shape",
]
