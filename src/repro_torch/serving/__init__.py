# Request-level serving traffic over workload replay: seeded arrival
# processes (Poisson / bursty / trace file), a continuous-batching scheduler
# whose live batch composition sizes each step's collectives, and
# per-request TTFT / inter-token latency accounting with a cold-vs-warm
# Link-TLB split (DESIGN.md §11).  The fleet layer (DESIGN.md §13) serves
# one stream across N pod replicas behind a router, a bounded admission
# queue and a queue-depth autoscaler whose spin-ups start stone-cold.
# The disaggregation layer (DESIGN.md §16) splits prefill and decode onto
# dedicated pods with an explicitly priced KV-cache transfer in between.
# `python -m repro_torch.serving --arch ... --rps ...` (optionally `--fleet`
# or `--disagg P:D`) runs offline: numpy host code, no torch, no jax.
from .arrivals import (Request, bursty_requests, poisson_requests,
                       trace_requests)
from .disagg import (DisaggPoint, DisaggResult, KVHandoff, simulate_disagg,
                     sweep_disagg)
from .fleet import (FleetPoint, FleetResult, Replica, simulate_fleet,
                    sweep_fleet)
from .scheduler import ContinuousBatcher, RequestStats, StepPlan
from .simulate import (PodStream, ServingStep, TrafficPoint, TrafficResult,
                       serving_layout, simulate_traffic, sweep_traffic)

__all__ = [
    "Request", "bursty_requests", "poisson_requests", "trace_requests",
    "ContinuousBatcher", "RequestStats", "StepPlan",
    "PodStream", "ServingStep", "TrafficPoint", "TrafficResult",
    "serving_layout", "simulate_traffic", "sweep_traffic",
    "FleetPoint", "FleetResult", "Replica", "simulate_fleet", "sweep_fleet",
    "DisaggPoint", "DisaggResult", "KVHandoff", "simulate_disagg",
    "sweep_disagg",
]
