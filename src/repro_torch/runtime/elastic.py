"""Elastic scaling and straggler control plane of the port: its own copy
of the jax-free ``repro.runtime.elastic`` (the port imports nothing of
``repro``, and ``repro.runtime`` imports jax through its trainer).

The same state machine over host heartbeats: a host silent past
``heartbeat_timeout_s`` is dead and the mesh shrinks to the largest power
of two of data-parallel replicas that the live hosts fill; with four or
more hosts reporting step times, one whose mean exceeds
``straggler_factor`` times the median is replaced.  Checkpoints store
whole (unsharded) leaves, and ``data.DataIterator.reshard`` keeps the
stream, so a re-meshed run restores and goes on.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class HostState:
    host_id: int
    last_heartbeat: float
    step_times: List[float] = field(default_factory=list)
    alive: bool = True

    def note_step(self, seconds: float) -> None:
        self.step_times.append(seconds)
        if len(self.step_times) > 32:
            self.step_times.pop(0)

    @property
    def mean_step(self) -> float:
        return (sum(self.step_times) / len(self.step_times)
                if self.step_times else 0.0)


@dataclass
class ElasticDecision:
    kind: str            # "ok" | "remesh" | "replace_straggler"
    dead_hosts: Tuple[int, ...] = ()
    stragglers: Tuple[int, ...] = ()
    new_num_shards: Optional[int] = None


class ElasticController:
    """Failure detection + re-mesh policy over host heartbeats."""

    def __init__(self, n_hosts: int, *, heartbeat_timeout_s: float = 60.0,
                 straggler_factor: float = 2.0,
                 min_hosts: int = 1, clock=time.monotonic):
        self.clock = clock
        self.timeout = heartbeat_timeout_s
        self.straggler_factor = straggler_factor
        self.min_hosts = min_hosts
        now = self.clock()
        self.hosts: Dict[int, HostState] = {
            i: HostState(i, now) for i in range(n_hosts)}

    def heartbeat(self, host_id: int, step_seconds: Optional[float] = None):
        h = self.hosts[host_id]
        h.last_heartbeat = self.clock()
        h.alive = True
        if step_seconds is not None:
            h.note_step(step_seconds)

    def poll(self) -> ElasticDecision:
        now = self.clock()
        dead = tuple(h.host_id for h in self.hosts.values()
                     if h.alive and now - h.last_heartbeat > self.timeout)
        for hid in dead:
            self.hosts[hid].alive = False
        alive = [h for h in self.hosts.values() if h.alive]
        if dead:
            n = len(alive)
            # largest power-of-two data-parallel degree that still works
            shards = 1
            while shards * 2 <= n:
                shards *= 2
            if n < self.min_hosts:
                raise RuntimeError("below minimum healthy host count")
            return ElasticDecision(kind="remesh", dead_hosts=dead,
                                   new_num_shards=shards)
        # Straggler: sustained mean step time >> fleet median.
        times = sorted(h.mean_step for h in alive if h.step_times)
        if len(times) >= 4:
            median = times[len(times) // 2]
            strag = tuple(h.host_id for h in alive
                          if h.step_times
                          and h.mean_step > self.straggler_factor * median)
            if strag:
                return ElasticDecision(kind="replace_straggler",
                                       stragglers=strag)
        return ElasticDecision(kind="ok")
