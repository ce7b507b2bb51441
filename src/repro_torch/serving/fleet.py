"""Fleet-scale serving: multi-replica routing and autoscaling (DESIGN.md §13).

One :func:`~repro_torch.serving.simulate.simulate_traffic` run drives a single
pod; millions of users mean a *fleet*.  :func:`simulate_fleet` serves one
arrival stream across N pod replicas, each its own
:class:`~repro_torch.serving.simulate.PodStream` (and hence its own
:class:`~repro_torch.core.session.SimSession` with its own Link-TLB warmth),
fronted by

* a **router** dispatching each request at its arrival instant —
  ``round_robin`` (cyclic over live replicas), ``least_loaded`` (fewest
  outstanding requests, ties to the lowest replica index) or ``affinity``
  (a deterministic rid hash, so a request population keeps hitting the
  same replicas and their warmed translations);
* a **bounded admission queue** — when the fleet-wide count of routed-but-
  not-yet-prefilling requests reaches ``max_queue``, new arrivals are
  rejected (recorded, excluded from latency percentiles: an SLO miss of a
  different kind);
* a queue-depth-driven **autoscaler** — when the admission queue exceeds
  ``scale_up_queued``, a new replica is spun up (available after
  ``spinup_latency_ns``); replicas idle longer than ``scale_down_idle_ns``
  are retired.  A newly spun replica starts with **stone-cold TLBs**:
  replica spin-up *is* the cold-RAT event at fleet scale, so every scaling
  decision trades queue wait against the full cold-walk warmup tax that
  the paper prices on a single pod.

Determinism contract: the fleet event loop processes arrivals and replica
step boundaries in global time order (arrival first on ties, lowest
replica index among replicas), every router/autoscaler input is a pure
function of that ordering, and each replica's arrival sub-stream is data —
so the serial and process-pooled sweep executors (:func:`sweep_fleet`)
return bit-for-bit identical results on both simulation engines.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.config import SimConfig
from ..workloads.derive import PodSpec
from .arrivals import Request
from .scheduler import RequestStats
from .simulate import (PodStream, ServingAggregates, ServingStep,
                       TrafficPoint, fan_out_points, resolve_traffic_pod)

ROUTERS = ("round_robin", "least_loaded", "affinity")

# Knuth multiplicative hash: spreads consecutive rids across replicas
# deterministically (no PYTHONHASHSEED dependence), so session affinity is
# reproducible across processes and sweep executors.
_HASH_MULT = 2654435761


def _rid_hash(rid: int) -> int:
    return (rid * _HASH_MULT) & 0xFFFFFFFF


@dataclass
class Replica:
    """One pod replica: lifecycle bookkeeping plus its served traffic.

    During simulation the replica drives a live :class:`PodStream`; before
    the result is returned the stream is *detached* into the plain
    ``stats``/``steps`` data fields (a live stream holds simulator
    internals that cannot cross the sweep pool boundary — results must
    pickle).
    """

    idx: int
    spun_up_ns: float                  # when it became routable (cold start)
    retired_ns: Optional[float] = None
    last_busy_ns: float = 0.0          # end of its latest priced step
    routed: int = 0                    # requests ever routed to it
    # Replica role in the router: "serve" (colocated fleet — the default,
    # every replica handles prefill and decode) or "prefill"/"decode"
    # (disaggregated mode, repro_torch.serving.disagg — arrivals route only over
    # prefill replicas, KV handoffs only over decode replicas).
    role: str = "serve"
    stats: List[RequestStats] = field(default_factory=list)
    steps: List[ServingStep] = field(default_factory=list)
    stream: Optional[PodStream] = field(default=None, repr=False)

    @property
    def live(self) -> bool:
        return self.retired_ns is None

    def available(self, now_ns: float) -> bool:
        """Routable: spun up by ``now_ns`` and not retired."""
        return self.live and self.spun_up_ns <= now_ns

    def detach(self) -> None:
        """Pull the stream's accounting into data fields and drop it."""
        if self.stream is not None:
            self.stats = self.stream.batcher.stats
            self.steps = self.stream.steps
            self.stream = None


@dataclass
class FleetResult(ServingAggregates):
    """Aggregated per-request / per-step statistics of one fleet run."""

    arch: str
    pod: PodSpec                       # per-replica pod (homogeneous fleet)
    cfg: SimConfig
    replicas: List[Replica]
    rejected: List[Request] = field(default_factory=list)
    steps_capped: bool = False

    # -- aggregation inputs for ServingAggregates ----------------------------
    @property
    def requests(self) -> List[RequestStats]:
        """Every routed request across the fleet, in rid order."""
        out = [r for rep in self.replicas for r in rep.stats]
        out.sort(key=lambda r: r.rid)
        return out

    @property
    def steps(self) -> List[ServingStep]:
        """Every priced step across the fleet, in global time order."""
        return [s for _k, s in sorted(
            ((s.t_start, rep.idx, s.step), s)
            for rep in self.replicas for s in rep.steps)]

    # -- fleet-level accounting ----------------------------------------------
    @property
    def spin_ups(self) -> int:
        """Replicas spun up after t=0 (autoscaler cold starts)."""
        return sum(1 for rep in self.replicas if rep.spun_up_ns > 0.0)

    @property
    def retired(self) -> int:
        return sum(1 for rep in self.replicas if rep.retired_ns is not None)

    @property
    def peak_replicas(self) -> int:
        """Most replicas ever live at once (the capacity actually used).

        Not ``len(self.replicas)`` — with autoscaler churn the same
        capacity slot is filled by several replicas over the run's
        lifetime (spin up, retire, re-spin), and the fleet list keeps
        them all for accounting.
        """
        events = []
        for rep in self.replicas:
            events.append((rep.spun_up_ns, 1))
            if rep.retired_ns is not None:
                events.append((rep.retired_ns, -1))
        live = peak = 0
        for _t, d in sorted(events):
            live += d
            peak = max(peak, live)
        return peak

    @property
    def served(self) -> int:
        return len(self.first_token_served)

    def replica_rows(self) -> List[dict]:
        """Per-replica summary (the cast2md-style scaling-table rows)."""
        rows = []
        for rep in self.replicas:
            steps = rep.steps
            cold = sum(s.comm_ns for s in steps if s.walks > 0)
            warm = sum(s.comm_ns for s in steps if s.walks == 0)
            rows.append(dict(
                idx=rep.idx, role=rep.role, spun_up_ns=rep.spun_up_ns,
                retired_ns=rep.retired_ns, routed=rep.routed,
                steps=len(steps),
                walks=sum(s.walks for s in steps),
                fastpath_calls=sum(s.fastpath_calls for s in steps),
                cold_comm_ns=cold, warm_comm_ns=warm))
        return rows


def _route(router: str, active: List[Replica], req: Request,
           rr_cursor: int) -> Tuple[Replica, int]:
    """Pick the replica for ``req``; returns (replica, next rr cursor).

    ``active`` is the live-and-available list in replica-index order, never
    empty (the fleet keeps at least ``min_replicas`` live replicas, and the
    initial replicas are available from t=0).
    """
    if router == "round_robin":
        return active[rr_cursor % len(active)], rr_cursor + 1
    if router == "least_loaded":
        return min(active, key=lambda r: (r.stream.batcher.load, r.idx)), \
            rr_cursor
    if router == "affinity":
        return active[_rid_hash(req.rid) % len(active)], rr_cursor
    raise ValueError(f"unknown router {router!r}; known: {ROUTERS}")


def simulate_fleet(arch, requests: List[Request], *,
                   pod: Optional[PodSpec] = None,
                   n_gpus: Optional[int] = None,
                   cfg: Optional[SimConfig] = None,
                   replicas: int = 2,
                   router: str = "round_robin",
                   max_queue: Optional[int] = None,
                   autoscale: bool = False,
                   min_replicas: int = 1,
                   max_replicas: int = 0,
                   scale_up_queued: int = 4,
                   scale_down_idle_ns: Optional[float] = None,
                   spinup_latency_ns: float = 0.0,
                   max_decode_slots: int = 32,
                   prefill_chunk_tokens: int = 512,
                   steps_cap: Optional[int] = None,
                   compute_profile=None,
                   policy=None) -> FleetResult:
    """Serve ``requests`` on a fleet of identical pod replicas.

    ``pod``/``n_gpus``/``cfg`` describe **one replica** (exactly the
    :func:`~repro_torch.serving.simulate.simulate_traffic` arguments); the fleet
    is ``replicas`` copies of it.  With ``autoscale=True`` the fleet
    instead starts at ``min_replicas`` and grows on queue pressure up to
    ``max_replicas`` (0 means ``replicas``) — each spin-up appears
    ``spinup_latency_ns`` after the triggering arrival with stone-cold
    TLBs, and replicas idle past ``scale_down_idle_ns`` are retired, so a
    later burst pays the spin-up *and* the cold warmup again.

    ``steps_cap`` bounds the **total** engine steps across the fleet.

    The event loop interleaves arrivals and replica steps in global time
    order (ties: arrival first, then lowest replica index).  Routing,
    admission and scaling all happen at arrival instants; a replica's step
    is atomic, so a step that straddles an arrival exposes its end-of-step
    request state to that arrival's routing decision — the usual
    one-step-granularity approximation of a discrete-step serving sim.
    """
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    if router not in ROUTERS:
        raise ValueError(f"unknown router {router!r}; known: {ROUTERS}")
    mcfg, pod, cfg = resolve_traffic_pod(arch, pod, n_gpus, cfg)
    # Resolve the policy spec once: every replica shares one policy object
    # (an AutoPolicy's memoized candidate prices are fleet-wide that way).
    from ..core.select import get_policy
    policy = get_policy(policy)
    cap = max_replicas or replicas
    if autoscale:
        if not 1 <= min_replicas <= cap:
            raise ValueError(
                f"need 1 <= min_replicas({min_replicas}) <= "
                f"max_replicas({cap})")
        n_start = min_replicas
    else:
        n_start = replicas

    def spawn(idx: int, now_ns: float) -> Replica:
        # A fresh PodStream == a fresh SimSession == stone-cold TLBs: the
        # replica's first steps re-pay the full cold-walk warmup.
        stream = PodStream(mcfg, pod, cfg, [],
                           max_decode_slots=max_decode_slots,
                           prefill_chunk_tokens=prefill_chunk_tokens,
                           compute_profile=compute_profile,
                           start_ns=now_ns, policy=policy)
        return Replica(idx=idx, stream=stream, spun_up_ns=now_ns,
                       last_busy_ns=now_ns)

    fleet: List[Replica] = [spawn(i, 0.0) for i in range(n_start)]
    rejected: List[Request] = []
    arrivals = sorted(requests, key=lambda r: (r.arrival_ns, r.rid))
    ai = 0
    rr_cursor = 0
    total_steps = 0
    capped = False

    while True:
        t_arr = arrivals[ai].arrival_ns if ai < len(arrivals) else None
        # Earliest replica event (step start or idle-to-arrival target).
        best: Optional[Tuple[float, int]] = None
        for rep in fleet:
            if not rep.live:
                continue                 # retired replicas are drained
            t_evt = rep.stream.next_event_ns()
            if t_evt is None:
                continue
            if best is None or t_evt < best[0]:
                best = (t_evt, rep.idx)

        if t_arr is not None and (best is None or t_arr <= best[0]):
            now = t_arr
            req = arrivals[ai]
            ai += 1
            # Scale-down first: replicas whose streams drained and have
            # been idle past the threshold are retired (highest index
            # first would equal lowest here — each is checked on its own).
            if autoscale and scale_down_idle_ns is not None:
                live = [r for r in fleet if r.live]
                n_live = len(live)
                for rep in reversed(live):       # newest replicas first
                    if n_live <= min_replicas:
                        break
                    if (rep.stream.drained
                            and now - rep.last_busy_ns
                            >= scale_down_idle_ns):
                        rep.retired_ns = now
                        n_live -= 1
            queued = sum(r.stream.batcher.queued for r in fleet if r.live)
            # Bounded admission: reject before routing when the fleet-wide
            # prefill backlog is at capacity.
            if max_queue is not None and queued >= max_queue:
                rejected.append(req)
                continue
            active = [r for r in fleet if r.available(now)]
            if not active:
                # Every live replica still spinning up: the request waits
                # on whichever comes up first (routed there now; its
                # stream clock starts at spin-up anyway).
                target = min((r for r in fleet if r.live),
                             key=lambda r: (r.spun_up_ns, r.idx))
            else:
                target, rr_cursor = _route(router, active, req, rr_cursor)
            target.stream.batcher.add(req)
            target.routed += 1
            # Scale-up after routing: the queue the autoscaler sees
            # includes the arrival that just joined it.  ``cap`` bounds
            # *live* replicas (pending spin-ups included), not the total
            # ever spawned — churn (spin up, retire, re-spin cold) is the
            # whole point.
            if autoscale:
                live_n = sum(1 for r in fleet if r.live)
                if live_n < cap and queued + 1 > scale_up_queued:
                    fleet.append(spawn(len(fleet),
                                       now + spinup_latency_ns))
            continue

        if best is None:
            break                        # no arrivals left, fleet drained
        rep = fleet[best[1]]
        step = rep.stream.advance()
        if step is not None:
            total_steps += 1
            rep.last_busy_ns = step.t_end
            if steps_cap is not None and total_steps >= steps_cap:
                capped = True
                break

    for rep in fleet:
        rep.detach()
    return FleetResult(arch=mcfg.name, pod=pod, cfg=cfg, replicas=fleet,
                       rejected=rejected, steps_capped=capped)


# ------------------------------------------------------------------ sweeps
@dataclass(frozen=True)
class FleetPoint:
    """One point of a fleet sweep: a traffic point plus the fleet policy.

    ``traffic`` fully describes one replica's pod, the arrival stream and
    the per-replica scheduler knobs (its ``steps_cap`` becomes the fleet's
    *total* step cap); the remaining fields are the router/queue/autoscaler
    policy.  Frozen and hashable — the point is the sweep key, and with
    its seed it *is* the workload, so serial and pooled executors price it
    identically.
    """

    traffic: TrafficPoint = TrafficPoint()
    replicas: int = 2
    router: str = "round_robin"
    max_queue: Optional[int] = None
    autoscale: bool = False
    min_replicas: int = 1
    max_replicas: int = 0              # 0 -> replicas
    scale_up_queued: int = 4
    scale_down_idle_ns: Optional[float] = None
    spinup_latency_ns: float = 0.0


def _fleet_point(task: Tuple[FleetPoint]) -> FleetResult:
    (fp,) = task
    t = fp.traffic
    return simulate_fleet(
        t.arch, t.requests(), pod=t.pod_spec(), cfg=t.sim_config(),
        replicas=fp.replicas, router=fp.router, max_queue=fp.max_queue,
        autoscale=fp.autoscale, min_replicas=fp.min_replicas,
        max_replicas=fp.max_replicas,
        scale_up_queued=fp.scale_up_queued,
        scale_down_idle_ns=fp.scale_down_idle_ns,
        spinup_latency_ns=fp.spinup_latency_ns,
        max_decode_slots=t.max_decode_slots,
        prefill_chunk_tokens=t.prefill_chunk_tokens,
        steps_cap=t.steps_cap, compute_profile=t.load_profile(),
        policy=t.policy)


def sweep_fleet(points: Sequence[FleetPoint], *,
                workers: Optional[int] = None
                ) -> Dict[FleetPoint, FleetResult]:
    """Price every :class:`FleetPoint`, fanned over a process pool.

    Same executor contract as :func:`repro_torch.serving.simulate.sweep_traffic`
    (see :func:`~repro_torch.serving.simulate.fan_out_points`): serial
    (``workers=0``) and pooled paths are bit-for-bit identical, duplicate
    points are priced once.
    """
    return fan_out_points(points, _fleet_point, workers=workers)
