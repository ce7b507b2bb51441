"""Prefill/decode disaggregated serving with KV-cache transfer (DESIGN.md §16).

Colocated serving (:mod:`repro_torch.serving.simulate`) interleaves prefill
chunks with decode tokens on one pod.  Disaggregated serving splits the
roles: dedicated *prefill pods* run prompts, dedicated *decode pods*
generate tokens, and every request's KV cache crosses the ``multi_pod``
scale-out hop in between — an explicit ``kv_transfer`` collective
(:mod:`repro_torch.core.patterns`) sized from the model's KV bytes per token
(:func:`repro_torch.workloads.derive.kv_shard_bytes`) and priced on its own
:class:`~repro_torch.core.session.SimSession` per decode pod, so the transfer
pays real reverse translation at the decode pod's Link-MMU: the first
transfer after a flush walks every page of the KV arena, back-to-back
transfers into the same arena run warm (and engage the vectorized
engine's warm fast path), and an idle gap past ``SimConfig.tlb_retention_ns`` re-pays
the walks.  This is the paper's two-regime scenario on one fabric: bulk
KV transfers next to tiny per-token decode collectives sharing Link-TLB
reach.

Handoff contract (DESIGN.md §16.1): a request occupies a prefill slot
until its prompt completes (the prefill pod serves it as a 1-output-token
request — prefill computes the first token's logits), then its KV
transfer must complete before decode admission — transfer latency lands
directly on TTFT.  The decode pod admits the request as a 1-prompt-token
arrival at the transfer's completion instant; that single-chunk "prefill"
step is the request's first-token step, and the remaining
``output_tokens - 1`` steps are plain decode.  Requests with
``output_tokens <= 1`` finish at prefill and never cross the hop.

Determinism (DESIGN.md §16.4): one global event loop interleaves
arrivals, prefill steps and decode steps in time order (ties: arrival
first, then prefill pods before decode pods, then lowest pod index);
per-decode-pod transfers are serialized on that pod's transfer session,
so decode-side arrival order is nondecreasing by construction and the
serial and pooled sweep executors (:func:`sweep_disagg`) are bit-for-bit
identical on both engines.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.config import SimConfig
from ..core.select import get_policy
from ..core.session import SimSession
from ..workloads.derive import PodSpec, kv_shard_bytes, kv_transfer_fabric
from .arrivals import Request
from .fleet import ROUTERS, Replica, _route
from .scheduler import RequestStats
from .simulate import (PodStream, ServingAggregates, ServingStep,
                       TrafficPoint, fan_out_points, resolve_traffic_pod)


@dataclass
class KVHandoff:
    """One priced KV-cache transfer: prefill pod -> decode pod."""

    rid: int
    decode_idx: int            # decode pod the request was routed to
    nbytes: int                # per-GPU shard size (pattern semantics)
    offset: int                # KV-arena ring offset the shard landed at
    collective: str            # resolved algorithm (policy decision)
    prefill_finish_ns: float   # when the prefill pod completed the prompt
    start_ns: float            # when the transfer began on the link
    transfer_ns: float         # priced duration
    ideal_ns: float            # zero-translation counterpart
    walks: int                 # page walks the transfer paid
    fastpath_calls: int = 0    # vectorized warm-fast-path engagements

    @property
    def done_ns(self) -> float:
        return self.start_ns + self.transfer_ns

    @property
    def excess_ns(self) -> float:
        """Transfer time beyond its ideal — the cold-RAT tax fig18 plots."""
        return self.transfer_ns - self.ideal_ns


DEFAULT_KV_ARENA_BYTES = 128 * 2**20


class _TransferLink:
    """One decode pod's KV ingress: a serialized transfer session pair.

    The baseline session carries the decode pod's Link-MMU state for its
    **KV arena**: a ``kv_arena_bytes`` ring in which each request's shard
    lands at its own page-aligned offset (a fresh KV region per request,
    as a real paged KV allocator produces), wrapping when full.  The
    steady-state translation working set is therefore the whole arena —
    when it fits the Link-TLB reach, transfers run warm after the first
    lap; when it does not (small L2, or an arena larger than reach),
    transfers keep re-walking — the fig18 two-regime axis.  The ideal
    twin prices the zero-translation counterfactual, memoized per
    (algorithm, size) signature.  ``policy`` resolves the logical
    ``kv_transfer`` class per call, keyed per arena region's cold/warm
    state exactly as serving steps are (DESIGN.md §14).
    """

    def __init__(self, kv_cfg: SimConfig, policy, compute_profile=None,
                 arena_bytes: int = DEFAULT_KV_ARENA_BYTES):
        self.cfg = kv_cfg
        self.sess = SimSession(kv_cfg, compute_profile=compute_profile,
                               policy=policy)
        self.ideal = SimSession(kv_cfg.ideal(),
                                compute_profile=compute_profile)
        self._ideal_ns: Dict[tuple, float] = {}
        self._page = kv_cfg.translation.page_bytes
        self.arena_bytes = arena_bytes
        self._cursor = 0

    def _place(self, nbytes: int) -> int:
        """Ring-allocate a page-aligned arena slot for one KV shard."""
        slot = -(-nbytes // self._page) * self._page
        if self._cursor + slot > self.arena_bytes:
            self._cursor = 0               # wrap: reuse the oldest region
        off = self._cursor
        if slot < self.arena_bytes:
            self._cursor = off + slot
        return off

    def transfer(self, rid: int, decode_idx: int, nbytes: int,
                 finish_ns: float) -> KVHandoff:
        """Price one handoff; starts at ``max(link clock, finish_ns)``.

        The idle-to-start gap ages the link session exactly as serving
        idles do — past ``tlb_retention_ns`` it flushes the KV arena's
        translations, so a quiet decode pod re-pays the walks.
        """
        sess = self.sess
        if finish_ns > sess.t:
            sess.idle(finish_ns - sess.t)
        start = sess.t
        off = self._place(nbytes)
        rec = sess.run(nbytes, collective="kv_transfer", base_offset=off,
                       label=f"kv/r{rid}")
        sig = (rec.collective, nbytes)
        if sig not in self._ideal_ns:
            self._ideal_ns[sig] = self.ideal.run(
                nbytes, collective=rec.collective).completion_ns
        return KVHandoff(
            rid=rid, decode_idx=decode_idx, nbytes=nbytes, offset=off,
            collective=rec.collective, prefill_finish_ns=finish_ns,
            start_ns=start, transfer_ns=rec.completion_ns,
            ideal_ns=self._ideal_ns[sig], walks=rec.counters.walks,
            fastpath_calls=rec.fastpath_calls)


@dataclass
class DisaggResult(ServingAggregates):
    """Per-request / per-step statistics of one disaggregated run.

    ``requests`` holds one merged :class:`RequestStats` per original
    request (rid order): decode-side token timings re-pointed at the
    original arrival, prefill-phase communication accounting folded in,
    and the handoff fields (``prefill_finish_ns`` / ``kv_*``) filled — so
    ``ttft_ns`` measures arrival to first decode token across all three
    stages, and the §16 decomposition properties slice it.
    """

    arch: str
    pod: PodSpec                       # one pod (homogeneous hardware)
    cfg: SimConfig
    prefill: List[Replica]
    decode: List[Replica]
    requests: List[RequestStats]
    handoffs: List[KVHandoff] = field(default_factory=list)
    steps_capped: bool = False

    @property
    def steps(self) -> List[ServingStep]:
        """Every priced serving step, both roles, in global time order."""
        reps = [(0, r) for r in self.prefill] + [(1, r) for r in self.decode]
        return [s for _k, s in sorted(
            ((s.t_start, role, rep.idx, s.step), s)
            for role, rep in reps for s in rep.steps)]

    # -- KV-transfer aggregates ----------------------------------------------
    @property
    def kv_transfer_total_ns(self) -> float:
        return sum(h.transfer_ns for h in self.handoffs)

    @property
    def kv_excess_total_ns(self) -> float:
        return sum(h.excess_ns for h in self.handoffs)

    @property
    def kv_walks(self) -> int:
        return sum(h.walks for h in self.handoffs)

    @property
    def kv_cold_handoffs(self) -> int:
        """Transfers that paid page walks (arena not Link-TLB resident)."""
        return sum(1 for h in self.handoffs if h.walks > 0)

    @property
    def kv_fastpath_calls(self) -> int:
        return sum(h.fastpath_calls for h in self.handoffs)

    def ttft_breakdown(self) -> Dict[str, float]:
        """Mean TTFT decomposition over handed-off, served requests.

        ``prefill_ns`` (arrival -> prompt done, queueing included) +
        ``kv_wait_ns`` (link queueing) + ``kv_transfer_ns`` (of which
        ``kv_excess_ns`` is the cold-RAT tax) + ``decode_wait_ns``
        (transfer done -> first token) = ``ttft_ns``.  Empty dict when no
        request crossed the hop.
        """
        rows = [r for r in self.first_token_served
                if r.kv_start_ns is not None]
        if not rows:
            return {}
        n = len(rows)
        return dict(
            n=n,
            ttft_ns=sum(r.ttft_ns for r in rows) / n,
            prefill_ns=sum(r.prefill_ns for r in rows) / n,
            kv_wait_ns=sum(r.kv_wait_ns for r in rows) / n,
            kv_transfer_ns=sum(r.kv_transfer_ns for r in rows) / n,
            kv_excess_ns=sum(r.kv_transfer_excess_ns for r in rows) / n,
            decode_wait_ns=sum(r.decode_wait_ns for r in rows) / n)

    def replica_rows(self) -> List[dict]:
        """Per-pod summary rows, prefill pods first (cf. fleet rows)."""
        rows = []
        for rep in self.prefill + self.decode:
            steps = rep.steps
            rows.append(dict(
                idx=rep.idx, role=rep.role, routed=rep.routed,
                steps=len(steps), walks=sum(s.walks for s in steps),
                fastpath_calls=sum(s.fastpath_calls for s in steps),
                cold_comm_ns=sum(s.comm_ns for s in steps if s.walks > 0),
                warm_comm_ns=sum(s.comm_ns for s in steps if s.walks == 0)))
        return rows


def simulate_disagg(arch, requests: List[Request], *,
                    pod: Optional[PodSpec] = None,
                    n_gpus: Optional[int] = None,
                    cfg: Optional[SimConfig] = None,
                    prefill_pods: int = 1,
                    decode_pods: int = 1,
                    router: str = "round_robin",
                    max_decode_slots: int = 32,
                    prefill_chunk_tokens: int = 512,
                    steps_cap: Optional[int] = None,
                    kv_arena_bytes: int = DEFAULT_KV_ARENA_BYTES,
                    compute_profile=None,
                    policy=None) -> DisaggResult:
    """Serve ``requests`` on ``prefill_pods`` + ``decode_pods`` pods.

    ``pod``/``n_gpus``/``cfg`` describe **one pod** (exactly the
    :func:`~repro_torch.serving.simulate.simulate_traffic` arguments); the
    deployment is homogeneous hardware with heterogeneous roles.  The
    ``router`` (:data:`~repro_torch.serving.fleet.ROUTERS`) is applied twice:
    arrivals route over prefill pods, completed prefills route their KV
    handoff over decode pods.  ``steps_cap`` bounds the **total** priced
    serving steps across every pod (transfers are not steps).

    The KV hop is priced per decode pod on a dedicated ``multi_pod`` pair
    fabric (:func:`~repro_torch.workloads.derive.kv_transfer_fabric`) sharing
    ``cfg``'s translation/engine/retention knobs — so the L2-reach and
    retention axes a sweep varies apply to the transfer's Link-MMU too;
    each decode pod's shards ring-allocate through a ``kv_arena_bytes``
    arena (:class:`_TransferLink`), whose footprint against the Link-TLB
    reach sets the warm-vs-rewalking transfer regime.
    """
    if prefill_pods < 1 or decode_pods < 1:
        raise ValueError(f"need >= 1 pod per role, got "
                         f"{prefill_pods} prefill / {decode_pods} decode")
    if router not in ROUTERS:
        raise ValueError(f"unknown router {router!r}; known: {ROUTERS}")
    mcfg, pod, cfg = resolve_traffic_pod(arch, pod, n_gpus, cfg)
    policy = get_policy(policy)
    kv_cfg = cfg.replace(fabric=kv_transfer_fabric(pod),
                         collective="kv_transfer")

    def spawn(idx: int, role: str) -> Replica:
        stream = PodStream(mcfg, pod, cfg, [],
                           max_decode_slots=max_decode_slots,
                           prefill_chunk_tokens=prefill_chunk_tokens,
                           compute_profile=compute_profile, policy=policy)
        return Replica(idx=idx, stream=stream, spun_up_ns=0.0, role=role)

    prefill = [spawn(i, "prefill") for i in range(prefill_pods)]
    decode = [spawn(i, "decode") for i in range(decode_pods)]
    links = [_TransferLink(kv_cfg, policy, compute_profile,
                           arena_bytes=kv_arena_bytes)
             for _ in range(decode_pods)]

    arrivals = sorted(requests, key=lambda r: (r.arrival_ns, r.rid))
    origs: Dict[int, Request] = {r.rid: r for r in arrivals}
    if len(origs) != len(arrivals):
        raise ValueError("duplicate request ids in the arrival stream")
    handoffs: List[KVHandoff] = []
    handed: set = set()                # rids already transferred
    ai = 0
    rr_arr = rr_kv = 0
    total_steps = 0
    capped = False

    def handoff_finished(rep: Replica) -> None:
        """Route + price the KV transfer of newly completed prefills."""
        nonlocal rr_kv
        fresh = [r for r in rep.stream.batcher.stats
                 if r.finished and r.rid not in handed]
        for pr in sorted(fresh, key=lambda r: (r.finish_ns, r.rid)):
            handed.add(pr.rid)
            orig = origs[pr.rid]
            if orig.output_tokens <= 1:
                continue               # first token == only token: done
            target, rr_kv = _route(router, decode, orig, rr_kv)
            h = links[target.idx].transfer(
                orig.rid, target.idx,
                kv_shard_bytes(mcfg, orig.prompt_tokens, pod),
                pr.finish_ns)
            handoffs.append(h)
            target.stream.batcher.add(dataclasses.replace(
                orig, arrival_ns=h.done_ns, prompt_tokens=1))
            target.routed += 1

    while True:
        t_arr = arrivals[ai].arrival_ns if ai < len(arrivals) else None
        best: Optional[Tuple[float, int, int]] = None
        best_rep: Optional[Replica] = None
        for role_rank, group in ((0, prefill), (1, decode)):
            for rep in group:
                t_evt = rep.stream.next_event_ns()
                if t_evt is None:
                    continue
                key = (t_evt, role_rank, rep.idx)
                if best is None or key < best:
                    best, best_rep = key, rep

        if t_arr is not None and (best is None or t_arr <= best[0]):
            req = arrivals[ai]
            ai += 1
            target, rr_arr = _route(router, prefill, req, rr_arr)
            # The prefill pod serves the prompt as a 1-output-token
            # request: prefill computes the first token's logits, and the
            # commit that completes it is the handoff trigger.
            target.stream.batcher.add(
                dataclasses.replace(req, output_tokens=1))
            target.routed += 1
            continue

        if best_rep is None:
            break                      # no arrivals left, all pods drained
        step = best_rep.stream.advance()
        if step is not None:
            total_steps += 1
            best_rep.last_busy_ns = step.t_end
        if best_rep.role == "prefill":
            handoff_finished(best_rep)
        if step is not None and steps_cap is not None \
                and total_steps >= steps_cap:
            capped = True
            break

    # -- merge per-request stats onto the original arrival stream ------------
    pre_stats: Dict[int, RequestStats] = {
        r.rid: r for rep in prefill for r in rep.stream.batcher.stats}
    dec_stats: Dict[int, RequestStats] = {
        r.rid: r for rep in decode for r in rep.stream.batcher.stats}
    by_rid: Dict[int, KVHandoff] = {h.rid: h for h in handoffs}
    merged: List[RequestStats] = []
    for rid in sorted(origs):
        orig = origs[rid]
        pr = pre_stats[rid]
        h = by_rid.get(rid)
        if h is None:
            # Finished at prefill (output_tokens <= 1) or prefill still in
            # flight at the step cap: the prefill-side stats are the whole
            # story.  Re-point at the original request (the served clone
            # differs only in output_tokens).
            pr.req = orig
            pr.prefill_finish_ns = pr.finish_ns
            merged.append(pr)
            continue
        dr = dec_stats[rid]
        dr.req = orig                  # TTFT back against the true arrival
        dr.prefill_finish_ns = h.prefill_finish_ns
        dr.kv_start_ns = h.start_ns
        dr.kv_transfer_ns = h.transfer_ns
        dr.kv_transfer_ideal_ns = h.ideal_ns
        dr.kv_transfer_walks = h.walks
        # The request experienced the prefill phase's communication too.
        dr.cold_comm_ns += pr.cold_comm_ns
        dr.warm_comm_ns += pr.warm_comm_ns
        dr.rat_excess_ns += pr.rat_excess_ns
        dr.walks += pr.walks
        merged.append(dr)

    for rep in prefill + decode:
        rep.detach()
    return DisaggResult(arch=mcfg.name, pod=pod, cfg=cfg, prefill=prefill,
                        decode=decode, requests=merged, handoffs=handoffs,
                        steps_capped=capped)


# ------------------------------------------------------------------ sweeps
@dataclass(frozen=True)
class DisaggPoint:
    """One point of a disaggregation sweep: traffic plus the pod split.

    ``traffic`` fully describes one pod, the arrival stream and the
    scheduler knobs (its ``steps_cap`` becomes the deployment's *total*
    step cap); ``prefill_pods``/``decode_pods`` are the ``--disagg P:D``
    split.  Frozen and hashable — the point is the sweep key, so serial
    and pooled executors price it identically.
    """

    traffic: TrafficPoint = TrafficPoint()
    prefill_pods: int = 1
    decode_pods: int = 1
    router: str = "round_robin"
    kv_arena_bytes: int = DEFAULT_KV_ARENA_BYTES


def _disagg_point(task: Tuple[DisaggPoint]) -> DisaggResult:
    (dp,) = task
    t = dp.traffic
    return simulate_disagg(
        t.arch, t.requests(), pod=t.pod_spec(), cfg=t.sim_config(),
        prefill_pods=dp.prefill_pods, decode_pods=dp.decode_pods,
        router=dp.router, max_decode_slots=t.max_decode_slots,
        prefill_chunk_tokens=t.prefill_chunk_tokens,
        steps_cap=t.steps_cap, kv_arena_bytes=dp.kv_arena_bytes,
        compute_profile=t.load_profile(), policy=t.policy)


def sweep_disagg(points: Sequence[DisaggPoint], *,
                 workers: Optional[int] = None
                 ) -> Dict[DisaggPoint, DisaggResult]:
    """Price every :class:`DisaggPoint`, fanned over a process pool.

    Same executor contract as the traffic and fleet sweeps
    (:func:`~repro_torch.serving.simulate.fan_out_points`): serial ≡ pooled
    bit-for-bit, duplicate points priced once.
    """
    return fan_out_points(points, _disagg_point, workers=workers)
