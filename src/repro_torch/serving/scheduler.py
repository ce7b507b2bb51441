"""Continuous-batching scheduler for the serving simulator (DESIGN.md §11).

vLLM-style continuous batching with chunked prefill: every simulated step
processes one token for each decoding request plus up to
``prefill_chunk_tokens`` prompt tokens from admitted-but-unprefilled
requests, so prefill work interleaves with decode steps instead of stalling
them.  A request occupies one of ``max_decode_slots`` batch slots from the
moment its prefill starts until its last output token, bounding the live
batch the way KV-cache capacity does on real engines.

The scheduler only *plans* token counts; the simulator prices each planned
step's collectives (sized from the live batch composition via
:class:`repro_torch.workloads.derive.StepEmitter`) and reports the step's timing
back through :meth:`ContinuousBatcher.commit`, which advances request state
and records per-request latency samples: time-to-first-token when a prefill
completes (prefill computes the first output token's logits), one
inter-token sample per decode step, and the cold-vs-warm communication
split (a step is *cold* when its collectives performed at least one page
walk — the Link-TLB working set was not resident).

Determinism contract: scheduling decisions are pure functions of the
admitted request sequence and the committed step timings — no RNG, no wall
clock — so a batcher replayed on the same inputs reproduces the same plans
and latency samples bit-for-bit on either simulation engine.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .arrivals import Request


@dataclass
class RequestStats:
    """Per-request latency accounting, threaded from session run deltas."""

    req: Request
    prefill_done: int = 0
    tokens_out: int = 0
    first_token_ns: Optional[float] = None       # absolute baseline time
    ideal_first_token_ns: Optional[float] = None
    finish_ns: Optional[float] = None
    ideal_finish_ns: Optional[float] = None
    itl_ns: List[float] = field(default_factory=list)
    cold_comm_ns: float = 0.0    # comm time of its cold (walking) steps
    warm_comm_ns: float = 0.0    # comm time of its warm steps
    rat_excess_ns: float = 0.0   # sum of (comm - ideal comm) over its steps
    walks: int = 0
    # Disaggregated-serving handoff accounting (DESIGN.md §16); left at the
    # defaults in colocated mode, filled by repro_torch.serving.disagg when the
    # request crosses a prefill pod -> decode pod boundary.  All times are
    # absolute on the one global clock every stream shares.
    prefill_finish_ns: Optional[float] = None  # prefill pod completed prompt
    kv_start_ns: Optional[float] = None        # KV transfer began on the link
    kv_transfer_ns: float = 0.0                # priced transfer duration
    kv_transfer_ideal_ns: float = 0.0          # zero-translation counterpart
    kv_transfer_walks: int = 0                 # page walks the transfer paid
    _last_token_ns: Optional[float] = None

    # -- identity ------------------------------------------------------------
    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def finished(self) -> bool:
        return self.finish_ns is not None

    # -- latency metrics -----------------------------------------------------
    @property
    def ttft_ns(self) -> Optional[float]:
        if self.first_token_ns is None:
            return None
        return self.first_token_ns - self.req.arrival_ns

    @property
    def ideal_ttft_ns(self) -> Optional[float]:
        if self.ideal_first_token_ns is None:
            return None
        return self.ideal_first_token_ns - self.req.arrival_ns

    @property
    def ttft_degradation(self) -> Optional[float]:
        """Baseline/ideal TTFT ratio; ``None`` only when unserved.

        A *legitimate* zero ideal TTFT (the counterfactual serves the
        first token the instant the request arrives — e.g. an arrival
        coinciding with its first-token step) is infinite degradation,
        not a missing sample: returning ``None`` there silently dropped
        the worst-degraded requests from the percentiles.
        """
        t, i = self.ttft_ns, self.ideal_ttft_ns
        if t is None or i is None:
            return None
        if i <= 0.0:
            return 1.0 if t <= 0.0 else float("inf")
        return t / i

    @property
    def e2e_ns(self) -> Optional[float]:
        if self.finish_ns is None:
            return None
        return self.finish_ns - self.req.arrival_ns

    @property
    def e2e_degradation(self) -> Optional[float]:
        if self.finish_ns is None or self.ideal_finish_ns is None:
            return None
        ideal = self.ideal_finish_ns - self.req.arrival_ns
        actual = self.finish_ns - self.req.arrival_ns
        if ideal <= 0.0:                  # same zero-ideal contract as TTFT
            return 1.0 if actual <= 0.0 else float("inf")
        return actual / ideal

    @property
    def mean_itl_ns(self) -> Optional[float]:
        return (sum(self.itl_ns) / len(self.itl_ns)) if self.itl_ns else None

    # -- disaggregation decomposition (DESIGN.md §16) ------------------------
    # TTFT = prefill phase + transfer queueing + transfer + decode queueing;
    # every term is None until the corresponding handoff stage happened.
    @property
    def kv_done_ns(self) -> Optional[float]:
        if self.kv_start_ns is None:
            return None
        return self.kv_start_ns + self.kv_transfer_ns

    @property
    def kv_transfer_excess_ns(self) -> float:
        """Transfer time beyond its zero-translation ideal (cold-RAT tax)."""
        return self.kv_transfer_ns - self.kv_transfer_ideal_ns

    @property
    def prefill_ns(self) -> Optional[float]:
        """Arrival -> prefill completion (queueing + compute + comm)."""
        if self.prefill_finish_ns is None:
            return None
        return self.prefill_finish_ns - self.req.arrival_ns

    @property
    def kv_wait_ns(self) -> Optional[float]:
        """Prefill completion -> transfer start (serialized-link queueing)."""
        if self.kv_start_ns is None or self.prefill_finish_ns is None:
            return None
        return self.kv_start_ns - self.prefill_finish_ns

    @property
    def decode_wait_ns(self) -> Optional[float]:
        """Transfer completion -> first token (decode admission + step)."""
        if self.first_token_ns is None or self.kv_done_ns is None:
            return None
        return self.first_token_ns - self.kv_done_ns


@dataclass
class StepPlan:
    """One planned engine step: the live batch composition."""

    decode: List[RequestStats]                   # one new token each
    prefill: List[Tuple[RequestStats, int]]      # (request, chunk tokens)

    @property
    def decode_tokens(self) -> int:
        return len(self.decode)

    @property
    def prefill_tokens(self) -> int:
        return sum(t for _r, t in self.prefill)

    @property
    def total_tokens(self) -> int:
        return self.decode_tokens + self.prefill_tokens

    def active(self) -> List[RequestStats]:
        return self.decode + [r for r, _t in self.prefill]


class ContinuousBatcher:
    """Admission + batch-composition state machine.

    ``plan(now_ns)`` admits every request that has arrived by ``now_ns``
    and returns the next step's composition (or ``None`` when the pod has
    no work — the simulator then idles to :meth:`next_arrival_ns`, which is
    where idle-gap TLB aging happens).  After pricing the step, the
    simulator calls ``commit(plan, ...)`` with the step's end times and
    communication statistics.
    """

    def __init__(self, requests: List[Request], *,
                 max_decode_slots: int = 32,
                 prefill_chunk_tokens: int = 512):
        if max_decode_slots < 1:
            raise ValueError(
                f"max_decode_slots must be >= 1, got {max_decode_slots}")
        if prefill_chunk_tokens < 1:
            raise ValueError(
                f"prefill_chunk_tokens must be >= 1, got "
                f"{prefill_chunk_tokens}")
        self.max_decode_slots = max_decode_slots
        self.prefill_chunk_tokens = prefill_chunk_tokens
        order = sorted(requests, key=lambda r: (r.arrival_ns, r.rid))
        self.stats: List[RequestStats] = [RequestStats(req=r) for r in order]
        self._next = 0                           # first not-yet-arrived index
        self.waiting: List[RequestStats] = []    # arrived, prefill not begun
        self.prefilling: List[RequestStats] = []
        self.decoding: List[RequestStats] = []
        self._started = 0                        # prefills ever begun
        self._finished = 0                       # requests ever finished

    # -- arrivals ------------------------------------------------------------
    def _admit(self, now_ns: float) -> None:
        while (self._next < len(self.stats)
               and self.stats[self._next].req.arrival_ns <= now_ns):
            self.waiting.append(self.stats[self._next])
            self._next += 1

    def add(self, req: Request) -> RequestStats:
        """Feed one more request into a live batcher (fleet routing).

        Requests must be added in nondecreasing arrival order — the fleet
        router dispatches at arrival time, so this holds by construction —
        keeping ``stats`` sorted and the ``_next`` admission pointer valid.
        """
        if self.stats and req.arrival_ns < self.stats[-1].req.arrival_ns:
            raise ValueError(
                f"out-of-order add: arrival {req.arrival_ns} precedes "
                f"last routed arrival {self.stats[-1].req.arrival_ns}")
        r = RequestStats(req=req)
        self.stats.append(r)
        return r

    def next_arrival_ns(self) -> Optional[float]:
        if self._next < len(self.stats):
            return self.stats[self._next].req.arrival_ns
        return None

    @property
    def drained(self) -> bool:
        """All requests retired (arrived, served, finished)."""
        return (self._next >= len(self.stats) and not self.waiting
                and not self.prefilling and not self.decoding)

    # -- load accounting (router / autoscaler inputs) -------------------------
    @property
    def queued(self) -> int:
        """Routed requests whose prefill has not begun (admission queue)."""
        return len(self.stats) - self._started

    @property
    def load(self) -> int:
        """Outstanding requests: routed and not yet finished (queue depth)."""
        return len(self.stats) - self._finished

    # -- planning ------------------------------------------------------------
    def plan(self, now_ns: float) -> Optional[StepPlan]:
        self._admit(now_ns)
        budget = self.prefill_chunk_tokens
        prefill: List[Tuple[RequestStats, int]] = []
        # Continue in-flight prefills first (their slots are already held),
        # then start waiting requests while slots and chunk budget remain.
        for r in self.prefilling:
            if budget <= 0:
                break
            take = min(budget, r.req.prompt_tokens - r.prefill_done)
            prefill.append((r, take))
            budget -= take
        while (budget > 0 and self.waiting
               and (len(self.prefilling) + len(self.decoding)
                    < self.max_decode_slots)):
            r = self.waiting.pop(0)
            self._started += 1
            self.prefilling.append(r)
            take = min(budget, r.req.prompt_tokens)
            prefill.append((r, take))
            budget -= take
        if not prefill and not self.decoding:
            return None
        return StepPlan(decode=list(self.decoding), prefill=prefill)

    # -- completion ----------------------------------------------------------
    def commit(self, plan: StepPlan, t_end: float, ideal_t_end: float,
               comm_ns: float, ideal_comm_ns: float, walks: int) -> None:
        """Apply one priced step: token emissions and latency samples.

        Every request active in the step experiences the step's full
        communication latency (latency is shared, not divided), classified
        cold or warm by whether the step's collectives performed page
        walks; the RAT excess is the step's communication time beyond its
        zero-translation ideal.
        """
        cold = walks > 0
        for r in plan.active():
            if cold:
                r.cold_comm_ns += comm_ns
            else:
                r.warm_comm_ns += comm_ns
            r.rat_excess_ns += comm_ns - ideal_comm_ns
            r.walks += walks
        for r, take in plan.prefill:
            r.prefill_done += take
            if r.prefill_done >= r.req.prompt_tokens:
                # Prefill computed the first output token's logits.
                r.tokens_out = 1
                r.first_token_ns = t_end
                r.ideal_first_token_ns = ideal_t_end
                r._last_token_ns = t_end
                self.prefilling.remove(r)
                if r.tokens_out >= r.req.output_tokens:
                    r.finish_ns = t_end
                    r.ideal_finish_ns = ideal_t_end
                    self._finished += 1
                else:
                    self.decoding.append(r)
        for r in plan.decode:
            r.tokens_out += 1
            r.itl_ns.append(t_end - r._last_token_ns)
            r._last_token_ns = t_end
            if r.tokens_out >= r.req.output_tokens:
                r.finish_ns = t_end
                r.ideal_finish_ns = ideal_t_end
                self._finished += 1
                self.decoding.remove(r)
