"""Analytic cost model for collectives over a scale-up pod, with RAT terms.

Closed-form distillation of the simulator, used by the framework's
translation-aware scheduler (:mod:`repro_torch.core.scheduler`) to price collective
schedules without running the DES in the training loop.  The model is the
classic alpha-beta form plus two destination-side translation terms derived
from the paper's analysis:

  T(S, n) = alpha + S_eff / B_gpu + T_cold(S, n) + T_warm(S, n)

  * ``alpha``     — fixed fabric latency (one-way + return).
  * ``S_eff/B``   — bandwidth term (all-pairs moves (n-1)/n of S per GPU over
                    the aggregate station bandwidth).
  * ``T_cold``    — the cold-start stall: the first page walk of each flow
                    outlasts the MSHR/ingress cover and stalls the port
                    (dominates small collectives — the paper's 1.4x).
  * ``T_warm``    — per-page-transition residue for walks that outlast the
                    ingress cover (zero with paper-default buffering).

``fit()`` calibrates the two free parameters (cold-walk latency and effective
cover) against the simulator; ``validate()`` reports model-vs-sim error.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

from .config import SimConfig, paper_config
from .engine import simulate


@dataclass
class CostModel:
    cfg: SimConfig
    cold_walk_ns: float = None   # filled by __post_init__ / fit()
    warm_walk_ns: float = None

    def __post_init__(self):
        tr = self.cfg.translation
        n_pwc = len(tr.pwc.entries)
        if self.cold_walk_ns is None:
            # L1 miss + L2 miss + all-PWC-miss walk + leaf PTE read.
            self.cold_walk_ns = (tr.l1.hit_latency_ns + tr.l2.hit_latency_ns
                                 + n_pwc * (tr.pwc.lookup_latency_ns
                                            + tr.mem_access_ns)
                                 + tr.mem_access_ns)
        if self.warm_walk_ns is None:
            # L1 miss + L2 miss + all-PWC-hit walk + leaf PTE read.
            self.warm_walk_ns = (tr.l1.hit_latency_ns + tr.l2.hit_latency_ns
                                 + n_pwc * tr.pwc.lookup_latency_ns
                                 + tr.mem_access_ns)

    # ------------------------------------------------------------------
    def _terms(self, nbytes: int, with_rat: bool) -> Dict[str, float]:
        fab = self.cfg.fabric
        tr = self.cfg.translation
        n = fab.n_gpus
        chunk = nbytes // n
        svc = fab.request_bytes / fab.station_bw
        cover = fab.ingress_entries * svc
        alpha = fab.oneway_ns + fab.hbm_ns + fab.return_ns
        bw = (max(0, math.ceil(chunk / fab.request_bytes)) - 1) \
            * fab.request_bytes * (n - 1) / fab.gpu_bw
        terms = {"alpha": alpha, "bandwidth": bw, "cold": 0.0, "warm": 0.0}
        if not with_rat or not tr.enabled:
            return terms

        # Cold stall: the startup walk(s) outlast the ingress cover once the
        # buffer actually fills (enough requests must remain).
        reqs_per_station = (chunk * (n - 1) / fab.request_bytes
                            / fab.stations_per_gpu)
        l1 = tr.l1.hit_latency_ns
        if reqs_per_station >= fab.ingress_entries:
            terms["cold"] = max(0.0, self.cold_walk_ns - l1 - cover)
        else:
            # Buffer absorbs the whole stream; the walk still gates the last
            # request's completion if it outlasts the stream.
            stream = bw
            terms["cold"] = max(0.0, self.cold_walk_ns - stream)

        # Warm page-transition residue (per flow, pages after the first; the
        # stall — if any — hits every station and persists).
        pages_per_flow = max(1, math.ceil(chunk / tr.page_bytes))
        residue = max(0.0, self.warm_walk_ns - l1 - cover)
        if reqs_per_station >= fab.ingress_entries:
            terms["warm"] = residue * (pages_per_flow - 1) * (n - 1)
        return terms

    def collective_time_ns(self, nbytes: int, with_rat: bool = True) -> float:
        return sum(self._terms(nbytes, with_rat).values())

    def degradation(self, nbytes: int) -> float:
        return (self.collective_time_ns(nbytes, True)
                / self.collective_time_ns(nbytes, False))

    # ------------------------------------------------------------------
    def validate(self, sizes) -> Dict[int, Tuple[float, float, float]]:
        """(model, sim, rel-err) of baseline completion per size."""
        out = {}
        for s in sizes:
            sim = simulate(s, self.cfg).completion_ns
            mod = self.collective_time_ns(s)
            out[s] = (mod, sim, abs(mod - sim) / sim)
        return out


def for_pod(n_gpus: int, **kw) -> CostModel:
    return CostModel(cfg=paper_config(n_gpus, **kw))
