"""The schedule of one collective (counterpart of
``repro.core.scheduler.CollectivePlan``).

Only the plan is copied: the reference's ``TranslationAwareScheduler``
prices plans with the cost model, which imports the event engine.  A plan
reaches the port as fields or as JSON, which the reference writes with
``json.dumps(dataclasses.asdict(plan))`` for a ``plan`` from
``TranslationAwareScheduler(n).plan_all_to_all(nbytes)``.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, fields


@dataclass(frozen=True)
class CollectivePlan:
    total_bytes: int
    n_peers: int
    warmup_chunk_bytes: int
    n_chunks: int
    per_peer_buffer_bytes: int
    est_time_ns: float
    est_time_unscheduled_ns: float

    @property
    def est_speedup(self) -> float:
        return self.est_time_unscheduled_ns / max(self.est_time_ns, 1e-9)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "CollectivePlan":
        """The seven fields, no more and no fewer (a ``ValueError`` names
        the difference)."""
        d = json.loads(text)
        want = {f.name for f in fields(cls)}
        if set(d) != want:
            raise ValueError(f"CollectivePlan JSON: missing "
                             f"{sorted(want - set(d))}, unknown "
                             f"{sorted(set(d) - want)}")
        return cls(**d)
