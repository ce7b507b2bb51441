"""The measured window: each call's host times, and what is read off them.

The window opens just before the first call.  Calls are issued until
``--seconds`` have passed since then, and the window closes when the last
call issued returns its first tokens, so every call in it is counted
whole and the rate has no partial call at the end.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence


@dataclass
class Call:
    index: int
    issue: float          # host seconds (perf_counter) at the issue
    done: float           # when the first tokens were on the host
    requests: int
    prompt_tokens: int
    arrived: Optional[List[float]] = None   # None: all at the issue

    def ttfts(self) -> List[float]:
        """Each request's time from its arrival to its first token."""
        if self.arrived is None:
            return [self.done - self.issue] * self.requests
        return [self.done - a for a in self.arrived]


@dataclass
class Window:
    calls: List[Call] = field(default_factory=list)
    opened: Optional[float] = None          # None: the first issue

    @property
    def seconds(self) -> float:
        if not self.calls:
            return 0.0
        start = self.calls[0].issue if self.opened is None else self.opened
        return self.calls[-1].done - start

    @property
    def prompt_tokens(self) -> int:
        return sum(c.prompt_tokens for c in self.calls)

    @property
    def requests(self) -> int:
        return sum(c.requests for c in self.calls)

    def ttfts(self) -> List[float]:
        """One time to first token a request."""
        return [t for c in self.calls for t in c.ttfts()]


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile, linear between the closest ranks (numpy's
    default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of nothing")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
