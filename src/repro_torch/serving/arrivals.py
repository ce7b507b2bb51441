"""Seeded request arrival processes for the serving simulator (DESIGN.md §11).

Every generator materializes the *full* request list up front from one
``numpy.random.default_rng(seed)`` stream, so a fixed seed is bit-for-bit
reproducible regardless of how the simulation is later executed (serial,
process-pooled, resumed) — the arrival stream is data, not a side effect of
the run loop.  Times are nanoseconds on the simulated pod clock; rates are
requests per second of simulated time.

Three processes:

* :func:`poisson_requests` — memoryless arrivals at a fixed rate, the
  open-loop baseline of every serving benchmark;
* :func:`bursty_requests` — an on/off modulated Poisson process: bursts of
  ``burst_size`` requests at ``burstiness``-times the nominal rate,
  separated by off periods sized so the long-run rate is still ``rps``.
  The off periods are what make the Link-TLB retention clock
  (``SimConfig.tlb_retention_ns``) bite: a gap longer than the retention
  window flushes the warmed translations and the next burst re-pays the
  cold walks — the tail-latency mechanism fig15 measures;
* :func:`trace_requests` — replay a recorded trace file, one request per
  line: ``arrival_ns,prompt_tokens,output_tokens`` (``#`` comments and
  blank lines ignored).

Determinism contract: the same generator with the same seed and parameters
returns the identical request list byte-for-byte on every platform —
everything downstream (simulate / fleet / disagg) inherits its determinism
from this.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass(frozen=True)
class Request:
    """One inference request of the arrival stream."""

    rid: int
    arrival_ns: float
    prompt_tokens: int
    output_tokens: int


def _lengths(rng: np.random.Generator, n: int, mean: int, cap: int):
    """Sampled token counts: lognormal around ``mean``, clipped to [1, cap].

    Lognormal matches the long right tail of real prompt/output length
    distributions (most requests short, a few very long) without extra
    parameters; sigma 0.8 puts ~p99 at ~6x the median.
    """
    if mean <= 0:
        raise ValueError(f"mean token count must be positive, got {mean}")
    draws = rng.lognormal(mean=np.log(mean), sigma=0.8, size=n)
    return np.clip(draws.astype(np.int64), 1, max(1, cap))


def poisson_requests(n_requests: int, rps: float, *, seed: int = 0,
                     prompt_mean: int = 256, output_mean: int = 32,
                     prompt_cap: int = 4096, output_cap: int = 512,
                     start_ns: float = 0.0) -> List[Request]:
    """``n_requests`` Poisson arrivals at ``rps`` requests/second."""
    if rps <= 0:
        raise ValueError(f"rps must be positive, got {rps}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(scale=1e9 / rps, size=n_requests)
    times = start_ns + np.cumsum(gaps)
    prompts = _lengths(rng, n_requests, prompt_mean, prompt_cap)
    outputs = _lengths(rng, n_requests, output_mean, output_cap)
    return [Request(i, float(times[i]), int(prompts[i]), int(outputs[i]))
            for i in range(n_requests)]


def bursty_requests(n_requests: int, rps: float, *, burst_size: int = 8,
                    burstiness: float = 16.0, seed: int = 0,
                    prompt_mean: int = 256, output_mean: int = 32,
                    prompt_cap: int = 4096, output_cap: int = 512,
                    start_ns: float = 0.0) -> List[Request]:
    """On/off bursts: ``burst_size`` requests at ``burstiness * rps``, then
    an off period sized so the long-run average rate is ``rps``.

    ``burstiness`` must exceed 1 (1 degenerates to plain Poisson).  The
    mean off period is ``burst_size/rps * (1 - 1/burstiness)`` seconds —
    at the default parameters and single-digit ``rps`` that is hundreds of
    milliseconds of pod silence between bursts, far beyond any plausible
    ``tlb_retention_ns``.
    """
    if rps <= 0:
        raise ValueError(f"rps must be positive, got {rps}")
    if burstiness <= 1.0:
        raise ValueError(f"burstiness must exceed 1, got {burstiness}")
    if burst_size < 1:
        raise ValueError(f"burst_size must be >= 1, got {burst_size}")
    rng = np.random.default_rng(seed)
    intra_scale = 1e9 / (rps * burstiness)
    off_scale = burst_size * 1e9 / rps * (1.0 - 1.0 / burstiness)
    times = []
    t = start_ns
    while len(times) < n_requests:
        if times:                                   # off period between bursts
            t += rng.exponential(scale=off_scale)
        for _ in range(min(burst_size, n_requests - len(times))):
            t += rng.exponential(scale=intra_scale)
            times.append(t)
    prompts = _lengths(rng, n_requests, prompt_mean, prompt_cap)
    outputs = _lengths(rng, n_requests, output_mean, output_cap)
    return [Request(i, float(times[i]), int(prompts[i]), int(outputs[i]))
            for i in range(n_requests)]


def trace_requests(path: str, *, limit: Optional[int] = None) -> List[Request]:
    """Load ``arrival_ns,prompt_tokens,output_tokens`` lines from a file.

    ``limit`` keeps the first ``limit`` data lines *in file order* (the
    natural truncation of a recorded trace), then the kept entries are
    sorted by arrival time.  Request ids are assigned *after* the sort, so
    rids are always 0..n-1 in arrival order exactly as the generated
    processes produce them — an out-of-order trace file does not leak file
    order into rid-based tie-breaks downstream (scheduler admission and
    router affinity both key on rid).  Equal arrival times keep file order
    (stable sort).
    """
    entries: List[tuple] = []           # (arrival_ns, prompt, output)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            arrival, prompt, output = line.split(",")[:3]
            entries.append((float(arrival), int(prompt), int(output)))
            if limit is not None and len(entries) >= limit:
                break
    entries.sort(key=lambda e: e[0])
    return [Request(i, a, p, o) for i, (a, p, o) in enumerate(entries)]
