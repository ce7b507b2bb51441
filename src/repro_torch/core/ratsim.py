"""Top-level API of the Reverse Address Translation simulator.

Typical use::

    from repro_torch.core import ratsim
    r = ratsim.compare(1 << 20, n_gpus=16)       # baseline vs ideal
    print(r.degradation, r.baseline.mean_rat_ns)
    r = ratsim.compare(1 << 20, 16, collective="ring_allreduce")

    s = ratsim.session(16)                       # persistent-TLB session
    cold = s.run(1 << 20)                        # cold Link TLBs
    warm = s.run(1 << 20)                        # same pages, warm TLBs

All figures of the paper are produced through this module (see benchmarks/).
The ``collective=`` axis selects any registered traffic pattern
(:mod:`repro_torch.core.patterns`); the default is the paper's all-pairs AllToAll.
``sweep`` fans its grid out over a process pool (``workers=0`` forces the
serial path; results are keyed and valued identically either way) and
optionally memoizes points in a caller-supplied cache mapping.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from dataclasses import dataclass
from typing import Dict, Iterable, List, MutableMapping, Optional, Tuple

from .config import SimConfig, FabricConfig, paper_config, MB
from .engine import simulate, RunResult
from .patterns import LOGICAL, PATTERNS
from .select import get_policy
from .session import ENGINES, SimSession
from .topology import TOPOLOGIES


@dataclass
class Comparison:
    baseline: RunResult
    ideal: RunResult

    @property
    def degradation(self) -> float:
        """Completion-time ratio vs the zero-RAT-overhead ideal (Fig. 4)."""
        return self.baseline.completion_ns / self.ideal.completion_ns

    @property
    def rat_fraction(self) -> float:
        """Fraction of mean round-trip latency spent on RAT (+ induced
        ingress stalls) — paper Fig. 6."""
        b = self.baseline.breakdown()
        total = sum(b.values())
        return (b["rat_ns"] + b["stall_ns"]) / total


def _resolve_cfg(n_gpus: int, collective: Optional[str],
                 cfg: Optional[SimConfig], cfg_kw,
                 topology: Optional[str] = None,
                 engine: Optional[str] = None,
                 policy=None, nbytes: Optional[int] = None) -> SimConfig:
    cfg = cfg or paper_config(n_gpus, **cfg_kw)
    if collective is not None:
        cfg = cfg.replace(collective=collective)
    if topology is not None:
        cfg = cfg.replace(
            fabric=dataclasses.replace(cfg.fabric, topology=topology))
    if engine is not None:
        cfg = cfg.replace(engine=engine)
    if policy is not None:
        # Free-standing runs start against stone-cold TLBs: the policy
        # resolves a logical collective for the cold state (sessions track
        # per-region warmth themselves — see SimSession).
        pol = get_policy(policy)
        cfg = cfg.replace(collective=pol.resolve(
            cfg.collective, nbytes if nbytes is not None else 0,
            cfg.fabric, state="cold").collective)
    return cfg


def run(nbytes: int, n_gpus: int = 16, *, collective: Optional[str] = None,
        topology: Optional[str] = None, engine: Optional[str] = None,
        policy=None, cfg: Optional[SimConfig] = None, **cfg_kw) -> RunResult:
    return simulate(nbytes, _resolve_cfg(n_gpus, collective, cfg, cfg_kw,
                                         topology, engine, policy, nbytes))


def compare(nbytes: int, n_gpus: int = 16, *,
            collective: Optional[str] = None,
            topology: Optional[str] = None, engine: Optional[str] = None,
            policy=None, cfg: Optional[SimConfig] = None,
            **cfg_kw) -> Comparison:
    cfg = _resolve_cfg(n_gpus, collective, cfg, cfg_kw, topology, engine,
                       policy, nbytes)
    return Comparison(baseline=simulate(nbytes, cfg),
                      ideal=simulate(nbytes, cfg.ideal()))


def session(n_gpus: int = 16, *, collective: Optional[str] = None,
            topology: Optional[str] = None, engine: Optional[str] = None,
            policy=None, cfg: Optional[SimConfig] = None,
            **cfg_kw) -> SimSession:
    """A persistent-TLB session on a fresh pod (repro_torch.core.session).

    ``policy`` is attached to the session (per-run cold/warm resolution),
    not applied to ``cfg.collective`` up front — each ``run`` resolves with
    the warmth its target region actually has at that point.
    """
    return SimSession(_resolve_cfg(n_gpus, collective, cfg, cfg_kw,
                                   topology, engine), policy=policy)


# ---------------------------------------------------------------- sweeps
# Aggregate grid bytes below which sweep() stays serial: worker spawn costs
# hundreds of ms each, which only the paper's large grids amortize.
_PARALLEL_MIN_BYTES = 64 * MB


def _cache_key(nbytes: int, cfg: SimConfig) -> Tuple[int, str]:
    """Stable fingerprint of one sweep point.

    ``SimConfig`` is a tree of frozen dataclasses of primitives/tuples, so
    its repr is deterministic and total — two configs compare equal iff
    their reprs do.
    """
    return (nbytes, repr(cfg))


def _sweep_point(task) -> Tuple[tuple, Comparison]:
    key, nbytes, cfg = task
    return key, Comparison(baseline=simulate(nbytes, cfg),
                           ideal=simulate(nbytes, cfg.ideal()))


def _spawnable() -> bool:
    """Whether spawn-context workers can bootstrap from this parent.

    Spawn re-imports ``__main__`` in the child; a parent run from stdin or
    an embedded interpreter (``python - <<EOF``) has no importable main and
    every worker would die at bootstrap — stay serial instead.
    """
    main = sys.modules.get("__main__")
    if main is None:
        return False
    if getattr(main, "__spec__", None) is not None:   # python -m ...
        return True
    path = getattr(main, "__file__", None)
    return bool(path) and os.path.exists(path)


def _validate_sweep_axes(colls, topos, engine, policy) -> None:
    """Fail fast on bad axis names, before any pool dispatch.

    A typo'd collective/engine/topology used to surface as a worker
    traceback deep inside the process pool; every name is checked here
    against its registry so the error happens eagerly in the caller, with
    the registry contents in the message.
    """
    if engine is not None and engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; known: {ENGINES}")
    for topo in topos:
        if topo is not None and topo not in TOPOLOGIES:
            raise ValueError(f"unknown topology {topo!r}; known: "
                             f"{sorted(TOPOLOGIES)}")
    for coll in colls:
        if coll is None or coll in PATTERNS:
            continue
        if coll in LOGICAL:
            if policy is None:
                raise ValueError(
                    f"logical collective {coll!r} needs a policy= to pick "
                    f"among its candidates {LOGICAL[coll]}; pass "
                    f"policy='fixed'|'auto'|'table:<path>' or a concrete "
                    f"name")
            continue
        raise ValueError(
            f"unknown collective {coll!r}; known: {sorted(PATTERNS)}"
            f"; logical classes: {sorted(LOGICAL)}")


def sweep(sizes, gpu_counts, *, collectives: Optional[Iterable[str]] = None,
          topologies: Optional[Iterable[str]] = None,
          base_cfg: Optional[SimConfig] = None,
          engine: Optional[str] = None,
          policy=None,
          workers: Optional[int] = None,
          cache: Optional[MutableMapping] = None,
          **cfg_kw) -> Dict[tuple, Comparison]:
    """The paper's main sweep (Figs. 4 and 5), per collective / topology.

    Without ``collectives`` the result keys are ``(n_gpus, size)`` as in the
    seed API; with a list of pattern names they grow a leading axis:
    ``(collective, n_gpus, size)``.  ``topologies`` (registry names from
    :mod:`repro_torch.core.topology`) adds a further leading axis the same way —
    with both, keys are ``(topology, collective, n_gpus, size)``.  Tier
    parameters (leaf size, oversubscription, pod size) come from
    ``base_cfg``'s fabric when given, else the ``FabricConfig`` defaults.
    ``engine`` overrides ``SimConfig.engine`` on every point (bit-for-bit
    identical numbers; ``"vectorized"`` prices large grids ~10x faster —
    note the two engines memoize under distinct cache keys).  ``policy``
    (see :func:`repro_torch.core.select.get_policy`) resolves each point's
    collective — which may then be a *logical* class name like
    ``"allreduce"`` — to a concrete algorithm before dispatch; axis names
    are validated eagerly either way, so typos fail here rather than as a
    worker traceback.

    Points are independent, so large grids fan out over a
    ``concurrent.futures`` process pool — ``workers=None`` sizes the pool to
    the host (capped by the task count) but stays serial below a total-work
    threshold (worker spawn costs dwarf small grids); an explicit
    ``workers>=2`` always uses the pool, ``workers=0`` forces the serial
    in-process path.  All paths produce identical keys and identical
    numbers (each point is one deterministic ``simulate`` pair).  ``cache``
    is an optional mapping memoizing points across calls, keyed by
    ``(nbytes, repr(cfg))``; pass the same dict to successive sweeps (or
    figure scripts) to never price the same point twice.

    Standard spawn semantics apply: a *script* that calls ``sweep()`` at
    top level must guard it with ``if __name__ == "__main__":`` (workers
    re-import the main module); stdin/embedded parents with no importable
    main fall back to the serial path automatically.
    """
    out: Dict[tuple, Comparison] = {}
    tasks: List[tuple] = []
    seen_inflight: Dict[tuple, tuple] = {}
    colls = list(collectives) if collectives is not None else [None]
    topos = list(topologies) if topologies is not None else [None]
    _validate_sweep_axes(colls, topos, engine, policy)
    pol = get_policy(policy)
    for topo in topos:
        for coll in colls:
            for n in gpu_counts:
                for s in sizes:
                    # Rescale only the GPU count; every other fabric field
                    # of base_cfg (gpus_per_node, stations, buffering, tier
                    # parameters...) is kept — pattern shape depends on
                    # them.
                    cfg = (base_cfg.replace(fabric=dataclasses.replace(
                               base_cfg.fabric, n_gpus=n))
                           if base_cfg is not None
                           else paper_config(n, **cfg_kw))
                    if coll is not None:
                        cfg = cfg.replace(collective=coll)
                    if topo is not None:
                        cfg = cfg.replace(fabric=dataclasses.replace(
                            cfg.fabric, topology=topo))
                    if engine is not None:
                        cfg = cfg.replace(engine=engine)
                    if pol is not None:
                        # Per-point resolution (cold state: each sweep
                        # point is a free-standing run on a fresh pod).
                        # Resolution happens in the parent, so the cache
                        # key and the worker both see the concrete name.
                        cfg = cfg.replace(collective=pol.resolve(
                            cfg.collective, s, cfg.fabric,
                            state="cold").collective)
                    key = (n, s)
                    if collectives is not None:
                        key = (coll,) + key
                    if topologies is not None:
                        key = (topo,) + key
                    ck = _cache_key(s, cfg)
                    if cache is not None and ck in cache:
                        out[key] = cache[ck]
                    elif ck in seen_inflight:
                        seen_inflight[ck] += (key,)
                    else:
                        seen_inflight[ck] = (key,)
                        tasks.append((key, s, cfg, ck))

    results: List[Tuple[tuple, Comparison]] = []
    pool_tasks = [(key, s, cfg) for (key, s, cfg, _ck) in tasks]
    n_workers = (min(len(pool_tasks), os.cpu_count() or 1)
                 if workers is None else workers)
    # Spawning workers costs interpreter+numpy startup each; only grids with
    # enough simulation work amortize it.  An explicit workers= request
    # always gets the pool.
    big_enough = (workers is not None
                  or sum(s for (_k, s, _c) in pool_tasks) >= _PARALLEL_MIN_BYTES)
    if n_workers >= 2 and len(pool_tasks) > 1 and big_enough and _spawnable():
        try:
            # Spawned (not forked) workers: the parent process may have torch
            # (multithreaded) loaded, and forking a threaded process can
            # deadlock.  Workers only import repro_torch.core (numpy-only).
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(max_workers=n_workers,
                                     mp_context=ctx) as pool:
                results = list(pool.map(_sweep_point, pool_tasks))
        except (OSError, BrokenProcessPool):
            # No usable subprocess support (a spawn that is refused, killed
            # bootstrap...): fall back to the serial path below.
            results = []
    if not results and pool_tasks:
        results = [_sweep_point(t) for t in pool_tasks]

    for (key, cmp_), (_k, s, cfg, ck) in zip(results, tasks):
        for k in seen_inflight[ck]:
            out[k] = cmp_
        if cache is not None:
            cache[ck] = cmp_
    return out
