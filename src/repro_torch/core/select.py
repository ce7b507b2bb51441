"""RAT-aware collective algorithm selection (DESIGN.md §14).

The pattern registry (:mod:`repro_torch.core.patterns`) holds several algorithms
per *logical* collective (``allreduce`` -> ring or recursive doubling,
``all_to_all`` -> direct, hierarchical or pod-granular), but until this
layer existed every caller hard-coded one concrete choice.  An
:class:`AlgorithmPolicy` resolves ``(logical name, nbytes, fabric, TLB
state)`` to a concrete registry name, so derivation, replay and serving can
request collectives by what they *do* and let the policy pick how.

The RAT twist (the paper's Fig. 4/5 mechanism): cold Link-TLB misses tax
algorithms by how many distinct pages each *step* touches, warm runs only by
bandwidth — so the completion-optimal algorithm for a small collective
differs between cold and warm state.  Policies therefore key on
``state in ("cold", "warm")``; callers that track buffer warmth (sessions
per ``base_offset``, :class:`~repro_torch.workloads.derive.StepEmitter` per
logical buffer) pass the state each call observes.

Three policies:

* :class:`FixedPolicy` — maps each logical class to its historical default
  (ring allreduce, direct all-to-all, ...), state-independent.  This is the
  default everywhere, reproducing the pre-policy traces bit-for-bit.
* :class:`AutoPolicy` — exhaustive simulate-and-pick: prices every feasible
  candidate with the vectorized engine (two back-to-back iterations: the
  first is the cold completion, the second the warm one) and picks the
  minimum for the requested state.  Memoized per (candidate, size, fabric).
* :class:`PolicyTable` — a cached resolution table keyed by
  ``(logical, size bucket, topology, n_gpus, state)``, JSON-serializable
  (:meth:`PolicyTable.save`) and loadable without importing torch or pricing
  anything (:meth:`PolicyTable.load`) — the form serving sweeps consume.

``python -m repro_torch.core.select --out table.json`` builds a table over a grid
(the CI artifact); :func:`get_policy` parses the CLI/sweep spec strings
``"fixed" | "auto" | "table:<path>"``.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .config import FabricConfig, SimConfig
from .patterns import LOGICAL, PATTERNS, candidates_for, logical_of

STATES = ("cold", "warm")

# Historical hard-coded choice per logical class: what derivation/serving
# emitted before the policy layer existed.  FixedPolicy resolves to these,
# which is what keeps the default bit-for-bit.
FIXED_DEFAULTS: Dict[str, str] = {
    "all_to_all": "all_to_all",
    "allreduce": "ring_allreduce",
    "all_gather": "all_gather",
    "reduce_scatter": "reduce_scatter",
    "broadcast": "broadcast",
    "kv_transfer": "kv_transfer",
}


def size_bucket(nbytes: int) -> int:
    """Power-of-two size bucket (floor log2) a byte count falls into."""
    return max(0, int(nbytes).bit_length() - 1)


@dataclass(frozen=True)
class Resolution:
    """One policy decision: the concrete algorithm plus its provenance."""

    collective: str     # concrete registry name to run
    logical: str        # logical class that was requested
    provenance: str     # e.g. "fixed", "auto:cold", "table:warm", "explicit"


def _check_state(state: str) -> None:
    if state not in STATES:
        raise ValueError(f"unknown TLB state {state!r}; known: {STATES}")


class AlgorithmPolicy:
    """Resolves a logical collective to a concrete registered algorithm.

    ``resolve`` accepts either a *logical* class name (selected among its
    feasible candidates) or a *concrete* registry name (an explicit request
    — always honored unchanged, so traces that pin an algorithm replay that
    algorithm under any policy).  Names that are both (a logical class named
    after its canonical member, e.g. ``all_to_all``) resolve as logical.
    """

    name = "abstract"

    def resolve(self, logical: str, nbytes: int, fab: FabricConfig,
                state: str = "cold") -> Resolution:
        raise NotImplementedError

    def _classify(self, name: str) -> Tuple[Optional[str], Optional[Resolution]]:
        """(logical_class, explicit_resolution): exactly one is non-None."""
        if name in LOGICAL:
            return name, None
        if name in PATTERNS:
            return None, Resolution(collective=name, logical=logical_of(name),
                                    provenance="explicit")
        raise ValueError(
            f"unknown collective {name!r}; known: {sorted(PATTERNS)}"
            f"; logical classes: {sorted(LOGICAL)}")


class FixedPolicy(AlgorithmPolicy):
    """The historical defaults, state-independent (bit-for-bit baseline)."""

    name = "fixed"

    def __init__(self, overrides: Optional[Dict[str, str]] = None):
        self.choices = dict(FIXED_DEFAULTS)
        for logical, concrete in (overrides or {}).items():
            if logical not in LOGICAL:
                raise ValueError(f"unknown logical class {logical!r}; "
                                 f"known: {sorted(LOGICAL)}")
            if concrete not in LOGICAL[logical]:
                raise ValueError(
                    f"{concrete!r} is not a member of logical class "
                    f"{logical!r} ({LOGICAL[logical]})")
            self.choices[logical] = concrete

    def resolve(self, logical, nbytes, fab, state="cold"):
        _check_state(state)
        cls, explicit = self._classify(logical)
        if explicit is not None:
            return explicit
        return Resolution(collective=self.choices[cls], logical=cls,
                          provenance="fixed")


class AutoPolicy(AlgorithmPolicy):
    """Exhaustive simulate-and-pick over the feasible candidates.

    Every candidate is priced once per (size, fabric) with a two-iteration
    run — iteration 0 completes against stone-cold TLBs, iteration 1
    against the warmth iteration 0 left — giving the (cold, warm)
    completion pair the selection keys on.  Ties break toward the fixed
    default, then registration order, so resolution is deterministic.
    """

    name = "auto"

    def __init__(self, engine: str = "vectorized",
                 base: Optional[SimConfig] = None):
        # ``base`` is the deployment config candidates are priced under
        # (page size, TLB geometry, pre-translation/prefetch, ...); its
        # fabric/collective/engine/iterations fields are overridden per
        # candidate.  None prices under the Table-1 defaults.
        self.engine = engine
        self.base = base
        self._scores: Dict[tuple, Dict[str, Tuple[float, float]]] = {}

    def scores(self, logical: str, nbytes: int,
               fab: FabricConfig) -> Dict[str, Tuple[float, float]]:
        """(cold_ns, warm_ns) completion per feasible candidate."""
        key = (logical, nbytes, repr(fab), repr(self.base))
        cached = self._scores.get(key)
        if cached is not None:
            return cached
        from .engine import simulate
        out: Dict[str, Tuple[float, float]] = {}
        base = self.base if self.base is not None else SimConfig()
        for cand in candidates_for(logical, fab):
            cfg = base.replace(fabric=fab, collective=cand,
                               engine=self.engine, iterations=2,
                               symmetric=True, collect_trace=False)
            res = simulate(nbytes, cfg)
            out[cand] = (res.iterations[0].completion_ns,
                         res.iterations[1].completion_ns)
        self._scores[key] = out
        return out

    def resolve(self, logical, nbytes, fab, state="cold"):
        _check_state(state)
        cls, explicit = self._classify(logical)
        if explicit is not None:
            return explicit
        scores = self.scores(cls, nbytes, fab)
        if not scores:
            raise ValueError(
                f"no feasible algorithm for {cls!r} on {fab.n_gpus} GPUs "
                f"({fab.topology})")
        default = FIXED_DEFAULTS.get(cls)
        order = LOGICAL[cls]
        si = 0 if state == "cold" else 1
        best = min(scores, key=lambda c: (scores[c][si], c != default,
                                          order.index(c)))
        return Resolution(collective=best, logical=cls,
                          provenance=f"auto:{state}")


class PolicyTable(AlgorithmPolicy):
    """Cached resolution table (the serializable form serving consumes).

    Keyed by ``(logical, size_bucket, topology, n_gpus, state)``; lookups
    outside the table fall back to the fixed defaults, so a table built
    over a partial grid is always safe to deploy.  ``save``/``load`` use a
    flat JSON schema (``policy-table-v1``) and import nothing heavier than
    the pattern registry — loading is torch-free by construction, matching
    the serving CLI contract.
    """

    name = "table"
    SCHEMA = "policy-table-v1"

    def __init__(self, entries: Optional[Dict[tuple, str]] = None,
                 meta: Optional[dict] = None):
        self.entries: Dict[tuple, str] = dict(entries or {})
        self.meta = dict(meta or {})
        self._fallback = FixedPolicy()

    def key(self, logical: str, nbytes: int, fab: FabricConfig,
            state: str) -> tuple:
        return (logical, size_bucket(nbytes), fab.topology, fab.n_gpus,
                state)

    def resolve(self, logical, nbytes, fab, state="cold"):
        _check_state(state)
        cls, explicit = self._classify(logical)
        if explicit is not None:
            return explicit
        choice = self.entries.get(self.key(cls, nbytes, fab, state))
        if choice is None:
            res = self._fallback.resolve(cls, nbytes, fab, state)
            return dataclasses.replace(res, provenance="table:miss")
        return Resolution(collective=choice, logical=cls,
                          provenance=f"table:{state}")

    # -- serialization -------------------------------------------------------
    def to_json(self) -> dict:
        rows = [dict(logical=k[0], size_bucket=k[1], topology=k[2],
                     n_gpus=k[3], state=k[4], collective=v)
                for k, v in sorted(self.entries.items())]
        return dict(schema=self.SCHEMA, meta=self.meta, entries=rows)

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=1, sort_keys=True)
            fh.write("\n")

    @classmethod
    def from_json(cls, doc: dict) -> "PolicyTable":
        if doc.get("schema") != cls.SCHEMA:
            raise ValueError(f"not a {cls.SCHEMA} document: "
                             f"schema={doc.get('schema')!r}")
        entries = {}
        for row in doc["entries"]:
            if row["collective"] not in PATTERNS:
                raise ValueError(
                    f"table names unknown collective {row['collective']!r}")
            entries[(row["logical"], row["size_bucket"], row["topology"],
                     row["n_gpus"], row["state"])] = row["collective"]
        return cls(entries=entries, meta=doc.get("meta"))

    @classmethod
    def load(cls, path: str) -> "PolicyTable":
        with open(path) as fh:
            return cls.from_json(json.load(fh))


def build_policy_table(
        sizes, gpu_counts, *,
        logicals=("all_to_all", "allreduce", "all_gather", "reduce_scatter"),
        topologies=("single_clos",),
        leaf_size: int = 0, oversubscription: float = 1.0, pod_size: int = 0,
        engine: str = "vectorized", base: Optional[SimConfig] = None,
        auto: Optional[AutoPolicy] = None) -> PolicyTable:
    """Exhaustively price the grid and cache the per-state optima.

    One entry per ``(logical, bucket(size), topology, n_gpus, state)``;
    sizes falling into the same bucket are priced at their own byte count
    but the later size wins the bucket (pass bucket-aligned sizes — powers
    of two — to avoid the ambiguity).  The function reuses one
    :class:`AutoPolicy` so candidate completions are priced exactly once.
    """
    auto = auto or AutoPolicy(engine=engine, base=base)
    entries: Dict[tuple, str] = {}
    table = PolicyTable()
    for topo in topologies:
        for n in gpu_counts:
            fab = FabricConfig(n_gpus=n, topology=topo, leaf_size=leaf_size,
                               oversubscription=oversubscription,
                               pod_size=pod_size)
            for logical in logicals:
                for nbytes in sizes:
                    if not candidates_for(logical, fab):
                        continue
                    for state in STATES:
                        res = auto.resolve(logical, nbytes, fab, state)
                        entries[table.key(logical, nbytes, fab,
                                          state)] = res.collective
    meta = dict(engine=engine, sizes=[int(s) for s in sizes],
                gpu_counts=[int(n) for n in gpu_counts],
                topologies=list(topologies), logicals=list(logicals))
    if auto.base is not None:
        meta["page_bytes"] = auto.base.translation.page_bytes
    return PolicyTable(entries=entries, meta=meta)


def get_policy(spec) -> Optional[AlgorithmPolicy]:
    """Parse a policy spec: ``None``/instance pass through, strings are
    ``"fixed" | "auto" | "table:<path>"`` (the CLI/sweep-point form)."""
    if spec is None or isinstance(spec, AlgorithmPolicy):
        return spec
    if spec == "fixed":
        return FixedPolicy()
    if spec == "auto":
        return AutoPolicy()
    if isinstance(spec, str) and spec.startswith("table:"):
        return PolicyTable.load(spec[len("table:"):])
    raise ValueError(
        f"unknown policy spec {spec!r}; expected 'fixed', 'auto' or "
        f"'table:<path>'")


def session_collective(policy: Optional[AlgorithmPolicy], cfg: SimConfig,
                       nbytes: int, collective: Optional[str],
                       n_gpus: Optional[int], warm: bool) -> Optional[str]:
    """Per-call policy resolution shared by SimSession and RefSession.

    One helper so the engine session and the oracle mirror resolve
    identically (the oracle-equivalence contract extends to policies).
    ``warm`` is the caller's view of the target region's TLB state.
    Returns the concrete name to run (or the untouched ``collective`` when
    no policy is attached).
    """
    if policy is None:
        return collective
    name = collective if collective is not None else cfg.collective
    fab = cfg.fabric
    fab_n = (fab if n_gpus is None or n_gpus == fab.n_gpus
             else dataclasses.replace(fab, n_gpus=n_gpus))
    return policy.resolve(name, nbytes, fab_n,
                          state="warm" if warm else "cold").collective


def main(argv=None) -> int:
    """CLI: build a policy table JSON over a size/pod grid (CI artifact)."""
    import argparse

    from .config import KB, MB, TranslationConfig
    from .topology import TOPOLOGIES

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.core.select",
        description="Build a RAT-aware algorithm-selection table: price "
                    "every registered candidate per (logical collective, "
                    "size, topology, pod size, cold|warm) and cache the "
                    "optima as JSON (loadable torch-free).")
    p.add_argument("--out", required=True, metavar="JSON",
                   help="output table path")
    p.add_argument("--sizes-mb", default="0.25,1,4,16",
                   help="comma list of collective sizes in MB")
    p.add_argument("--gpus", default="8,16",
                   help="comma list of pod/group sizes")
    p.add_argument("--topologies", default="single_clos",
                   help=f"comma list from {sorted(TOPOLOGIES)}")
    p.add_argument("--logicals",
                   default="all_to_all,allreduce,all_gather,reduce_scatter",
                   help=f"comma list of logical classes {sorted(LOGICAL)}")
    p.add_argument("--engine", default="vectorized",
                   choices=("event", "vectorized"))
    p.add_argument("--page-kb", type=int, default=0,
                   help="translation page size in KB candidates are priced "
                        "under (0: Table-1 default, 2 MB).  Small pages are "
                        "where cold/warm optima diverge (fig17)")
    args = p.parse_args(argv)

    sizes = [int(float(s) * MB) for s in args.sizes_mb.split(",")]
    gpus = [int(g) for g in args.gpus.split(",")]
    topos = [t for t in args.topologies.split(",") if t]
    for t in topos:
        if t not in TOPOLOGIES:
            p.error(f"unknown topology {t!r}; known: {sorted(TOPOLOGIES)}")
    logicals = [c for c in args.logicals.split(",") if c]
    for c in logicals:
        if c not in LOGICAL:
            p.error(f"unknown logical class {c!r}; known: {sorted(LOGICAL)}")

    base = None
    if args.page_kb:
        base = SimConfig(translation=TranslationConfig(
            page_bytes=args.page_kb * KB))
    table = build_policy_table(sizes, gpus, logicals=logicals,
                               topologies=topos, engine=args.engine,
                               base=base)
    table.save(args.out)
    fixed = FixedPolicy()
    diverging = sum(
        1 for (logical, bucket, topo, n, state), coll in table.entries.items()
        if state == "cold"
        and coll != table.entries[(logical, bucket, topo, n, "warm")])
    non_default = sum(1 for (logical, *_rest), coll in table.entries.items()
                      if coll != fixed.choices[logical])
    print(f"# wrote {args.out}: {len(table.entries)} entries, "
          f"{non_default} off the fixed default, "
          f"{diverging} cold/warm-diverging points")
    print("logical,size_bucket,topology,n_gpus,state,collective")
    for (logical, bucket, topo, n, state), coll in sorted(
            table.entries.items()):
        print(f"{logical},{bucket},{topo},{n},{state},{coll}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
