"""The comparison that decides ``correct``.

During the window the harness keeps, of every call, the last-position
logits and the first token of two requests, rows ``r`` and ``r + B/2``,
and of every ``CACHE_EVERY``-th call the cache that prefill returned for
row ``r``.  ``r`` turns by one from call to call and by one more from one
cached call to the next, so the logits and the caches kept cover every
slot of the batch.  Once the window has closed, a sample drawn from the
seed of the calls that finished (every call whose cache was kept, and
others up to ``CALLS``) is judged against the plain reference, run on the
same prompts and weights in blocks of ``BLOCK`` requests.  The numbers:

- ``token_gap_all``: the widest gap by which a served token's reference
  logit lies below the reference's best;
- ``logits_err``, ``logits_err_max``: the median and the largest over the
  requests of |program logits - reference| / |reference|;
- ``requests_off``: the share of the requests whose logits error or
  token gap passes the cell's limit for one request (``per_request``);
- ``cache_err``: the worst, over the kept caches and every layer's
  leaves (K and V; the conv inputs and the SSM state), of the median over
  the leaf's positions (heads of the state, steps of the conv tail) of
  |program - reference| / |reference|;
- ``cache_err_norm``: the worst, over the same, of the whole leaf's
  |program - reference| / |reference|.

Each cell's file (``workloads/<cell>.json``) names the numbers it is held
to, under ``limits``.  A number that is not finite reads as infinite,
which no limit passes.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from .weights import seed_for

CALLS = 100          # calls judged a run
CACHE_EVERY = 8      # every 8th call keeps one request's cache
BLOCK = 8            # requests a reference forward


@dataclass
class Served:
    """What the program produced for one request, kept for the judgement."""
    call: int
    row: int
    logits: torch.Tensor                       # [V]
    token: int
    cache: Optional[Dict[str, torch.Tensor]]   # the program's, [L, ...]


def kept_rows(call: int, batch: int, seed: int) -> List[int]:
    """The two rows of call ``call`` whose outputs are kept, one in each
    half of the batch; the first is the one whose cache is kept."""
    r = (seed_for(seed, -3) + call + call // CACHE_EVERY) % batch
    return [r] if batch == 1 else [r, (r + batch // 2) % batch]


def choose(done: List[int], n: int, seed: int) -> List[int]:
    """The calls judged: each finished call whose cache was kept, then
    others drawn from the seed, ``n`` in all where that many finished."""
    cached = [i for i in done if i % CACHE_EVERY == 0]
    rest = [i for i in done if i % CACHE_EVERY != 0]
    k = max(0, min(len(rest), n - len(cached)))
    picked = random.Random(seed_for(seed, -4)).sample(rest, k)
    return sorted(cached + picked)


def _finite(v: float) -> float:
    return v if math.isfinite(v) else math.inf


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return _finite(float((a - b).norm() / b.norm().clamp_min(1e-30)))


def _median(v) -> float:
    v = sorted(v)
    return v[len(v) // 2] if len(v) else 0.0


def _unit_err(t: torch.Tensor, r: torch.Tensor) -> float:
    """The median over the leading axis (a cache's positions, heads or
    steps) of each slice's |t - r| / |r|."""
    t, r = t.float().flatten(1), r.float().flatten(1)
    e = (t - r).norm(dim=1) / r.norm(dim=1).clamp_min(1e-30)
    return _finite(float(e.median()))


def judge(served: List[Served], fam, model, params, traffic,
          per_request: Optional[Dict[str, float]] = None,
          stand_in: Optional[str] = None) -> Dict:
    """The numbers over ``served``, and under ``detail`` each request's
    logits error and token gap, with what two faults would read: the
    gap of the token after the reference's best, and the error of the
    next request's logits in this one's place.  With ``stand_in`` (a
    precision of :mod:`reference.plain`) the reference at that precision
    takes the program's place: its argmax is the served token, its logits
    and cache are judged (the control)."""
    gaps, errs, caches, norms, gap_next, err_other = [], [], [], [], [], []
    by_len: Dict[int, List[Served]] = {}
    for s in served:
        by_len.setdefault(traffic.prompt_len(s.call), []).append(s)
    for S, group in sorted(by_len.items()):
        for lo in range(0, len(group), BLOCK):
            blk = group[lo:lo + BLOCK]
            ids = torch.stack([traffic.ids(s.call)[s.row] for s in blk])
            cache = any(s.cache is not None for s in blk)
            with torch.no_grad():
                ref = fam.forward(model, params, ids, cache=cache)
                alt = (fam.forward(model, params, ids, precision=stand_in,
                                   cache=cache) if stand_in else None)
            got_all = []
            for j, s in enumerate(blk):
                best = ref["logits"][j]
                if alt is None:
                    got, tok = s.logits.float(), s.token
                    mine = (None if s.cache is None
                            else fam.port_cache(s.cache, S))
                else:
                    got = alt["logits"][j]
                    tok = int(got.argmax())
                    mine = (None if s.cache is None else
                            {k: v[:, j] for k, v in alt["cache"].items()})
                got_all.append(got)
                gaps.append(_finite(float(best.max() - best[tok])))
                nxt = (int(best.argmax()) + 1) % best.shape[0]
                gap_next.append(_finite(float(best.max() - best[nxt])))
                errs.append(_rel(got, best))
                if mine is not None:
                    pairs = [(t[layer], ref["cache"][leaf][layer, j])
                             for leaf, t in mine.items()
                             for layer in range(t.shape[0])]
                    caches.append(max(_unit_err(a, b) for a, b in pairs))
                    norms.append(max(_rel(a, b) for a, b in pairs))
            for j in range(len(blk)):
                other = got_all[(j + 1) % len(blk)]
                err_other.append(_rel(other, ref["logits"][j]))
            del ref, alt
    out = {"token_gap_all": max(gaps, default=0.0),
           "logits_err": _median(errs),
           "logits_err_max": max(errs, default=0.0),
           "cache_err": max(caches, default=0.0),
           "cache_err_norm": max(norms, default=0.0),
           "requests": len(errs), "caches": len(caches)}
    if per_request:
        off = sum(e > per_request["logits_err"]
                  or g > per_request["token_gap"]
                  for e, g in zip(errs, gaps))
        out["requests_off"] = off / max(1, len(errs))
    out["detail"] = {"logits_err": errs, "token_gap": gaps,
                     "gap_next": gap_next, "err_other": err_other}
    return out


def verdict(numbers: Dict, limits: Dict):
    """(correct, the checks' lines): each number that the cell's file
    limits, beside its limit."""
    checks = {name: {"value": numbers[name], "limit": lim}
              for name, lim in limits["limits"].items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
