"""The reference's golden numbers, given by the port's simulator alone,
and ``ratsim`` held to ``repro.core.ratsim``, on the CPU.

The goldens are the reference tests' own constants (``test_patterns``'
seed all-to-all, ``test_golden_figs``' Fig. 4/5, Fig. 11 and Fig. 14
rows), each on both of the port's engines and compared with ``==``.
``compare``, ``run``, ``session`` and ``sweep`` (serial and on a pool of
two, with a cache) return the reference's results field for field.
"""
import dataclasses

import pytest

from repro import core as jcore
from repro.core import ratsim as jratsim
from repro_torch import core
from repro_torch.core import ratsim
from repro_torch.core.config import FabricConfig, SimConfig, TLBConfig
from test_golden_figs import (FIG11_DEG, FIG11_GOLDEN, FIG14_GOLDEN,
                              FIG45_GOLDEN)
from test_patterns import SEED_GOLDEN
from torch_sim_helpers import assert_same, to_port

MB = core.MB
ENGINES = ("event", "vectorized")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("size,n,base,ideal,reqs,walks", SEED_GOLDEN)
def test_seed_all_to_all_golden(size, n, base, ideal, reqs, walks, engine):
    r = core.simulate(size, core.paper_config(n, engine=engine))
    i = core.simulate(size, core.paper_config(n, engine=engine).ideal())
    assert (r.completion_ns, i.completion_ns) == (base, ideal)
    assert (r.counters.requests, r.counters.walks) == (reqs, walks)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("n,size", sorted(FIG45_GOLDEN))
def test_fig45_golden(n, size, engine):
    base, ideal, mean_rat, reqs, walks = FIG45_GOLDEN[(n, size)]
    c = ratsim.compare(size, n, engine=engine)
    assert c.baseline.completion_ns == base
    assert c.ideal.completion_ns == ideal
    assert c.baseline.mean_rat_ns == mean_rat
    assert (c.baseline.counters.requests, c.baseline.counters.walks) \
        == (reqs, walks)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("entries", sorted(FIG11_GOLDEN))
def test_fig11_golden(entries, engine):
    cfg = core.paper_config(32, engine=engine)
    tr = dataclasses.replace(
        cfg.translation,
        l2=TLBConfig(entries=entries, assoc=2, hit_latency_ns=100.0,
                     mshr_entries=512))
    c = ratsim.compare(16 * MB, 32, cfg=cfg.replace(translation=tr))
    assert c.baseline.completion_ns == FIG11_GOLDEN[entries]
    assert c.degradation == FIG11_DEG


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("topo,n", sorted(FIG14_GOLDEN))
def test_fig14_golden(topo, n, engine):
    cold, warm, i_cold, i_warm, walks = FIG14_GOLDEN[(topo, n)]
    cfg = SimConfig(fabric=FabricConfig(n_gpus=n, topology=topo,
                                        leaf_size=16, oversubscription=2.0,
                                        pod_size=16),
                    iterations=2, engine=engine)
    c = ratsim.compare(1 * MB, n, cfg=cfg)
    b, i = c.baseline.iterations, c.ideal.iterations
    assert (b[0].completion_ns, b[1].completion_ns) == (cold, warm)
    assert (i[0].completion_ns, i[1].completion_ns) == (i_cold, i_warm)
    assert c.baseline.counters.walks == walks


# ------------------------------------------------- ratsim against repro's
RATSIM_CASES = [
    dict(),
    dict(collective="ring_allreduce"),
    dict(collective="rd_allreduce", engine="vectorized"),
    dict(topology="two_tier", collective="hier_all_to_all"),
    dict(collective="allreduce", policy="auto"),
    dict(collective="all_gather", policy="fixed", engine="vectorized"),
    dict(symmetric=False, collective="broadcast"),
]


@pytest.mark.parametrize("kw", RATSIM_CASES,
                         ids=lambda kw: ",".join(f"{k}={v}" for k, v in
                                                 kw.items()) or "default")
def test_compare_and_run_match_reference(kw):
    assert_same(jratsim.compare(4 * MB, 16, **kw),
                ratsim.compare(4 * MB, 16, **kw))
    assert_same(jratsim.run(1 * MB, 8, **kw), ratsim.run(1 * MB, 8, **kw))


def test_session_matches_reference():
    """A policy session: per-run cold/warm resolution, then a flush."""
    kw = dict(collective="allreduce", policy="auto", tlb_retention_ns=1e5)
    ours, theirs = ratsim.session(16, **kw), jratsim.session(16, **kw)
    for s in (ours, theirs):
        s.run(8 * MB)
        s.run(8 * MB)
        s.run(8 * MB, gap_ns=2e5)
    assert_same(theirs.records, ours.records)


SWEEP_KW = [
    dict(),
    dict(collectives=["all_to_all", "ring_allreduce"],
         topologies=["single_clos", "two_tier"]),
    dict(collectives=["allreduce"], policy="auto", engine="vectorized"),
]


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("kw", SWEEP_KW, ids=["seed", "axes", "policy"])
def test_sweep_matches_reference(kw, workers):
    sizes, gpus = [1 * MB, 4 * MB], [8, 16]
    cache = {}
    ours = ratsim.sweep(sizes, gpus, workers=workers, cache=cache, **kw)
    assert_same(jratsim.sweep(sizes, gpus, workers=0, **kw), ours)
    assert len(cache) == len(ours)
    assert ratsim.sweep(sizes, gpus, workers=workers, cache=cache,
                        **kw) == ours                 # every point cached


def test_sweep_base_cfg_and_errors_match_reference():
    base = jcore.paper_config(8).replace(
        fabric=dataclasses.replace(jcore.paper_config(8).fabric,
                                   ingress_entries=64))
    assert_same(jratsim.sweep([2 * MB], [8, 16], base_cfg=base, workers=0),
                ratsim.sweep([2 * MB], [8, 16], base_cfg=to_port(base),
                             workers=0))
    for bad in (dict(collectives=["warp"]), dict(engine="warp"),
                dict(topologies=["torus"]), dict(collectives=["allreduce"])):
        with pytest.raises(ValueError) as theirs:
            jratsim.sweep([1 * MB], [8], workers=0, **bad)
        with pytest.raises(ValueError) as ours:
            ratsim.sweep([1 * MB], [8], workers=0, **bad)
        assert str(ours.value) == str(theirs.value)
