"""The port's fleet layer (``repro_torch.serving.fleet``) against
``repro.serving.fleet``, on the CPU.

Every router, the bounded admission queue, the autoscaler (spin-ups,
churn, the live cap, idle retirement, spin-up latency), per-replica
retention and the fleet-wide steps cap give the reference's
``FleetResult`` bit for bit (every replica's stats and steps) and the same
fleet accounting (spin-ups, retirements, peak replicas, replica rows).
``sweep_fleet`` gives the same bits serial, pooled and on either engine.
Nothing here imports torch.
"""
import importlib

import pytest

from test_fleet import TinyFleetMoE, burst_times, tiny_requests
from torch_sim_helpers import (assert_same, assert_same_result,
                               reference_profile, same_or_same_fault,
                               to_port)

jfl = importlib.import_module("repro.serving.fleet")
fl = importlib.import_module("repro_torch.serving.fleet")
jsv = importlib.import_module("repro.serving")
sv = importlib.import_module("repro_torch.serving")
jcfg = importlib.import_module("repro.core.config")
jwl = importlib.import_module("repro.workloads")

TINY = TinyFleetMoE()
GAP = 5e7                                # 50 ms between bursts
FLEET_AGGREGATES = ("requests", "steps", "spin_ups", "retired",
                    "peak_replicas", "served", "replica_rows")


def _fleet(reqs, retention=None, engine="event", mcfg=TINY, **kw):
    """``simulate_fleet`` of both packages on 16-GPU replicas; ``None``
    where both raise the vectorized engine's fault (ROADMAP.md section
    3)."""
    pod = jwl.resolve_pod(jwl.PodSpec(n_gpus=16), mcfg, "decode")
    jc = jcfg.SimConfig(fabric=jwl.pod_fabric(pod), engine=engine,
                        tlb_retention_ns=retention)
    ref, port = same_or_same_fault(
        lambda: jfl.simulate_fleet(mcfg, reqs, n_gpus=16, cfg=jc, **kw),
        lambda: fl.simulate_fleet(mcfg, to_port(reqs), n_gpus=16,
                                  cfg=to_port(jc), **to_port(kw)))
    if ref is not None:
        assert_same_result(ref, port, FLEET_AGGREGATES)
    return port


def test_rid_hash_is_the_reference_s():
    rids = list(range(4096)) + [2**31 - 1, 2**32, 2**40 + 7, 10**18]
    assert [fl._rid_hash(r) for r in rids] == [jfl._rid_hash(r) for r in rids]
    assert fl.ROUTERS == jfl.ROUTERS


@pytest.mark.parametrize("engine", ["event", "vectorized"])
@pytest.mark.parametrize("replicas", [1, 2, 3])
@pytest.mark.parametrize("router", jfl.ROUTERS)
def test_every_router_is_the_reference_s(router, replicas, engine):
    reqs = tiny_requests([i * 1000.0 for i in range(10)], prompt=16,
                         output=3)
    res = _fleet(reqs, engine=engine, replicas=replicas, router=router)
    assert sum(rep.routed for rep in res.replicas) == 10
    if router == "affinity":
        for rep in res.replicas:
            assert all(fl._rid_hash(r.rid) % replicas == rep.idx
                       for r in rep.stats)


@pytest.mark.parametrize("max_queue", [1, 3, 6, None])
def test_bounded_admission(max_queue):
    reqs = tiny_requests([0.0] * 8, prompt=64, output=4)
    res = _fleet(reqs, replicas=1, max_queue=max_queue, max_decode_slots=2)
    assert len(res.requests) + len(res.rejected) == 8
    assert (res.rejected == []) == (max_queue is None)


AUTOSCALE = {
    "scale_up": (1, 6, dict(replicas=4, scale_up_queued=2)),
    "churn": (4, 6, dict(replicas=2, scale_up_queued=1,
                         scale_down_idle_ns=GAP / 4)),
    "min_replicas": (3, 6, dict(replicas=3, min_replicas=2,
                                scale_up_queued=1,
                                scale_down_idle_ns=GAP / 4)),
    "cold_spinup": (2, 8, dict(replicas=2, scale_up_queued=1)),
    "spinup_latency": (1, 8, dict(replicas=2, scale_up_queued=1,
                                  spinup_latency_ns=1e6)),
    "max_replicas": (3, 8, dict(replicas=2, max_replicas=3,
                                router="least_loaded", scale_up_queued=1,
                                scale_down_idle_ns=GAP / 2,
                                spinup_latency_ns=1e5)),
}


@pytest.mark.parametrize("engine", ["event", "vectorized"])
@pytest.mark.parametrize("case", sorted(AUTOSCALE))
def test_autoscaler_is_the_reference_s(case, engine):
    n_bursts, per_burst, kw = AUTOSCALE[case]
    reqs = tiny_requests(burst_times(n_bursts, per_burst, GAP), prompt=16,
                         output=2)
    kw = dict(kw, autoscale=True)
    res = _fleet(reqs, engine=engine, **kw)
    if res is None:
        assert (case, engine) == ("churn", "vectorized")
        return
    assert len(res.finished) == len(res.requests)
    if case == "churn":
        assert res.retired >= 1 and res.spin_ups >= 2
        assert res.peak_replicas <= 2
    if case == "cold_spinup":
        spun = [rep for rep in res.replicas if rep.spun_up_ns > 0.0
                and rep.steps]
        assert spun and all(rep.steps[0].walks > 0 for rep in spun)
    if case == "spinup_latency":
        for rep in res.replicas[1:]:
            assert rep.spun_up_ns >= 1e6
            assert all(s.t_start >= rep.spun_up_ns for s in rep.steps)


def test_retention_and_steps_cap():
    reqs = tiny_requests([0.0, 1000.0, 1e9, 1e9 + 1000.0], prompt=16,
                         output=2)
    res = _fleet(reqs, retention=100_000.0, replicas=2)
    for rep in res.replicas:
        late = [s for s in rep.steps if s.t_start >= 1e9]
        assert late and late[0].walks == rep.steps[0].walks > 0
    res = _fleet(tiny_requests([0.0] * 12, prompt=16, output=40),
                 replicas=3, steps_cap=9)
    assert res.steps_capped and len(res.steps) == 9


def test_granite_fleet_with_profile_and_policy(monkeypatch, tmp_path):
    path = tmp_path / "granite.json"
    reference_profile(monkeypatch, "granite-moe-1b-a400m", "decode_32k", 16,
                      cache_path=path)
    kw = dict(arch="granite-moe-1b-a400m", rps=20.0, arrival="bursty",
              n_requests=6, seed=1, burst_size=3, steps_cap=14,
              prompt_mean=16, output_mean=2, retention_ns=50_000.0,
              profile_path=str(path), policy="auto", engine="vectorized")
    fkw = dict(replicas=2, router="least_loaded", autoscale=True,
               scale_up_queued=1)
    jfp = jfl.FleetPoint(traffic=jsv.TrafficPoint(**kw), **fkw)
    fp = fl.FleetPoint(traffic=sv.TrafficPoint(**kw), **fkw)
    assert_same_result(jfl._fleet_point((jfp,)), fl._fleet_point((fp,)),
                       FLEET_AGGREGATES)


def test_errors_are_the_reference_s():
    reqs = tiny_requests([0.0])
    for kw in (dict(replicas=0), dict(router="random"),
               dict(autoscale=True, min_replicas=3, replicas=2),
               dict(autoscale=True, min_replicas=0)):
        with pytest.raises(ValueError) as jerr:
            jfl.simulate_fleet(TINY, reqs, n_gpus=16, **kw)
        with pytest.raises(ValueError) as err:
            fl.simulate_fleet(TINY, to_port(reqs), n_gpus=16, **kw)
        assert str(err.value) == str(jerr.value)


def _points(mod, engine):
    base = mod.TrafficPoint(arch=TINY, rps=300.0, arrival="bursty", seed=9,
                            n_requests=10, burst_size=4, steps_cap=60,
                            prompt_mean=16, output_mean=2,
                            retention_ns=100_000.0, max_decode_slots=4,
                            prefill_chunk_tokens=32, engine=engine)
    return [mod.FleetPoint(traffic=base, replicas=2, router="round_robin"),
            mod.FleetPoint(traffic=base, replicas=2, router="least_loaded",
                           autoscale=True, min_replicas=1, scale_up_queued=1,
                           scale_down_idle_ns=1e6, spinup_latency_ns=1e5),
            mod.FleetPoint(traffic=base, replicas=3, router="affinity",
                           max_queue=4)]


@pytest.mark.parametrize("engine", ["event", "vectorized"])
def test_sweep_serial_pooled_and_reference(engine):
    # the third point meets the vectorized engine's fault (below)
    n = 3 if engine == "event" else 2
    jpts, pts = _points(jsv, engine)[:n], _points(sv, engine)[:n]
    ref = jfl.sweep_fleet(jpts, workers=0)
    serial = fl.sweep_fleet(pts, workers=0)
    pooled = fl.sweep_fleet(pts + pts[:1], workers=2)
    for jpt, pt in zip(jpts, pts):
        assert_same_result(ref[jpt], serial[pt], FLEET_AGGREGATES)
        assert_same_result(ref[jpt], pooled[pt], FLEET_AGGREGATES)


def test_sweep_prices_duplicates_once(monkeypatch):
    pts = _points(sv, "event")[:2]
    calls = []
    orig = fl._fleet_point

    def counting(task):
        calls.append(task)
        return orig(task)

    monkeypatch.setattr(fl, "_fleet_point", counting)
    out = fl.sweep_fleet([pts[0], pts[0], pts[1]], workers=0)
    assert len(calls) == 2 and set(out) == set(pts)
    ref = jfl.sweep_fleet(_points(jsv, "event")[:2], workers=0)
    for jpt, pt in zip(ref, pts):
        assert_same(ref[jpt], out[pt])


def test_vectorized_fault_is_the_reference_s():
    """A fault of the reference's vectorized engine that the port copies
    (ROADMAP.md section 3): with several sessions in one fleet, its warm
    fast path raises KeyError on these points, in both packages, with the
    same message; the event engine prices them."""
    reqs = tiny_requests(burst_times(4, 6, GAP), prompt=16, output=2)
    assert _fleet(reqs, engine="vectorized", replicas=2, autoscale=True,
                  scale_up_queued=1, scale_down_idle_ns=GAP / 4) is None
    jpt, pt = _points(jsv, "vectorized")[2], _points(sv, "vectorized")[2]
    assert same_or_same_fault(lambda: jfl._fleet_point((jpt,)),
                              lambda: fl._fleet_point((pt,))) == (None, None)
    with pytest.raises(KeyError):
        fl.sweep_fleet([pt, _points(sv, "vectorized")[0]], workers=2)
