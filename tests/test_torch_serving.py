"""The port's serving layer (``repro_torch.serving``) against
``repro.serving``, on the CPU.

The same arrival streams, batcher plans, single-pod traffic runs and
disaggregated runs come out of both packages bit for bit: every field of
every ``Request``, ``RequestStats``, ``ServingStep``, ``KVHandoff`` and
result (``torch_sim_helpers.assert_same``), and every aggregate the CLI and
the figures read (percentiles, degradations, the cold and warm split, the
TTFT decomposition).  Inputs cross with ``to_port``.  The Fig. 15 bursty
point (``test_golden_figs.FIG15_GOLDEN``) is exact on both engines, and
the sweeps give the same bits serial and on a pool of two spawned
workers.  Nothing here imports torch.
"""
import importlib
import math

import pytest

from repro.configs import get_config
from test_golden_figs import FIG15_GOLDEN, FIG15_POINT
from test_serving import TinyDisaggMoE, TinyServeMoE, tiny_requests
from torch_sim_helpers import (DISAGG_AGGREGATES, assert_same,
                               assert_same_result, reference_profile,
                               same_or_repaired, to_port)

jsv = importlib.import_module("repro.serving")
sv = importlib.import_module("repro_torch.serving")
jsim = importlib.import_module("repro.serving.simulate")
sim = importlib.import_module("repro_torch.serving.simulate")
jcfg = importlib.import_module("repro.core.config")
jwl = importlib.import_module("repro.workloads")

ENGINES = ("event", "vectorized")
TINY = TinyServeMoE()
TINY_KV = TinyDisaggMoE()
GRANITE = "granite-moe-1b-a400m"

def both(name, *args, **kw):
    """``name`` of ``repro.serving`` and of the port on the same inputs."""
    return (getattr(jsv, name)(*args, **kw),
            getattr(sv, name)(*to_port(args), **to_port(kw)))


# ---------------------------------------------------------------- arrivals
ARRIVALS = [
    ("poisson_requests", (32, 100.0), dict(seed=11)),
    ("poisson_requests", (64, 0.5), dict(seed=2**32 - 1, prompt_mean=4000,
                                         prompt_cap=4096, output_mean=1)),
    ("poisson_requests", (1, 1000.0), dict(seed=0, start_ns=1.5e9)),
    ("bursty_requests", (32, 100.0), dict(seed=3, burst_size=4)),
    ("bursty_requests", (33, 16.0), dict(seed=7, burst_size=4,
                                         burstiness=24.0, prompt_mean=128,
                                         output_mean=8)),
    ("bursty_requests", (5, 2.5), dict(seed=9, burst_size=1,
                                       burstiness=1.0001, output_cap=3,
                                       start_ns=7.0)),
]


@pytest.mark.parametrize("name,args,kw", ARRIVALS,
                         ids=[f"{a[0].split('_')[0]}{i}"
                              for i, a in enumerate(ARRIVALS)])
def test_generated_streams_are_the_reference_s(name, args, kw):
    ref, port = both(name, *args, **kw)
    assert_same(ref, port)
    assert [r.rid for r in port] == list(range(args[0]))


def test_trace_round_trip_and_ties(tmp_path):
    p = tmp_path / "trace.csv"
    p.write_text("# t,prompt,output\n3000,32,8\n1000,8,2\n\n1000,16,4\n"
                 "2000.5,24,6,extra\n")
    for limit in (None, 1, 2, 3, 10):
        ref, port = both("trace_requests", str(p), limit=limit)
        assert_same(ref, port)
    port = sv.trace_requests(str(p))
    assert [(r.rid, r.arrival_ns, r.prompt_tokens) for r in port] == [
        (0, 1000.0, 8), (1, 1000.0, 16), (2, 2000.5, 24), (3, 3000.0, 32)]


@pytest.mark.parametrize("name,args,kw", [
    ("poisson_requests", (4, 0.0), {}),
    ("poisson_requests", (4, -1.0), {}),
    ("poisson_requests", (4, 10.0), dict(prompt_mean=0)),
    ("poisson_requests", (4, 10.0), dict(output_mean=-3)),
    ("bursty_requests", (4, 10.0), dict(burstiness=1.0)),
    ("bursty_requests", (4, 10.0), dict(burst_size=0)),
    ("bursty_requests", (4, 0.0), {}),
], ids=["rps0", "rps_neg", "prompt0", "output_neg", "burstiness1", "burst0",
        "bursty_rps0"])
def test_arrival_errors_are_the_reference_s(name, args, kw):
    with pytest.raises(ValueError) as jerr:
        getattr(jsv, name)(*args, **kw)
    with pytest.raises(ValueError) as err:
        getattr(sv, name)(*args, **kw)
    assert str(err.value) == str(jerr.value)


def test_trace_point_needs_a_path_and_a_known_process():
    for kw in (dict(arrival="trace"), dict(arrival="uniform")):
        with pytest.raises(ValueError) as jerr:
            jsv.TrafficPoint(**kw).requests()
        with pytest.raises(ValueError) as err:
            sv.TrafficPoint(**kw).requests()
        assert str(err.value) == str(jerr.value)


# ----------------------------------------------------------------- batcher
def _drive(batcher, now, step):
    """One plan and a commit whose times follow from the plan alone."""
    plan = batcher.plan(now)
    if plan is None:
        return plan, batcher.next_arrival_ns()
    t_end = now + 1000.0 + 37.5 * plan.total_tokens
    ideal = now + 900.0 + 31.25 * plan.total_tokens
    batcher.commit(plan, t_end, ideal, 100.0 + step, 80.0 + step / 3,
                   step % 3)
    return plan, t_end


@pytest.mark.parametrize("slots,chunk,seed", [(32, 512, 0), (2, 16, 1),
                                              (1, 7, 2), (4, 64, 3)])
def test_batcher_plans_step_by_step(slots, chunk, seed):
    jreqs = jsv.bursty_requests(24, 400.0, seed=seed, burst_size=5,
                                prompt_mean=40, output_mean=4)
    jb = jsv.ContinuousBatcher(jreqs, max_decode_slots=slots,
                               prefill_chunk_tokens=chunk)
    b = sv.ContinuousBatcher(to_port(jreqs), max_decode_slots=slots,
                             prefill_chunk_tokens=chunk)
    jnow = now = 0.0
    for step in range(400):
        if jb.drained:
            break
        jplan, jnow = _drive(jb, jnow, step)
        plan, now = _drive(b, now, step)
        assert now == jnow
        assert (plan is None) == (jplan is None)
        if plan is not None:
            assert ([r.rid for r in plan.decode]
                    == [r.rid for r in jplan.decode])
            assert ([(r.rid, t) for r, t in plan.prefill]
                    == [(r.rid, t) for r, t in jplan.prefill])
            assert (plan.decode_tokens, plan.prefill_tokens,
                    plan.total_tokens) == (jplan.decode_tokens,
                                           jplan.prefill_tokens,
                                           jplan.total_tokens)
            assert plan.prefill_tokens <= chunk
        assert (b.queued, b.load, b.drained) == (jb.queued, jb.load,
                                                 jb.drained)
        assert len(b.prefilling) + len(b.decoding) <= slots
    assert b.drained and jb.drained
    assert_same(jb.stats, b.stats)
    for r, jr in zip(b.stats, jb.stats):
        for name in ("ttft_ns", "ideal_ttft_ns", "ttft_degradation",
                     "e2e_ns", "e2e_degradation", "mean_itl_ns"):
            assert_same(getattr(jr, name), getattr(r, name), name)


def test_batcher_errors_are_the_reference_s():
    for kw in (dict(max_decode_slots=0), dict(prefill_chunk_tokens=0)):
        with pytest.raises(ValueError) as jerr:
            jsv.ContinuousBatcher([], **kw)
        with pytest.raises(ValueError) as err:
            sv.ContinuousBatcher([], **kw)
        assert str(err.value) == str(jerr.value)
    b = sv.ContinuousBatcher([])
    b.add(sv.Request(0, 5.0, 4, 2))
    with pytest.raises(ValueError, match="out-of-order add"):
        b.add(sv.Request(1, 4.0, 4, 2))


@pytest.mark.parametrize("arrival,t_end,ideal_t_end", [
    (1000.0, 2000.0, 1000.0),        # x / 0: infinite
    (1000.0, 1000.0, 1000.0),        # 0 / 0: 1
    (0.0, 3000.0, 1500.0),
    (10.0, 10.0, 5.0),               # ideal before the arrival: 0 / -5
])
def test_degradation_edge_cases(arrival, t_end, ideal_t_end):
    stats = []
    for mod in (jsv, sv):
        b = mod.ContinuousBatcher([mod.Request(0, arrival, 4, 1)],
                                  prefill_chunk_tokens=8)
        b.commit(b.plan(arrival), t_end, ideal_t_end, 500.0, 100.0, 1)
        stats.append(b.stats[0])
    jr, r = stats
    assert_same(jr, r)
    for name in ("ttft_degradation", "e2e_degradation", "ttft_ns",
                 "ideal_ttft_ns", "e2e_ns"):
        assert_same(getattr(jr, name), getattr(r, name), name)
    jres = jsim.TrafficResult(arch="t", pod=None, cfg=None, requests=[jr],
                              steps=[])
    res = sim.TrafficResult(arch="t", pod=None, cfg=None, requests=[r],
                            steps=[])
    assert_same(jres.ttft_degradations(), res.ttft_degradations())
    assert_same(jres.p99_ttft_degradation, res.p99_ttft_degradation)
    unserved = sv.RequestStats(req=sv.Request(0, 0.0, 4, 1))
    assert unserved.ttft_degradation is None
    assert unserved.e2e_degradation is None


def test_p99_of_two_infinite_degradations_is_inf():
    rows = []
    for mod in (jsv, sv):
        rs = []
        for rid in range(2):
            b = mod.ContinuousBatcher([mod.Request(rid, 10.0, 4, 1)])
            b.commit(b.plan(10.0), 20.0, 10.0, 1.0, 1.0, 0)
            rs.append(b.stats[0])
        rows.append(mod.simulate.TrafficResult(
            arch="t", pod=None, cfg=None, requests=rs, steps=[]))
    assert rows[1].p99_ttft_degradation == math.inf
    assert_same(rows[0].p99_ttft_degradation, rows[1].p99_ttft_degradation)


# ------------------------------------------------------- simulate_traffic
def _cfgs(mcfg, engine, **kw):
    """The reference's SimConfig for ``mcfg``'s decode pod, and the port's."""
    pod = jwl.resolve_pod(jwl.PodSpec(n_gpus=16), mcfg, "decode")
    ref = jcfg.SimConfig(fabric=jwl.pod_fabric(pod), engine=engine, **kw)
    return ref, to_port(ref)


def _traffic(mcfg, reqs, engine, cfg_kw=None, **kw):
    jc, c = _cfgs(mcfg, engine, **(cfg_kw or {}))
    ref = jsv.simulate_traffic(mcfg, reqs, n_gpus=16, cfg=jc, **kw)
    port = sv.simulate_traffic(mcfg, to_port(reqs), n_gpus=16, cfg=c,
                               **to_port(kw))
    return ref, port


TINY_CASES = {
    "slots_and_chunks": (tiny_requests([0.0] * 7, prompt=16, output=4),
                         dict(max_decode_slots=2, prefill_chunk_tokens=16)),
    "interleave": (tiny_requests([0.0, 1.0], prompt=64, output=8),
                   dict(prefill_chunk_tokens=16)),
    "chunked": (tiny_requests([0.0], prompt=100, output=1),
                dict(prefill_chunk_tokens=32)),
    "capped": (tiny_requests([0.0] * 4, prompt=16, output=50),
               dict(steps_cap=5)),
    "capped_mid_prefill": (tiny_requests([0.0], prompt=100, output=4),
                           dict(prefill_chunk_tokens=32, steps_cap=2)),
    "gaps": (tiny_requests([0.0, 5e8, 1e9], prompt=16, output=2), {}),
    "single_token": (tiny_requests([0.0, 1000.0], prompt=16, output=1), {}),
    "long_decode": (tiny_requests([0.0], prompt=16, output=64), {}),
}
RETENTION = {"kept": None, "flushed": 100_000.0}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("retention", sorted(RETENTION))
@pytest.mark.parametrize("case", sorted(TINY_CASES))
def test_tiny_traffic_is_the_reference_s(case, retention, engine):
    reqs, kw = TINY_CASES[case]
    ref, port = _traffic(TINY, reqs, engine,
                         dict(tlb_retention_ns=RETENTION[retention]), **kw)
    assert_same_result(ref, port)


@pytest.mark.parametrize("engine", ENGINES)
def test_retention_gap_repays_the_walks(engine):
    """Two requests 1 s apart: the second's first step walks as the
    first's did under a 100 us retention, and not at all without one."""
    reqs = tiny_requests([0.0, 1e9], prompt=16, output=3)
    for retention in (None, 100_000.0):
        ref, port = _traffic(TINY, reqs, engine,
                             dict(tlb_retention_ns=retention))
        assert_same_result(ref, port)
        second = next(s for s in port.steps if s.t_start >= 1e9)
        assert second.walks == (port.steps[0].walks if retention else 0)


GRANITE_OPTS = {
    "plain": dict(),
    "flushed": dict(retention_ns=50_000.0, arrival="bursty", burst_size=2),
    "pretranslation": dict(pretranslation=True, retention_ns=50_000.0),
    "prefetch": dict(prefetch=True, l2_entries=64),
    "auto": dict(policy="auto", arrival="bursty", burst_size=2,
                 retention_ns=50_000.0),
    "two_tier": dict(topology="two_tier", leaf_size=4, oversubscription=2.0),
}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("opt", sorted(GRANITE_OPTS))
def test_granite_point_is_the_reference_s(opt, engine):
    kw = dict(arch=GRANITE, rps=40.0, n_requests=3, seed=3, steps_cap=6,
              prompt_mean=16, output_mean=3, engine=engine,
              **GRANITE_OPTS[opt])
    jpt, pt = jsv.TrafficPoint(**kw), sv.TrafficPoint(**kw)
    assert_same(jpt.sim_config(), pt.sim_config())
    assert_same(jpt.pod_spec(), pt.pod_spec())
    assert_same(jpt.requests(), pt.requests())
    assert_same_result(jsim._traffic_point((jpt,)), sim._traffic_point((pt,)))


@pytest.mark.parametrize("engine", ENGINES)
def test_calibrated_profile_is_the_reference_s(engine, monkeypatch,
                                               tmp_path):
    """The reference's harness on fixed measurements, as an object and
    through ``TrafficPoint.profile_path``."""
    path = tmp_path / "granite.json"
    jprof = reference_profile(monkeypatch, GRANITE, "decode_32k", 16,
                              cache_path=path)
    reqs = jsv.poisson_requests(3, 50.0, seed=4, prompt_mean=24,
                                output_mean=3)
    jc, c = _cfgs(get_config(GRANITE), engine, tlb_retention_ns=50_000.0)
    ref = jsv.simulate_traffic(GRANITE, reqs, cfg=jc, steps_cap=8,
                               compute_profile=jprof)
    port = sv.simulate_traffic(GRANITE, to_port(reqs), cfg=c, steps_cap=8,
                               compute_profile=to_port(jprof))
    assert_same_result(ref, port)
    kw = dict(arch=GRANITE, rps=50.0, n_requests=3, seed=4, steps_cap=8,
              prompt_mean=24, output_mean=3, engine=engine,
              retention_ns=50_000.0, profile_path=str(path))
    assert_same(jsv.TrafficPoint(**kw).load_profile(),
                sv.TrafficPoint(**kw).load_profile())
    assert_same_result(jsim._traffic_point((jsv.TrafficPoint(**kw),)),
                       sim._traffic_point((sv.TrafficPoint(**kw),)))


@pytest.mark.parametrize("engine", ENGINES)
def test_fig15_bursty_point_golden(engine):
    """``test_golden_figs.test_fig15_bursty_point_bit_for_bit`` on the
    port: every golden field exact, and the tail above the mean."""
    r = sim._traffic_point((sv.TrafficPoint(engine=engine, **FIG15_POINT),))
    ttft = r.ttft_percentiles()
    assert (ttft[50.0], ttft[95.0], ttft[99.0]) == (
        FIG15_GOLDEN["p50"], FIG15_GOLDEN["p95"], FIG15_GOLDEN["p99"])
    assert r.mean_ttft_degradation == FIG15_GOLDEN["mean_deg"]
    assert r.p99_ttft_degradation == FIG15_GOLDEN["p99_deg"]
    assert r.cold_comm_ns == FIG15_GOLDEN["cold_comm_ns"]
    assert r.warm_comm_ns == FIG15_GOLDEN["warm_comm_ns"]
    assert r.cold_steps == FIG15_GOLDEN["cold_steps"]
    assert len(r.steps) == FIG15_GOLDEN["steps"]
    assert sum(s.walks for s in r.steps) == FIG15_GOLDEN["walks"]
    assert len(r.first_token_served) == FIG15_GOLDEN["served"]
    assert r.p99_ttft_degradation > r.mean_ttft_degradation


def test_layout_and_pod_resolution_are_the_reference_s():
    for n_gpus in (8, 16, 32):
        jpod = jwl.resolve_pod(jwl.PodSpec(n_gpus=n_gpus), TINY, "decode")
        pod = to_port(jpod)
        assert (sim.serving_layout(TINY, pod, 544, 2**21)
                == jsim.serving_layout(TINY, jpod, 544, 2**21))
        assert_same(jsim.resolve_traffic_pod(GRANITE, None, n_gpus, None)[1:],
                    sim.resolve_traffic_pod(GRANITE, None, n_gpus, None)[1:])
    jc, c = _cfgs(TINY, "event")
    with pytest.raises(ValueError) as jerr:
        jsim.resolve_traffic_pod(TINY, None, 8, jc)
    with pytest.raises(ValueError) as err:
        sim.resolve_traffic_pod(TINY, None, 8, c)
    assert str(err.value) == str(jerr.value)


# ----------------------------------------------------------------- sweeps
def _points(mod, arch=TINY, **over):
    base = dict(arch=arch, n_requests=6, steps_cap=24, prompt_mean=16,
                output_mean=3, retention_ns=100_000.0, max_decode_slots=4,
                prefill_chunk_tokens=32, **over)
    return [mod.TrafficPoint(rps=200.0, arrival="poisson", seed=5, **base),
            mod.TrafficPoint(rps=200.0, arrival="bursty", seed=5,
                             burst_size=3, **base)]


def test_sweep_serial_pooled_and_reference(tmp_path):
    jpts = _points(jsv, engine="vectorized")
    pts = _points(sv, engine="vectorized")
    ref = jsv.sweep_traffic(jpts, workers=0)
    serial = sv.sweep_traffic(pts, workers=0)
    pooled = sv.sweep_traffic(pts, workers=2)
    assert list(serial) == pts and list(pooled) == pts
    for jpt, pt in zip(jpts, pts):
        assert_same_result(ref[jpt], serial[pt])
        assert_same_result(ref[jpt], pooled[pt])


def test_sweep_prices_duplicates_once(monkeypatch):
    pts = _points(sv)
    calls = []
    orig = sim._traffic_point

    def counting(task):
        calls.append(task)
        return orig(task)

    monkeypatch.setattr(sim, "_traffic_point", counting)
    out = sim.sweep_traffic([pts[0], pts[0], pts[1], pts[0]], workers=0)
    assert len(calls) == 2 and set(out) == set(pts)
    jpts = _points(jsv)
    ref = jsv.sweep_traffic(jpts, workers=0)
    for jpt, pt in zip(jpts, pts):
        assert_same_result(ref[jpt], out[pt])


# ---------------------------------------------------------- disaggregation
def _disagg(reqs, engine="event", retention=None, **kw):
    jc, c = _cfgs(TINY_KV, engine, tlb_retention_ns=retention)
    ref = jsv.simulate_disagg(TINY_KV, reqs, n_gpus=16, cfg=jc, **kw)
    port = sv.simulate_disagg(TINY_KV, to_port(reqs), n_gpus=16, cfg=c,
                              **kw)
    assert_same_result(ref, port, DISAGG_AGGREGATES)
    return port


@pytest.mark.parametrize("engine", ENGINES)
def test_disagg_handoff_and_decomposition(engine):
    reqs = tiny_requests([0.0, 1000.0, 2000.0], prompt=16, output=3)
    reqs.append(jsv.Request(3, 3000.0, 16, 1))       # finishes at prefill
    res = _disagg(reqs, engine)
    assert sorted(h.rid for h in res.handoffs) == [0, 1, 2]
    assert res.requests[3].kv_start_ns is None
    bd = res.ttft_breakdown()
    assert bd["n"] == 3
    assert bd["ttft_ns"] == pytest.approx(
        bd["prefill_ns"] + bd["kv_wait_ns"] + bd["kv_transfer_ns"]
        + bd["decode_wait_ns"])
    for r in res.requests[:3]:
        for name in ("kv_done_ns", "kv_transfer_excess_ns", "prefill_ns",
                     "kv_wait_ns", "decode_wait_ns"):
            assert getattr(r, name) is not None


@pytest.mark.parametrize("split,router", [((1, 1), "round_robin"),
                                          ((2, 1), "least_loaded"),
                                          ((1, 3), "affinity"),
                                          ((2, 2), "round_robin")])
def test_disagg_splits_and_routers(split, router):
    reqs = jsv.bursty_requests(8, 300.0, seed=2, burst_size=4,
                               prompt_mean=24, output_mean=3)
    _disagg(reqs, prefill_pods=split[0], decode_pods=split[1], router=router,
            steps_cap=60)


def test_disagg_serialized_transfers_and_cap():
    _disagg(tiny_requests([0.0] * 6, prompt=16, output=3))
    res = _disagg(tiny_requests([0.0] * 6, prompt=16, output=40),
                  steps_cap=7)
    assert res.steps_capped and len(res.steps) == 7


@pytest.mark.parametrize("retention", [None, 1_000_000.0])
def test_disagg_retention_and_arena(retention):
    """One-slot arena: the second transfer rides the first's warmth, or
    re-pays every walk once the 5 s gap flushes it."""
    reqs = tiny_requests([0.0, 5e9], prompt=64, output=3)
    res = _disagg(reqs, retention=retention, kv_arena_bytes=2 * 2**20)
    first, second = res.handoffs
    assert first.offset == second.offset == 0
    assert second.walks == (first.walks if retention else 0)
    _disagg(reqs, retention=retention, kv_arena_bytes=3 * 2**20)


def test_disagg_off_is_the_colocated_run():
    """Pricing a disaggregated deployment in between leaves the colocated
    run as it was, and that run is the reference's."""
    jpt = jsv.TrafficPoint(arch=TINY_KV, n_requests=5, rps=300.0, seed=9,
                           steps_cap=40, prompt_mean=16, output_mean=3)
    pt = to_port(jpt)
    before = sv.sweep_traffic([pt], workers=0)[pt]
    _disagg(jpt.requests())
    after = sv.sweep_traffic([pt], workers=0)[pt]
    ref = jsv.sweep_traffic([jpt], workers=0)[jpt]
    assert_same_result(ref, before)
    assert_same_result(ref, after)


def test_disagg_errors_are_the_reference_s():
    reqs = tiny_requests([0.0], prompt=16, output=2)
    dup = tiny_requests([0.0, 1.0], prompt=16, output=2)
    dup[1] = jsv.Request(0, 1.0, 16, 2)
    for rs, kw in ((reqs, dict(prefill_pods=0)), (reqs, dict(decode_pods=0)),
                   (reqs, dict(router="nope")), (dup, {})):
        with pytest.raises(ValueError) as jerr:
            jsv.simulate_disagg(TINY_KV, rs, n_gpus=16, **kw)
        with pytest.raises(ValueError) as err:
            sv.simulate_disagg(TINY_KV, to_port(rs), n_gpus=16, **kw)
        assert str(err.value) == str(jerr.value)


def test_disagg_sweep_serial_pooled_and_reference():
    # the vectorized point keeps its translations: with a retention this
    # stream's prefill pod meets a fault of the reference's vectorized
    # engine, which the port copies (ROADMAP.md section 3)
    def points(mod):
        base = dict(arch=TINY_KV, n_requests=6, steps_cap=80,
                    prompt_mean=16, output_mean=3, max_decode_slots=4,
                    prefill_chunk_tokens=32)
        return [mod.DisaggPoint(traffic=mod.TrafficPoint(
                    rps=200.0, seed=5, retention_ns=100_000.0, **base)),
                mod.DisaggPoint(traffic=mod.TrafficPoint(
                    rps=200.0, arrival="bursty", seed=5, burst_size=3,
                    engine="vectorized", **base),
                    prefill_pods=2, decode_pods=1)]

    jpts, pts = points(jsv), points(sv)
    ref = jsv.sweep_disagg(jpts, workers=0)
    serial = sv.sweep_disagg(pts, workers=0)
    pooled = sv.sweep_disagg(pts + pts[:1], workers=2)
    for jpt, pt in zip(jpts, pts):
        assert_same_result(ref[jpt], serial[pt], DISAGG_AGGREGATES)
        assert_same_result(ref[jpt], pooled[pt], DISAGG_AGGREGATES)


def test_vectorized_disagg_fault_is_the_reference_s():
    """The reference's vectorized engine raises KeyError on a disaggregated
    run with a retention, where the pods' sessions share its fast path's
    memo (ROADMAP.md section 3); the port's prices it as its event engine
    does, and its event engine as the reference's."""
    def point(mod, engine):
        return mod.DisaggPoint(traffic=mod.TrafficPoint(
            arch=TINY_KV, rps=200.0, arrival="bursty", seed=5, burst_size=3,
            n_requests=6, steps_cap=80, prompt_mean=16, output_mean=3,
            retention_ns=100_000.0, max_decode_slots=4,
            prefill_chunk_tokens=32, engine=engine))

    jdis = importlib.import_module("repro.serving.disagg")
    dis = importlib.import_module("repro_torch.serving.disagg")
    ref, port = same_or_repaired(
        lambda: jdis._disagg_point((point(jsv, "vectorized"),)),
        lambda: dis._disagg_point((point(sv, "vectorized"),)),
        lambda: dis._disagg_point((point(sv, "event"),)), DISAGG_AGGREGATES)
    assert ref is None and port.kv_cold_handoffs > 0
    assert_same_result(jdis._disagg_point((point(jsv, "event"),)),
                       dis._disagg_point((point(sv, "event"),)),
                       DISAGG_AGGREGATES)
