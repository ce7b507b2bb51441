"""The port's pattern registry, topologies, algorithm selection, cost
model and scheduler against ``repro.core``'s, on the CPU.

Every registered pattern's schedule (``steps`` and ``StepArrays``) and
every topology's paths, tiers and groups at 4, 8, 16 and 64 GPUs equal the
reference's; where the reference raises, the port raises the same error.
``build_policy_table`` prices the same optima and writes the same JSON
byte for byte, and each package loads the other's table.  ``TranslationAwareScheduler``'s plans equal
the reference's field by field.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro import core as jcore
from repro.core import cost_model as jcost
from repro.core import patterns as jpatterns
from repro.core import scheduler as jscheduler
from repro.core import select as jselect
from repro_torch import core
from repro_torch.core import cost_model, patterns, scheduler, select
from torch_sim_helpers import assert_same, to_port

MB = core.MB
N_GPUS = (4, 8, 16, 64)
# Every topology with its tier parameters: the defaults, a leaf of 8 (and
# one past small pods), oversubscribed spines, pods of 4 and 16.
FABRICS = [
    dict(),
    dict(topology="two_tier"),
    dict(topology="two_tier", leaf_size=8, oversubscription=2.0),
    dict(topology="two_tier", leaf_size=16, oversubscription=4.0),
    dict(topology="multi_pod"),
    dict(topology="multi_pod", pod_size=4),
    dict(topology="multi_pod", pod_size=16, interpod_oversubscription=1.0),
]
FAB_IDS = [",".join(f"{k}={v}" for k, v in kw.items()) or "single_clos"
           for kw in FABRICS]


def _outcome(fn):
    try:
        return "ok", fn()
    except ValueError as err:
        return "ValueError", str(err)


def _same_outcome(theirs, ours):
    a, b = _outcome(theirs), _outcome(ours)
    assert a[0] == b[0], (a, b)
    if a[0] == "ok":
        assert_same(a[1], b[1])
    else:
        assert a[1] == b[1]
    return a[0] == "ok"


@pytest.mark.parametrize("n", N_GPUS)
@pytest.mark.parametrize("fab_kw", FABRICS, ids=FAB_IDS)
def test_every_pattern_schedule_matches_reference(fab_kw, n):
    jfab = jcore.FabricConfig(n_gpus=n, **fab_kw)
    fab = to_port(jfab)
    n_ok = 0
    for name in sorted(jpatterns.PATTERNS):
        jpat, pat = jpatterns.get_pattern(name), patterns.get_pattern(name)
        assert type(pat).feasible(fab) == type(jpat).feasible(jfab)
        for nbytes in (4 * 1024 + 13, 1 * MB, 24 * MB):
            n_ok += _same_outcome(lambda: jpat.steps(nbytes, jfab),
                                  lambda: pat.steps(nbytes, fab))
            _same_outcome(lambda: jpat.steps_arrays(nbytes, jfab),
                          lambda: pat.steps_arrays(nbytes, fab))
            _same_outcome(
                lambda: jpatterns.analytic_volume(name, nbytes, jfab),
                lambda: patterns.analytic_volume(name, nbytes, fab))
        _same_outcome(lambda: jpat.representative_dst(jfab),
                      lambda: pat.representative_dst(fab))
    assert n_ok > 0
    for logical in sorted(jpatterns.LOGICAL):
        assert patterns.candidates_for(logical, fab) \
            == jpatterns.candidates_for(logical, jfab)


def test_step_arrays_strides_and_degrees_match_reference():
    jfab = jcore.FabricConfig(n_gpus=16, topology="two_tier", leaf_size=4)
    for name in sorted(jpatterns.PATTERNS):
        jpat, pat = jpatterns.get_pattern(name), patterns.get_pattern(name)
        if not type(jpat).feasible(jfab):
            continue
        for ja, a in zip(jpat.steps_arrays(2 * MB, jfab),
                         pat.steps_arrays(2 * MB, to_port(jfab))):
            assert_same(ja.with_stride(3), a.with_stride(3))
            assert_same(ja.out_deg(), a.out_deg())


@pytest.mark.parametrize("n", N_GPUS)
@pytest.mark.parametrize("fab_kw", FABRICS, ids=FAB_IDS)
def test_every_topology_matches_reference(fab_kw, n):
    jfab = jcore.FabricConfig(n_gpus=n, **fab_kw)
    fab = to_port(jfab)
    if not _same_outcome(lambda: jcore.get_topology(jfab).describe(),
                         lambda: core.get_topology(fab).describe()):
        return
    jt, t = jcore.get_topology(jfab), core.get_topology(fab)
    assert type(t).__name__ == type(jt).__name__ and t.flat == jt.flat
    for meth in ("tier0_group", "local_group", "pod_group", "n_pods"):
        assert_same(getattr(jt, meth)(), getattr(t, meth)())
    for tier in range(3):
        assert_same(jt.tier_capacity(tier), t.tier_capacity(tier))
    ranks = range(n)
    for src in ranks:
        assert_same(jt.pod_of(src), t.pod_of(src))
        for dst in ranks:
            assert_same(jt.path_latency_ns(src, dst),
                        t.path_latency_ns(src, dst))
            assert_same(jt.return_latency_ns(dst, src),
                        t.return_latency_ns(dst, src))
            assert_same(jt.tier(src, dst), t.tier(src, dst))
    src = np.repeat(np.arange(n, dtype=np.int64), n)
    dst = np.tile(np.arange(n, dtype=np.int64), n)
    for meth in ("tier_arr", "path_latency_arr"):
        assert_same(getattr(jt, meth)(src, dst), getattr(t, meth)(src, dst))
        assert_same(getattr(jt, meth)(src, 0), getattr(t, meth)(src, 0))
    assert_same(jt.return_latency_arr(dst, src),
                t.return_latency_arr(dst, src))


# ------------------------------------------------------------ selection
def _resolutions(mod, policy, fab):
    out = []
    for logical in sorted(mod.LOGICAL) + ["ring_allreduce", "all_gather"]:
        for nbytes in (256 * 1024, 8 * MB, 33 * MB):
            for state in ("cold", "warm"):
                out.append(_outcome(lambda: policy.resolve(
                    logical, nbytes, fab, state)))
    return out


@pytest.mark.parametrize("spec", ["fixed", "auto"])
@pytest.mark.parametrize("fab_kw", [dict(n_gpus=16), dict(
    n_gpus=8, topology="two_tier", leaf_size=4), dict(
    n_gpus=16, topology="multi_pod", pod_size=8)])
def test_policies_resolve_as_the_reference(spec, fab_kw):
    jfab = jcore.FabricConfig(**fab_kw)
    assert_same(_resolutions(jpatterns, jselect.get_policy(spec), jfab),
                _resolutions(patterns, select.get_policy(spec),
                             to_port(jfab)))


def test_policy_errors_match_reference():
    for args in (("warp",), ("table:/nonexistent/t.json",)):
        with pytest.raises(Exception) as theirs:
            jselect.get_policy(*args)
        with pytest.raises(Exception) as ours:
            select.get_policy(*args)
        assert (type(ours.value), str(ours.value)) \
            == (type(theirs.value), str(theirs.value))
    for kw in (dict(overrides={"allreduce": "all_gather"}),
               dict(overrides={"gather": "all_gather"})):
        with pytest.raises(ValueError) as theirs:
            jselect.FixedPolicy(**kw)
        with pytest.raises(ValueError) as ours:
            select.FixedPolicy(**kw)
        assert str(ours.value) == str(theirs.value)
    assert select.size_bucket(33 * MB) == jselect.size_bucket(33 * MB)


# (page KB, sizes, pod sizes): Table-1 pages, and 4 KB pages (where cold
# and warm optima part) on a smaller grid, since a 4 KB page is 512 times
# the walks of a 2 MB one.
TABLE_GRIDS = [(0, [1 * MB, 8 * MB, 32 * MB], [8, 16]),
               (4, [256 * 1024, 2 * MB], [8])]


@pytest.mark.parametrize("page_kb,sizes,gpus", TABLE_GRIDS,
                         ids=["2MB_pages", "4KB_pages"])
def test_policy_table_json_is_the_reference_s(page_kb, sizes, gpus,
                                              tmp_path):
    """Same optima, same bytes; each package loads the other's table."""
    kw = dict(logicals=("allreduce", "all_to_all", "all_gather"),
              topologies=("single_clos", "two_tier"), leaf_size=4)
    jbase = (jcore.SimConfig(translation=jcore.TranslationConfig(
        page_bytes=page_kb * 1024)) if page_kb else None)
    theirs = jselect.build_policy_table(sizes, gpus, base=jbase, **kw)
    ours = select.build_policy_table(sizes, gpus, base=to_port(jbase), **kw)
    assert ours.entries == theirs.entries and ours.meta == theirs.meta
    jpath, path = tmp_path / "j.json", tmp_path / "t.json"
    theirs.save(str(jpath))
    ours.save(str(path))
    assert path.read_bytes() == jpath.read_bytes()
    assert select.PolicyTable.load(str(jpath)).entries == theirs.entries
    assert jselect.PolicyTable.load(str(path)).entries == ours.entries
    fab = core.FabricConfig(n_gpus=16)
    table = select.get_policy(f"table:{path}")
    assert_same(_resolutions(jpatterns, jselect.get_policy(f"table:{jpath}"),
                             jcore.FabricConfig(n_gpus=16)),
                _resolutions(patterns, table, fab))
    bad = json.loads(path.read_text())
    bad["schema"] = "policy-table-v0"
    with pytest.raises(ValueError, match="not a policy-table-v1"):
        select.PolicyTable.from_json(bad)


# ------------------------------------------------ cost model, scheduler
@pytest.mark.parametrize("n", N_GPUS)
def test_cost_model_matches_reference(n):
    jm, m = jcost.for_pod(n), cost_model.for_pod(n)
    assert_same(jm, m)
    for nbytes in (4096, 1 * MB, 16 * MB, 1 << 30):
        for rat in (True, False):
            assert_same(jm._terms(nbytes, rat), m._terms(nbytes, rat))
            assert_same(jm.collective_time_ns(nbytes, rat),
                        m.collective_time_ns(nbytes, rat))
        assert_same(jm.degradation(nbytes), m.degradation(nbytes))
    assert_same(jm.validate([1 * MB]), m.validate([1 * MB]))


@pytest.mark.parametrize("n", N_GPUS)
def test_scheduler_plans_match_reference(n):
    """Plans field by field (with and without compute to hide the cold
    walks in, and under an ideal translation), and their JSON."""
    jcfg = jcore.paper_config(n)
    for cfg_kw in (dict(), dict(cfg=jcfg.ideal()),
                   dict(overlap_compute_ns=5e3)):
        port_kw = {k: to_port(v) for k, v in cfg_kw.items()}
        js = jscheduler.TranslationAwareScheduler(n, **cfg_kw)
        s = scheduler.TranslationAwareScheduler(n, **port_kw)
        for nbytes in (64 * 1024, 1 * MB, 16 * MB, 256 * MB):
            for compute in (None, 0.0, 2e3, 1e6):
                jp = js.plan_all_to_all(nbytes, compute_ns=compute)
                p = s.plan_all_to_all(nbytes, compute_ns=compute)
                assert_same(jp, p)
                assert p.est_speedup == jp.est_speedup
                assert p.to_json() == json.dumps(
                    dataclasses.asdict(jp), indent=2, sort_keys=True)
                assert scheduler.CollectivePlan.from_json(p.to_json()) == p
