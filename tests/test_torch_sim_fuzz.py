"""A bounded hypothesis draw: the port's engines against the reference's
same engine on random ``SimConfig``s, on the CPU.

The strategies are the reference's own (``test_engine_fuzz``): pattern,
topology, group placement and stride, L1/L2 geometry, PTW width,
pre-translation and prefetch probes, sizes from sub-page to multi-GB.
Each draw runs through both packages on each engine and must give the same
``RunResult`` bit for bit (per-call session records for the placements).
The draw is derandomized and keeps no example database, so it is the same
on every run and writes nothing into the tree.
"""
import pytest

from repro import core as jcore
from repro_torch import core
from torch_sim_helpers import assert_same, to_port

pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from test_engine_fuzz import group_placements, sim_configs  # noqa: E402

EXAMPLES = 30
FUZZ = settings(max_examples=EXAMPLES, deadline=None, database=None,
                derandomize=True)


@pytest.mark.parametrize("engine", ["event", "vectorized"])
@FUZZ
@given(case=sim_configs())
def test_fuzz_port_engine_matches_reference(engine, case):
    nbytes, cfg = case
    cfg = cfg.replace(engine=engine)
    assert_same(jcore.simulate(nbytes, cfg),
                core.simulate(nbytes, to_port(cfg)))


@pytest.mark.parametrize("engine", ["event", "vectorized"])
@FUZZ
@given(case=group_placements())
def test_fuzz_group_placement_matches_reference(engine, case):
    """Strided subgroups in a 16-GPU pod, a cold and a warm call."""
    group, stride, name, nbytes = case
    cfg = jcore.paper_config(16).replace(engine=engine)
    recs = []
    for session in (jcore.SimSession(cfg), core.SimSession(to_port(cfg))):
        for _ in range(2):
            session.run(nbytes, collective=name, n_gpus=group,
                        rank_stride=stride)
        recs.append((session.records, session.result()))
    assert_same(*recs)
