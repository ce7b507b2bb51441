"""The port's engines and reference DES (``repro_torch.core``) against
``repro.core``'s, on the CPU.

The port's simulator is a copy of the reference's host code, so the
contract is bit for bit: each point of the reference's differential
corpus (``test_engine_diff.CORPUS``) and each registered pattern, on each
engine, gives the reference's ``RunResult`` on the same engine, every
field and the trace included; the port's ``simulate_ref`` gives the
reference's where the corpus holds the DES; and a session's per-call
records (retention flushes, strided groups, buffer moves) match call by
call, on both engines and on the reference DES's session.
"""
import pytest

from repro import core as jcore
from repro_torch import core
from test_engine_diff import CORPUS, PATTERN_NAMES, SESSION_SEQ
from torch_sim_helpers import assert_same, to_port

ENGINES = ("event", "vectorized")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name,nbytes,cfg,with_ref", CORPUS,
                         ids=[c[0] for c in CORPUS])
def test_corpus_point_matches_reference(name, nbytes, cfg, with_ref,
                                        engine):
    cfg = cfg.replace(engine=engine)
    assert_same(jcore.simulate(nbytes, cfg),
                core.simulate(nbytes, to_port(cfg)))


@pytest.mark.parametrize("name,nbytes,cfg,with_ref",
                         [c for c in CORPUS if c[3]],
                         ids=[c[0] for c in CORPUS if c[3]])
def test_corpus_point_ref_des_matches_reference(name, nbytes, cfg,
                                                with_ref):
    assert_same(jcore.simulate_ref(nbytes, cfg),
                core.simulate_ref(nbytes, to_port(cfg)))


@pytest.mark.parametrize("engine", ENGINES + ("ref_des",))
@pytest.mark.parametrize("name", PATTERN_NAMES)
def test_every_pattern_matches_reference(name, engine):
    cfg = jcore.paper_config(8).replace(collective=name)
    if engine == "ref_des":
        ours, theirs = core.simulate_ref, jcore.simulate_ref
    else:
        cfg = cfg.replace(engine=engine)
        ours, theirs = core.simulate, jcore.simulate
    assert_same(theirs(1 * jcore.MB, cfg), ours(1 * jcore.MB, to_port(cfg)))


def test_registries_are_the_port_s_own():
    """Same names in both packages' registries, each holding its own
    package's classes."""
    assert sorted(core.PATTERNS) == PATTERN_NAMES
    assert core.LOGICAL == jcore.LOGICAL
    assert sorted(core.TOPOLOGIES) == sorted(jcore.TOPOLOGIES)
    for reg in (core.PATTERNS, core.TOPOLOGIES):
        assert all(c.__module__.startswith("repro_torch.core.")
                   for c in reg.values())


def _session_records(session_cls, cfg):
    sess = session_cls(cfg)
    for nbytes, kw in SESSION_SEQ:
        sess.run(nbytes, **kw)
    return sess.records


@pytest.mark.parametrize("engine,trace", [
    ("event", False), ("event", True), ("vectorized", False),
    ("vectorized", True), ("ref_des", False)])
def test_session_sequence_matches_reference(engine, trace):
    """The reference's heterogeneous session sequence (warm repeats, a
    ring all-reduce, an 8-GPU all-gather, a strided subgroup, an idle
    flush, a buffer move), call by call."""
    cfg = jcore.paper_config(16).replace(tlb_retention_ns=1e6,
                                         collect_trace=trace)
    if engine == "ref_des":
        ours, theirs = core.RefSession, jcore.RefSession
    else:
        cfg = cfg.replace(engine=engine)
        ours, theirs = core.SimSession, jcore.SimSession
    assert_same(_session_records(theirs, cfg),
                _session_records(ours, to_port(cfg)))
    if engine != "ref_des":
        a, b = jcore.SimSession(cfg), core.SimSession(to_port(cfg))
        for nbytes, kw in SESSION_SEQ:
            a.run(nbytes, **kw)
            b.run(nbytes, **kw)
        assert_same(a.result(), b.result())


# A draw of the reference's engine fuzz (test_engine_fuzz) on which its
# engines and its DES disagree: a ring all-gather of 2,215,144 B over 4
# GPUs, every target simulated.  In each of the 3 flows that carry chunk 3
# (offset 1,661,358) the 2 MiB page boundary falls 82 B into request 1702:
# the engines' epoch spans (``core.engine.epoch_spans``) hold that request in
# both pages' spans and count it twice, the DES once (at the page of its
# first byte), as ceil(nbytes / request_bytes) a flow.  The port keeps both
# counts.
FUZZ_DRAW = (2_215_144, dict(collective="all_gather", symmetric=False))
FUZZ_COUNTS = {"event": (25_971, 9_469), "vectorized": (25_971, 9_469),
               "des": (25_968, 9_466)}


@pytest.mark.parametrize("engine", sorted(FUZZ_COUNTS))
def test_fuzz_draw_counts_are_the_reference_s(engine):
    nbytes, kw = FUZZ_DRAW
    cfg = jcore.paper_config(4).replace(**kw)
    if engine == "des":
        ref = jcore.simulate_ref(nbytes, cfg)
        port = core.simulate_ref(nbytes, to_port(cfg))
    else:
        cfg = cfg.replace(engine=engine)
        ref = jcore.simulate(nbytes, cfg)
        port = core.simulate(nbytes, to_port(cfg))
    assert_same(ref, port)
    c = port.counters
    assert (c.requests, c.by_class["l1_mshr_hum"]) == FUZZ_COUNTS[engine]
