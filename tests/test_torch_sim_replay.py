"""The port's replay (``repro_torch.workloads.replay``) and its CLI
against ``repro.workloads``, on the CPU.

The reference's replay goldens come out of the port bit for bit on both
engines: the TinyMoE decode (``test_golden_figs.TINY_REPLAY_GOLDEN``),
the Fig. 13 rows, and the four ``decode_32k`` trajectories on 16 GPUs
(granite-moe-1b-a400m, qwen3-moe-235b-a22b, mamba2-780m, qwen3-1.7b) that
chip_smoke replays on the card's windows.  Replays with retention flushes,
hierarchical pods and profile windows equal the reference's
``ReplayResult`` field by field.  Nothing here imports torch.
"""
import importlib

import pytest

from repro.core.config import SimConfig as JSimConfig
from repro_torch.core.config import SimConfig
from test_calibrate import TinyMoE
from test_golden_figs import FIG13_GOLDEN, TINY_REPLAY_GOLDEN
from torch_sim_helpers import assert_same, reference_profile, to_port

jwl = importlib.import_module("repro.workloads")
wl = importlib.import_module("repro_torch.workloads")

ENGINES = ("event", "vectorized")

# decode_32k on 16 GPUs, 4 steps, roofline windows: (calls, cold, steady),
# as the reference gives them.
TRAJECTORIES = {
    "granite-moe-1b-a400m": (384, 1.0385299752084558, 1.0238381789497693),
    "qwen3-moe-235b-a22b": (1504, 1.026539485863973, 1.026244428666169),
    "mamba2-780m": (384, 1.0314000241852133, 1.0239917770122902),
    "qwen3-1.7b": (448, 1.0270568019454576, 1.0226211589273508),
}


def _replay(arch, engine, n_steps=4, **kw):
    trace = wl.derive_workload(arch, "decode_32k", n_gpus=16,
                               n_steps=n_steps)
    cfg = SimConfig(fabric=wl.pod_fabric(trace.pod), engine=engine, **kw)
    return wl.replay(trace, cfg=cfg)


@pytest.mark.parametrize("engine", ENGINES)
def test_tiny_moe_replay_golden(engine):
    trace = wl.derive_workload(TinyMoE(), "decode_32k", n_gpus=8, n_steps=3)
    rep = wl.replay(trace, cfg=SimConfig(fabric=wl.pod_fabric(trace.pod),
                                         engine=engine))
    assert [(s.step, s.comm_ns, s.ideal_comm_ns, s.walks, s.requests)
            for s in rep.steps] == TINY_REPLAY_GOLDEN


@pytest.mark.parametrize("engine", ENGINES)
def test_fig13_rows_golden(engine):
    """The rows of ``benchmarks.paper_figs.fig13_workload_replay``."""
    rows = []
    for arch, n_tok in (("granite-moe-1b-a400m", 4),
                        ("qwen3-moe-235b-a22b", 2)):
        rep = _replay(arch, engine, n_steps=n_tok)
        for s in rep.steps:
            rows.append((f"fig13/{arch}/token{s.step}", s.comm_ns / 1e3,
                         f"degradation={s.degradation:.4f};walks={s.walks}"))
        cold, steady = rep.cold_degradation, rep.steady_degradation
        rows.append((f"fig13/{arch}/check_cold_above_steady", 0.0,
                     f"cold={cold:.4f};steady={steady:.4f};"
                     f"warms_up={cold > steady}"))
    assert rows == FIG13_GOLDEN


@pytest.mark.parametrize("arch", sorted(TRAJECTORIES))
def test_decode_trajectory_matches_reference(arch):
    """Both engines give the reference's numbers to every digit, and the
    event engine's replay is the reference's field by field."""
    n_calls, cold, steady = TRAJECTORIES[arch]
    reps = [_replay(arch, engine) for engine in ENGINES]
    for rep in reps:
        assert len(rep.trace.calls) == n_calls
        assert (rep.cold_degradation, rep.steady_degradation) \
            == (cold, steady)
    assert reps[1].steps == reps[0].steps
    trace = jwl.derive_workload(arch, "decode_32k", n_gpus=16, n_steps=4)
    assert_same(jwl.replay(trace), reps[0])
    if arch == "granite-moe-1b-a400m":
        assert [s.walks for s in reps[0].steps] == [72, 0, 0, 0]


REPLAY_CASES = [
    ("granite-moe-1b-a400m", "decode_32k", 16, dict(),
     dict(tlb_retention_ns=50_000.0)),
    ("tiny-moe", "decode_32k", 8, dict(topology="two_tier", leaf_size=4,
                                       oversubscription=2.0), dict()),
    ("tiny-moe", "train_4k", 8, dict(topology="multi_pod", pod_size=4),
     dict()),
    ("qwen3-1.7b", "prefill_32k", 16, dict(buffer_reuse="pooled"),
     dict(collect_trace=True)),
]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("arch,shape,n,pod_kw,cfg_kw", REPLAY_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in REPLAY_CASES])
def test_replay_matches_reference(arch, shape, n, pod_kw, cfg_kw, engine):
    model = TinyMoE() if arch == "tiny-moe" else arch
    jtrace = jwl.derive_workload(model, shape, n_gpus=n, n_steps=2,
                                 pod=jwl.PodSpec(**pod_kw))
    trace = wl.derive_workload(model, shape, n_gpus=n, n_steps=2,
                               pod=wl.PodSpec(**pod_kw))
    jcfg = JSimConfig(fabric=jwl.pod_fabric(jtrace.pod), engine=engine,
                      **cfg_kw)
    assert_same(jwl.replay(jtrace, cfg=jcfg),
                wl.replay(trace, cfg=to_port(jcfg)))
    assert_same(jwl.buffer_layout(jtrace, 1 << 21),
                wl.buffer_layout(trace, 1 << 21))


@pytest.fixture
def profile_json(monkeypatch, tmp_path):
    """A granite decode_32k profile of the reference (fixed measurements),
    saved as JSON."""
    path = tmp_path / "granite.json"
    reference_profile(monkeypatch, "granite-moe-1b-a400m", "decode_32k", 16,
                      cache_path=path)
    return path


def test_profile_replay_matches_reference(profile_json):
    """Windows applied at derive time, at replay time, or both (the
    re-application is idempotent), and a replay without the ideal twin."""
    jprof = jwl.ComputeProfile.load(profile_json)
    prof = wl.ComputeProfile.load(profile_json)
    jtrace = jwl.derive_workload("granite-moe-1b-a400m", "decode_32k",
                                 n_gpus=16, n_steps=2)
    trace = wl.derive_workload("granite-moe-1b-a400m", "decode_32k",
                               n_gpus=16, n_steps=2)
    jwith = jwl.derive_workload("granite-moe-1b-a400m", "decode_32k",
                                n_gpus=16, n_steps=2, compute_profile=jprof)
    with_ = wl.derive_workload("granite-moe-1b-a400m", "decode_32k",
                               n_gpus=16, n_steps=2, compute_profile=prof)
    for kw in (dict(compute_profile=True), dict(include_ideal=False)):
        jkw = {k: jprof if v is True else v for k, v in kw.items()}
        pkw = {k: prof if v is True else v for k, v in kw.items()}
        assert_same(jwl.replay(jtrace, **jkw), wl.replay(trace, **pkw))
        assert_same(jwl.replay(jwith, **jkw), wl.replay(with_, **pkw))
    jcfg = JSimConfig(fabric=jwl.pod_fabric(jwl.PodSpec(n_gpus=8)))
    with pytest.raises(ValueError) as jerr:
        jwl.replay(jtrace, cfg=jcfg)
    with pytest.raises(ValueError, match="cfg pod size 8") as err:
        wl.replay(trace, cfg=to_port(jcfg))
    assert str(err.value) == str(jerr.value)
