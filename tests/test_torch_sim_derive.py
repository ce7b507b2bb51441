"""The port's workload derivation (``repro_torch.workloads.derive``)
against ``repro.workloads.derive``, on the CPU.

Every registry architecture (each package's own registry entry) and the
reference tests' duck-typed stand-ins, at ``decode_32k``, ``prefill_32k``
and ``train_4k`` on the three topologies, under the ``fixed`` and ``auto``
policies: the same ``WorkloadTrace`` call by call, or the same error.
Windows from a compute profile (the same JSON read by each package), the
disaggregation KV handoff and the ``StepEmitter``'s cold/warm resolution
match as well.  Nothing here imports torch.
"""
import dataclasses
import importlib

import pytest

from repro import configs as jconfigs
from repro_torch import configs
from test_calibrate import TinyHybrid, TinyMoE
from torch_sim_helpers import assert_same, reference_profile, to_port

jderive = importlib.import_module("repro.workloads.derive")
jcal = importlib.import_module("repro.workloads.calibrate")
tderive = importlib.import_module("repro_torch.workloads.derive")
tcal = importlib.import_module("repro_torch.workloads.calibrate")

SHAPES = ("decode_32k", "prefill_32k", "train_4k")
TOPOLOGIES = ("single_clos", "two_tier", "multi_pod")
ARCHS = configs.list_archs() + ["tiny-moe", "tiny-hybrid"]
STAND_INS = {"tiny-moe": TinyMoE, "tiny-hybrid": TinyHybrid}


def _arch(name):
    return STAND_INS[name]() if name in STAND_INS else name


def _derive(mod, arch, shape, **kw):
    try:
        return "ok", mod.derive_workload(_arch(arch), shape, **kw)
    except ValueError as err:
        return "ValueError", str(err)


def test_registries_match():
    assert configs.list_archs() == jconfigs.list_archs()
    for a in configs.list_archs():
        assert dataclasses.asdict(configs.get_config(a)) \
            == dataclasses.asdict(jconfigs.get_config(a))


@pytest.mark.parametrize("policy", ["fixed", "auto"])
@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("shape", SHAPES)
def test_derive_workload_matches_reference(shape, topology, policy):
    n_ok = 0
    for arch in ARCHS:
        kw = dict(n_gpus=16, n_steps=2, policy=policy)
        theirs = _derive(jderive, arch, shape,
                         pod=jderive.PodSpec(topology=topology), **kw)
        ours = _derive(tderive, arch, shape,
                       pod=tderive.PodSpec(topology=topology), **kw)
        assert ours[0] == theirs[0], (arch, theirs, ours)
        if theirs[0] != "ok":
            assert ours[1] == theirs[1]
            continue
        assert_same(theirs[1], ours[1], f"{arch}.trace")
        assert ours[1].n_steps == theirs[1].n_steps == 2
        assert ours[1].total_bytes() == theirs[1].total_bytes()
        n_ok += 1
    assert n_ok == len(ARCHS)


POD_VARIANTS = [
    dict(buffer_reuse="pooled"),
    dict(topology="two_tier", leaf_size=8, oversubscription=2.0),
    dict(topology="multi_pod", pod_size=4),
    dict(ep=4, tp=4, dp=4),
    dict(tp=2),
    dict(ep=3),
]


@pytest.mark.parametrize("pod_kw", POD_VARIANTS, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()))
def test_derive_pod_variants_match_reference(pod_kw):
    for arch in ("granite-moe-1b-a400m", "jamba-1.5-large-398b",
                 "tiny-hybrid"):
        for shape in SHAPES:
            theirs = _derive(jderive, arch, shape, n_gpus=16,
                             pod=jderive.PodSpec(**pod_kw), n_steps=1)
            ours = _derive(tderive, arch, shape, n_gpus=16,
                           pod=tderive.PodSpec(**pod_kw), n_steps=1)
            assert ours[0] == theirs[0]
            if theirs[0] == "ok":
                assert_same(theirs[1], ours[1])
            else:
                assert ours[1] == theirs[1]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "jamba-1.5-large-398b", "tiny-hybrid"],
                         ids=["granite", "jamba", "tiny-hybrid"])
def test_profile_windows_match_reference(arch, monkeypatch):
    """The reference's profile (fixed measurements) crosses as JSON; both
    packages derive the same windows from it, and refuse a profile of
    another pod with the same message."""
    jprof = reference_profile(monkeypatch, _arch(arch), "train_4k", 16)
    prof = tcal.ComputeProfile.from_json(jprof.to_json())
    assert prof.to_json() == jprof.to_json()
    theirs = jderive.derive_workload(_arch(arch), "train_4k",
                                     n_gpus=16, n_steps=2,
                                     compute_profile=jprof)
    ours = tderive.derive_workload(_arch(arch), "train_4k",
                                   n_gpus=16, n_steps=2,
                                   compute_profile=prof)
    assert_same(theirs, ours)
    with pytest.raises(ValueError) as jerr:
        jderive.derive_workload(_arch(arch), "train_4k", n_gpus=8,
                                compute_profile=jprof)
    with pytest.raises(ValueError) as err:
        tderive.derive_workload(_arch(arch), "train_4k", n_gpus=8,
                                compute_profile=prof)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("policy", ["fixed", "auto"])
@pytest.mark.parametrize("prompt", [1, 4096, 32768])
def test_kv_transfer_matches_reference(prompt, policy):
    for arch in ("granite-moe-1b-a400m", "jamba-1.5-large-398b",
                 "qwen3-1.7b"):
        for n in (4, 16):
            jpod, pod = jderive.PodSpec(n_gpus=n), tderive.PodSpec(n_gpus=n)
            jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
            assert_same(jderive.kv_transfer_fabric(jpod),
                        tderive.kv_transfer_fabric(pod))
            assert tderive.kv_shard_bytes(cfg, prompt, pod) \
                == jderive.kv_shard_bytes(jcfg, prompt, jpod)
            for state in ("cold", "warm"):
                assert_same(
                    jderive.derive_kv_transfer(jcfg, prompt, jpod,
                                               policy=policy, state=state),
                    tderive.derive_kv_transfer(cfg, prompt, pod,
                                               policy=policy, state=state))


def test_step_emitter_matches_reference():
    """Live batch sizes step by step, a flush between (``mark_cold``),
    ``auto`` resolution keyed on each buffer's warmth."""
    jcfg = jconfigs.get_config("granite-moe-1b-a400m")
    cfg = configs.get_config("granite-moe-1b-a400m")
    jpod = jderive.resolve_pod(jderive.PodSpec(), jcfg, "decode")
    pod = tderive.resolve_pod(tderive.PodSpec(), cfg, "decode")
    assert_same(jpod, pod)
    ems = (jderive.StepEmitter(jcfg, jpod, policy="auto"),
           tderive.StepEmitter(cfg, pod, policy="auto"))
    for em in ems:
        for step, t in enumerate((8, 64, 520, 4096)):
            em.step(step, t, prefix=f"b{step}")
            if step == 1:
                em.mark_cold()
        em.carry("attn_mixer", 12.5)
        em.emit("tail", "allreduce", 1 << 20, 16, 0.0, "tail", 4)
    assert_same(ems[0].calls, ems[1].calls)
    for i in range(cfg.n_layers):
        assert tderive.layer_param_bytes(cfg, i, 2) \
            == jderive.layer_param_bytes(jcfg, i, 2)
        assert (tderive.mixer_phase(cfg, i), tderive.ffn_phase(cfg, i)) \
            == (jcal.mixer_phase(jcfg, i), jcal.ffn_phase(jcfg, i))
    assert tcal.mixer_phase is tderive.mixer_phase


def test_pod_fabric_is_the_port_s_topology():
    for kw in (dict(), dict(topology="two_tier", leaf_size=8),
               dict(topology="multi_pod", pod_size=4)):
        jfab = jderive.pod_fabric(jderive.PodSpec(**kw))
        assert_same(jfab, tderive.pod_fabric(tderive.PodSpec(**kw)))
        assert to_port(jfab) == tderive.pod_fabric(tderive.PodSpec(**kw))
