"""The port's calibration harness (``repro_torch.workloads``) against
``repro.workloads``, on the CPU.

The pod sizing and roofline formulas must equal the reference's exactly,
and raise where it raises.  With the measurements replaced by the same
fixed numbers in both modules, the profile JSON must be the reference's
byte for byte.  A real CPU run (the kernels' plain versions) must write a
JSON that the jax-free reference loads, derives and replays.  On the card
the same harness times the CUDA kernels; ``chip_smoke.py`` phase (e) runs
it there.
"""
import dataclasses
import importlib
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro import configs as jconfigs  # noqa: E402
from repro.workloads import derive_workload, replay  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.workloads import __main__ as cli  # noqa: E402
from test_calibrate import TinyHybrid, TinyMoE  # noqa: E402

# The packages export a function ``calibrate`` beside the module of that
# name, so the modules are reached through importlib.
jcal = importlib.import_module("repro.workloads.calibrate")
jderive = importlib.import_module("repro.workloads.derive")
tcal = importlib.import_module("repro_torch.workloads.calibrate")
tderive = importlib.import_module("repro_torch.workloads.derive")

# Pods about every branch of resolve_pod and of the tier-0 block: the
# defaults, a leaf of 8, a leaf past the pod (capped), a leaf that does not
# divide it, multi_pod with and without a pod size, user ep/tp/dp, an
# unknown topology, and pods of 6 and 1 GPUs.
PODS = [
    dict(),
    dict(topology="two_tier"),
    dict(topology="two_tier", leaf_size=8, oversubscription=2.0),
    dict(topology="two_tier", leaf_size=32),
    dict(topology="two_tier", leaf_size=5),
    dict(topology="multi_pod"),
    dict(topology="multi_pod", pod_size=4),
    dict(topology="multi_pod", pod_size=3),
    dict(ep=4),
    dict(ep=3),
    dict(ep=32),
    dict(tp=4, dp=4),
    dict(tp=4),
    dict(tp=4, dp=2),
    dict(topology="torus"),
    dict(n_gpus=6, topology="two_tier"),
    dict(n_gpus=6),
    dict(n_gpus=1, topology="multi_pod"),
]


def _archs():
    """(reference config, port config) for every ported architecture and
    the reference tests' duck-typed stand-ins."""
    pairs = [(jconfigs.get_config(a), configs.get_config(a))
             for a in configs.list_archs()]
    return pairs + [(TinyMoE(), TinyMoE()), (TinyHybrid(), TinyHybrid())]


def _outcome(fn):
    try:
        return "ok", fn()
    except ValueError as err:
        return type(err).__name__, str(err)


# --------------------------------------------------- derive: exact parity
@pytest.mark.parametrize("pod_kw", PODS, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
def test_pod_and_rooflines_match_reference(pod_kw):
    """resolve_pod, step_shape and every layer's roofline windows equal
    the reference's for every ported architecture and shape; where the
    reference raises, the port raises the same error."""
    n_checked = 0
    for jcfg, tcfg in _archs():
        for name, jspec in jconfigs.SHAPES.items():
            tspec = configs.SHAPES[name]
            jpod = _outcome(lambda: jderive.resolve_pod(
                jderive.PodSpec(**pod_kw), jcfg, jspec.kind))
            tpod = _outcome(lambda: tderive.resolve_pod(
                tderive.PodSpec(**pod_kw), tcfg, tspec.kind))
            assert jpod[0] == tpod[0], (jcfg.name, name, jpod, tpod)
            if jpod[0] != "ok":
                assert jpod[1] == tpod[1]
                continue
            jp, tp = jpod[1], tpod[1]
            assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
            shape = jderive.step_shape(jspec, jp)
            assert shape == tderive.step_shape(tspec, tp)
            for i in range(jcfg.n_layers):
                assert jderive.layer_roofline_ns(jcfg, i, shape[0], jp,
                                                 shape[2]) \
                    == tderive.layer_roofline_ns(tcfg, i, shape[0], tp,
                                                 shape[2])
            n_checked += 1
    if pod_kw in (dict(), dict(topology="two_tier")):
        assert n_checked == len(_archs()) * len(jconfigs.SHAPES)


def test_shape_rule_and_pod_fields_are_copies():
    for spec in jconfigs.SHAPES.values():
        for a in configs.list_archs():
            assert configs.shape_applicable(configs.get_config(a), spec) \
                == jconfigs.shape_applicable(jconfigs.get_config(a), spec)
    assert [(f.name, f.default) for f in dataclasses.fields(tderive.PodSpec)] \
        == [(f.name, f.default) for f in dataclasses.fields(jderive.PodSpec)]
    assert tderive.tier0_group(tderive.PodSpec(topology="two_tier")) == 4


def test_harness_shapes_are_built_on_the_card(fixed_measurers):
    """Every registry entry that the harness accepts meets the CUDA
    kernels' build rules at its measured shapes: flash_attention is built
    for head dims 64, 96 and 128, and the bf16 grouped_matmul needs D and F
    divisible by 8.  whisper-medium and phi-3-vision-4.2b are accepted or
    refused exactly as ``repro.workloads.calibrate`` accepts or refuses
    them (the same fixed measurements in both: the same JSON), and
    phi-3-vision's attention slice (Dh 96) is measured on the CPU."""
    assert ops.ATTN_HEAD_DIMS == (64, 96, 128)
    for a in configs.list_archs():
        cfg = configs.get_config(a)
        spec = configs.SHAPES["decode_32k"]
        pod = tderive.resolve_pod(tderive.PodSpec(), cfg, spec.kind)
        phases, _ = tcal._phase_rooflines(cfg, spec, pod)
        if "attn_mixer" in phases:
            assert tcal.slice_shape(cfg, "attn_mixer")[-1] in \
                ops.ATTN_HEAD_DIMS, a
        for phase in {"moe_ffn", "dense_ffn"} & set(phases):
            _, D, F, _ = tcal.slice_shape(cfg, phase)
            ops.check_gmm_bf16_shape(D, F)
    for arch in ("whisper-medium", "phi-3-vision-4.2b"):
        theirs = _outcome(lambda: jcal.calibrate(
            arch, "decode_32k", n_gpus=16).to_json())
        ours = _outcome(lambda: tcal.calibrate(
            arch, "decode_32k", n_gpus=16, device="cpu").to_json())
        assert ours == theirs, arch
    cfg = configs.get_config("phi-3-vision-4.2b")
    assert tcal.slice_shape(cfg, "attn_mixer")[-1] == 96
    wall, flops, kernels = tcal._measure_attn_mixer(cfg, 1,
                                                    torch.device("cpu"))
    assert wall > 0 and flops > 0
    assert kernels == ("rmsnorm", "flash_attention")


# ------------------------------------------- calibrate: identical JSON
FIXED = {
    "attn_mixer": (1.5e6, 3.3e7, ("rmsnorm", "flash_attention")),
    "ssm_mixer": (2.5e6, 1.1e7, ("ssd_scan",)),
    "moe_ffn": (7.0e5, 1.6e7, ("grouped_matmul",)),
    "dense_ffn": (9.0e5, 3.2e7, ("grouped_matmul",)),
}


@pytest.fixture
def fixed_measurers(monkeypatch):
    """The same fixed (wall, flops, kernels) in both modules; returns the
    port's call log."""
    calls = []

    def port(phase):
        def measure(cfg, reps, device):
            calls.append(phase)
            return FIXED[phase]
        return measure

    monkeypatch.setattr(jcal, "_MEASURERS", {
        p: (lambda cfg, reps, _p=p: FIXED[_p]) for p in FIXED})
    monkeypatch.setattr(tcal, "_MEASURERS", {p: port(p) for p in FIXED})
    return calls


@pytest.mark.parametrize("arch", ["tiny-moe", "tiny-hybrid",
                                  "granite-moe-1b-a400m",
                                  "qwen3-moe-235b-a22b"])
def test_profile_json_is_the_reference_s(arch, fixed_measurers):
    stand_in = {"tiny-moe": TinyMoE, "tiny-hybrid": TinyHybrid}.get(arch)
    for shape, pod in (("decode_32k", {}), ("train_4k", dict(
            topology="two_tier", leaf_size=8)), ("prefill_32k", {})):
        jarch = stand_in() if stand_in else arch
        tarch = stand_in() if stand_in else arch
        jprof = jcal.calibrate(jarch, shape, n_gpus=16,
                               pod=jderive.PodSpec(**pod))
        tprof = tcal.calibrate(tarch, shape, n_gpus=16,
                               pod=tderive.PodSpec(**pod), device="cpu")
        assert tprof.to_json() == jprof.to_json()
        assert jcal.ComputeProfile.from_json(tprof.to_json()) == jprof
    assert fixed_measurers                     # the port's measurers ran


def test_cache_hit_is_returned_unmeasured(fixed_measurers, tmp_path):
    path = tmp_path / "p.json"
    first = tcal.calibrate(TinyMoE(), "decode_32k", n_gpus=8,
                           cache_path=path, device="cpu")
    n = len(fixed_measurers)
    again = tcal.calibrate(TinyMoE(), "decode_32k", n_gpus=8,
                           cache_path=path, device="cpu")
    assert again == first and len(fixed_measurers) == n
    # another pod size does not match the cache: measured again
    other = tcal.calibrate(TinyMoE(), "decode_32k", n_gpus=16,
                           cache_path=path, device="cpu")
    assert other.n_gpus == 16 and len(fixed_measurers) > n
    # force measures even on a hit
    n = len(fixed_measurers)
    tcal.calibrate(TinyMoE(), "decode_32k", n_gpus=16, cache_path=path,
                   force=True, device="cpu")
    assert len(fixed_measurers) > n


@pytest.mark.parametrize("stale", ["version", "corrupt"])
def test_stale_or_corrupt_cache_is_measured_again(stale, fixed_measurers,
                                                  tmp_path):
    path = tmp_path / "p.json"
    prof = tcal.calibrate(TinyMoE(), "decode_32k", n_gpus=8,
                          cache_path=path, device="cpu")
    text = prof.to_json()
    path.write_text(text.replace(f'"version": {prof.version}',
                                 '"version": 1')
                    if stale == "version" else text[:40])
    n = len(fixed_measurers)
    again = tcal.calibrate(TinyMoE(), "decode_32k", n_gpus=8,
                           cache_path=path, device="cpu")
    assert len(fixed_measurers) > n
    assert again == prof
    assert path.read_text() == text            # rewritten in place


# --------------------------------------------- a real CPU measurement
def test_cpu_profile_replays_in_the_reference(tmp_path):
    """The plain versions, timed on the CPU: the JSON loads in the
    reference, matches its pod, and derive_workload + replay run on it."""
    path = tmp_path / "tiny.json"
    ops.reset_launches()
    prof = tcal.calibrate(TinyMoE(), "decode_32k", n_gpus=8, reps=1,
                          cache_path=path, device="cpu")
    assert not any(ops.LAUNCHES.values())      # no kernel on the CPU
    assert prof.interpret                      # not hardware kernel times
    assert set(prof.phases) == {"attn_mixer", "moe_ffn"}
    assert all(w.measured_wall_ns > 0 and w.calibrated_ns > 0
               for w in prof.phases.values())
    roof = sum(w.layers * w.roofline_ns for w in prof.phases.values())
    calib = sum(w.layers * w.calibrated_ns for w in prof.phases.values())
    assert math.isclose(calib, roof, rel_tol=1e-9)

    jprof = jcal.ComputeProfile.load(path)
    assert jprof.to_json() == path.read_text() == prof.to_json()
    assert jprof.matches("tiny-moe", "decode_32k", 8, prof.ep, prof.tp,
                         prof.dp)
    trace = derive_workload(TinyMoE(), "decode_32k", n_gpus=8, n_steps=2,
                            compute_profile=jprof)
    rep = replay(trace, compute_profile=jprof)
    assert rep.cold_degradation > rep.steady_degradation
    assert rep.steps[0].compute_ns > 0


def test_cpu_measurers_match_the_reference_s():
    """Each measurer on the CPU, at the jamba smoke config (all four
    phases): the reference's flops and kernel names, a positive time."""
    jcfg = jconfigs.get_smoke_config("jamba-1.5-large-398b")
    cfg = configs.get_smoke_config("jamba-1.5-large-398b")
    for phase, measure in tcal._MEASURERS.items():
        wall, flops, kernels = measure(cfg, 1, torch.device("cpu"))
        _, jflops, jkernels = jcal._MEASURERS[phase](jcfg, 1)
        assert (flops, kernels) == (jflops, jkernels), phase
        assert wall > 0


@pytest.mark.cuda
def test_cuda_window_is_device_time():
    """On the card a window holds the kernels, not the host's dispatch: 2 ms
    on the host ahead of an empty launch stays out of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import time
    dev = torch.device("cuda")
    empty = tcal._time_call(lambda: torch.cuda._sleep(0), 5, dev)
    host = tcal._time_call(lambda: (time.sleep(2e-3), torch.cuda._sleep(0)),
                           5, dev)
    assert 0 < empty < 1e5 and 0 < host < 2e5


# ------------------------------------------------------------------ CLI
def test_cli_cpu_writes_a_profile_the_reference_replays(fixed_measurers,
                                                        tmp_path, capsys):
    path = tmp_path / "g.json"
    rc = cli.main(["--arch", "granite-moe-1b-a400m", "--device", "cpu",
                   "--reps", "1", "--profile", str(path), "--topology",
                   "two_tier", "--leaf", "8"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert "attn_mixer" in out[1] and "measured" in out[1]
    assert out[-1].startswith("python -m repro.workloads ")
    prof = jcal.ComputeProfile.load(path)
    assert (prof.n_gpus, prof.tp) == (16, 8)
    # the printed command replays the profile through the reference
    from repro.workloads import __main__ as jcli
    argv = out[-1].split()[3:] + ["--steps", "2"]
    assert jcli.main(argv) == 0
    assert "cold (step 0) degradation" in capsys.readouterr().out


def test_harness_refuses_without_gpu(tmp_path):
    """No CUDA here: calibrate() and the CLI raise instead of measuring on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcal.calibrate("granite-moe-1b-a400m", "decode_32k")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--arch", "granite-moe-1b-a400m", "--profile",
                  str(tmp_path / "p.json")])
    assert not (tmp_path / "p.json").exists()
