"""The port's runtime against ``repro.runtime``, on the CPU: failure
injection and resume in the port's Trainer (the reference's
``TestFailureRecovery``), a run crashed in one package and resumed in the
other, the elastic controller's decisions, and the two torch examples.

The cross-package runs use the granite smoke model.  bf16 runs use the
Trainer's default ``with_master(adamw)``; f32 runs give both packages
plain ``adamw``, because the reference Trainer cannot run f32 with
``with_master``: its master is the params' own buffer, and the jitted step
donates both (ROADMAP §3).  Losses agree within ``LOSS_RTOL`` (f32) and
``BF16_LOSS_RTOL`` (bf16), the bounds of ``test_torch_train.py``.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.models.base import set_logical_rules  # noqa: E402
from repro.runtime import ElasticController as JElasticController  # noqa: E402
from repro.runtime import Trainer as JTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import configs, optim  # noqa: E402
from repro_torch.models.spec import ModelConfig  # noqa: E402
from repro_torch.runtime import ElasticController, Trainer  # noqa: E402
from repro_torch.runtime import TrainerConfig  # noqa: E402
from repro_torch.weights import flatten, from_jax_params  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5
BF16_LOSS_RTOL = 2 ** -6


@pytest.fixture(autouse=True)
def _no_logical_rules():
    # xdist workers share a process across test files (base.py's rules
    # are global)
    set_logical_rules(None)
    yield
    set_logical_rules(None)


def tiny_cfg():
    return configs.get_smoke_config("qwen2-1.5b").replace(
        n_layers=2, remat=False)


# ------------------------------------------------ failure injection / restart
class TestFailureRecovery:
    def test_crash_and_restart_continue_identically(self, tmp_path):
        cfg = tiny_cfg()
        tcfg = TrainerConfig(steps=12, batch_size=4, seq_len=32,
                             checkpoint_dir=str(tmp_path / "ckpt"),
                             checkpoint_every=5, async_checkpoint=False,
                             log_every=1)
        # uninterrupted run
        ref = Trainer(cfg, tcfg, device="cpu").run(resume=False)
        # crashed run + restart
        tcfg2 = dataclasses.replace(tcfg,
                                    checkpoint_dir=str(tmp_path / "ckpt2"))
        with pytest.raises(RuntimeError, match="injected failure"):
            Trainer(cfg, tcfg2, device="cpu").run(resume=False,
                                                  fail_at_step=10)
        out = Trainer(cfg, tcfg2, device="cpu").run(resume=True)
        assert out["data_step"] == ref["data_step"]
        assert out["final_loss"] == pytest.approx(ref["final_loss"],
                                                  rel=1e-4)
        assert [h["step"] for h in out["history"]] == [10, 11]
        # on one device the resumed run is the same computation: the same
        # bits
        for key in ("params", "opt"):
            want = flatten(ref["state"][key])
            for path, got in flatten(out["state"][key]).items():
                assert torch.equal(got, want[path]), path
        assert all(t.requires_grad and t.is_leaf
                   for t in flatten(out["state"]["params"]).values())

    def test_resume_skips_completed_steps(self, tmp_path):
        cfg = tiny_cfg()
        tcfg = TrainerConfig(steps=6, batch_size=4, seq_len=32,
                             checkpoint_dir=str(tmp_path / "c"),
                             checkpoint_every=3, async_checkpoint=False,
                             log_every=1)
        Trainer(cfg, tcfg, device="cpu").run(resume=False)
        out = Trainer(cfg, tcfg, device="cpu").run(resume=True)
        # resumed at step 6 == steps -> no extra work, history empty
        assert out["history"] == []
        assert out["data_step"] == 6


# ------------------------------------------- across the two packages
def _setup(dtype, ckpt_dir, steps=4, every=2):
    jcfg = jconfigs.get_smoke_config("granite-moe-1b-a400m").replace(
        dtype=dtype)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    # the Trainers' default learning rate and warm-up (1e-3, 10 steps)
    kw = dict(steps=steps, batch_size=2, seq_len=16, seed=4, log_every=1,
              checkpoint_every=every, checkpoint_dir=ckpt_dir)
    if dtype == "float32":
        jopt = joptim.adamw(joptim.cosine_with_warmup(1e-3, 10, steps))
        opt = optim.adamw(optim.cosine_with_warmup(1e-3, 10, steps))
    else:
        jopt = opt = None       # the Trainers' with_master(adamw)
    return (JTrainer(jcfg, JTrainerConfig(**kw), optimizer=jopt),
            Trainer(cfg, TrainerConfig(**kw), optimizer=opt, device="cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("crashed_in", ["jax", "port"])
def test_resume_across_packages(tmp_path, dtype, crashed_in):
    """A run crashes at step 2 (checkpoint every 2 steps) in one package;
    the other resumes from its directory and ends where an uninterrupted
    JAX run ends: the same data step, the losses of steps 2 and 3 within
    the dtype's tolerance.  The port starts from the JAX init (carried with
    ``from_jax_params``), so both crashed runs start from the same
    weights."""
    jref, _ = _setup(dtype, None)
    want = {h["step"]: h["loss"] for h in jref.run(resume=False)["history"]}
    d = str(tmp_path / "ckpt")
    jt, tt = _setup(dtype, d)
    init = jax.tree.map(np.asarray, jt.init_state()["params"])
    with pytest.raises(RuntimeError, match="injected failure at step 2"):
        if crashed_in == "jax":
            jt.run(resume=False, fail_at_step=2)
        else:
            tt.run(resume=False, fail_at_step=2,
                   params=from_jax_params(init, keep_bf16=True))
    jt, tt = _setup(dtype, d)
    out = tt.run(resume=True) if crashed_in == "jax" else jt.run(resume=True)
    got = {h["step"]: h["loss"] for h in out["history"]}
    assert sorted(got) == [2, 3] and out["data_step"] == 4
    # the step count came across too (it sets the learning rate)
    count = [v for p, v in flatten(out["state"]["opt"]).items()
             if p.endswith("count")]
    assert len(count) == 1 and int(count[0]) == 4
    rtol = LOSS_RTOL if dtype == "float32" else BF16_LOSS_RTOL
    np.testing.assert_allclose([got[2], got[3]], [want[2], want[3]],
                               rtol=rtol)


# ------------------------------------------------------------------ elastic
def _drive(cls, scenario):
    """A scripted run of heartbeats, clocks and polls; returns each poll's
    decision as a tuple, or the error it raised."""
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    out = []

    def poll(ctl):
        try:
            d = ctl.poll()
            out.append((d.kind, d.dead_hosts, d.stragglers,
                        d.new_num_shards))
        except RuntimeError as e:
            out.append(("raised", str(e)))

    if scenario == "dead_host":
        ctl = cls(8, heartbeat_timeout_s=12, clock=clock)
        for i in range(8):
            ctl.heartbeat(i)
        t[0] = 5.0
        for i in range(7):
            ctl.heartbeat(i)                  # host 7 silent
        t[0] = 16.0
        poll(ctl)
        poll(ctl)                             # already marked dead: ok
        t[0] = 40.0
        for i in (0, 1, 2):
            ctl.heartbeat(i)                  # 3 to 6 silent now
        poll(ctl)
    elif scenario == "straggler":
        ctl = cls(4, clock=clock)
        for i in range(4):
            for _ in range(8):
                ctl.heartbeat(i, step_seconds=1.0 if i != 2 else 5.0)
        poll(ctl)
        for _ in range(40):                   # its window forgets
            ctl.heartbeat(2, step_seconds=1.0)
        poll(ctl)
    elif scenario == "all_healthy":
        ctl = cls(4, clock=clock)
        for i in range(4):
            ctl.heartbeat(i, step_seconds=1.0 + 0.1 * i)
        poll(ctl)
        ctl3 = cls(3, clock=clock)            # too few hosts to judge
        for i in range(3):
            ctl3.heartbeat(i, step_seconds=1.0 if i else 9.0)
        poll(ctl3)
    elif scenario == "below_min_hosts":
        ctl = cls(4, heartbeat_timeout_s=10, min_hosts=3, clock=clock)
        t[0] = 11.0
        ctl.heartbeat(0)
        ctl.heartbeat(1)
        t[0] = 15.0
        poll(ctl)
    return out


@pytest.mark.parametrize("scenario", ["dead_host", "straggler",
                                      "all_healthy", "below_min_hosts"])
def test_elastic_controller_matches_reference(scenario):
    """The port's copy of the controller makes the reference's decisions
    on the same scripted heartbeats and clocks."""
    ours, theirs = (_drive(ElasticController, scenario),
                    _drive(JElasticController, scenario))
    assert ours == theirs
    assert ours            # each scenario polls


# ------------------------------------------------------------ the examples
def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_lm_torch_example_cpu(tmp_path, capsys):
    """``examples/train_lm_torch.py --device cpu`` trains lm-100m for 2
    steps and prints a finite loss for each."""
    _example("train_lm_torch").main([
        "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
        "--ckpt", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    losses = [float(ln.split("loss")[1].split()[0])
              for ln in out.splitlines() if ln.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "final loss" in out


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-780m"])
def test_serve_decode_torch_example_cpu(capsys, arch):
    """``examples/serve_decode_torch.py --device cpu`` prefills and decodes
    2 tokens for a batch of 2 prompts of 16."""
    _example("serve_decode_torch").main([
        "--device", "cpu", "--arch", arch, "--tokens", "2", "--batch", "2",
        "--prompt-len", "16"])
    out = capsys.readouterr().out
    assert "prefill[2x16]" in out and "decoded 2 tokens/seq" in out
    ids = out.split("token ids:")[1].split("...")[0]
    assert len(ids.strip(" []\n").split(",")) == 2
