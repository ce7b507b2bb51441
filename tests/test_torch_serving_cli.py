"""``python -m repro_torch.serving`` against ``python -m repro.serving``,
on the CPU.

For the same arguments the port's CLI prints the reference's stdout byte
for byte and returns its exit code: Poisson and bursty single-pod runs
(with a retention, the per-step trace, pre-translation, a policy), a
saved ``--profile``, a trace file, a fleet with the autoscaler,
disaggregation, and a run that serves nothing.  Argument errors exit as
the reference's do, with its message.  Nothing here imports torch.
"""
import importlib

import pytest

from test_torch_sim_replay import profile_json  # noqa: F401 (fixture)

jcli = importlib.import_module("repro.serving.__main__")
cli = importlib.import_module("repro_torch.serving.__main__")

SMALL = ["--requests", "4", "--steps-cap", "12", "--prompt-mean", "16",
         "--output-mean", "3"]
GRANITE = ["--arch", "granite-moe-1b-a400m"]
CLI_ARGS = {
    "poisson": GRANITE + ["--rps", "8"] + SMALL,
    "bursty_retention": GRANITE + ["--rps", "16", "--arrival", "bursty",
                                   "--burst-size", "2", "--retention-ns",
                                   "50000", "--engine", "vectorized"] + SMALL,
    "per_step": GRANITE + ["--arrival", "bursty", "--burst-size", "2",
                           "--retention-ns", "50000", "--per-step",
                           "--pretranslate", "--policy", "auto"] + SMALL,
    "fleet_autoscale": GRANITE + [
        "--rps", "20", "--arrival", "bursty", "--requests", "6",
        "--steps-cap", "20", "--prompt-mean", "16", "--output-mean", "2",
        "--fleet", "3", "--router", "least_loaded", "--autoscale",
        "--scale-up-queued", "1", "--scale-down-idle-ns", "1e6",
        "--spinup-latency-ns", "1e4", "--max-queue", "5"],
    "disagg": GRANITE + ["--rps", "8", "--disagg", "1:1", "--steps-cap",
                         "30", "--requests", "3", "--prompt-mean", "64",
                         "--output-mean", "2", "--kv-arena-mb", "4"],
    "qwen3_two_tier": ["--arch", "qwen3-1.7b", "--gpus", "8", "--topology",
                       "two_tier", "--leaf", "4", "--oversub", "2",
                       "--prefetch", "--l2-entries", "64"] + SMALL,
    "nothing_served": GRANITE + ["--steps-cap", "1", "--requests", "2",
                                 "--prompt-mean", "4000"],
}


def _both(argv, capsys):
    """The two CLIs' exit codes and stdout on ``argv``."""
    jrc = jcli.main(argv)
    theirs = capsys.readouterr().out
    rc = cli.main(argv)
    ours = capsys.readouterr().out
    return jrc, theirs, rc, ours


@pytest.mark.parametrize("name", sorted(CLI_ARGS))
def test_cli_prints_the_reference_s_stdout(name, capsys):
    jrc, theirs, rc, ours = _both(CLI_ARGS[name], capsys)
    assert (rc, ours) == (jrc, theirs)
    if name == "nothing_served":
        assert rc == 1
    else:
        assert rc == 0 and "metric,p50_us,p95_us,p99_us" in ours
    if name == "per_step":
        assert "step,t_start_us,decode_tok,prefill_tok" in ours
    if name == "fleet_autoscale":
        assert "# fleet: autoscale 1..3 replicas" in ours
    if name == "disagg":
        assert "# disagg: 1 prefill + 1 decode pods" in ours


def test_cli_with_a_profile(profile_json, capsys):  # noqa: F811
    argv = GRANITE + ["--profile", str(profile_json), "--arrival", "bursty",
                      "--retention-ns", "50000", "--per-step"] + SMALL
    jrc, theirs, rc, ours = _both(argv, capsys)
    assert (rc, ours) == (jrc, theirs) and rc == 0
    argv = GRANITE + ["--profile", str(profile_json), "--disagg", "1:2",
                      "--router", "affinity"] + SMALL
    jrc, theirs, rc, ours = _both(argv, capsys)
    assert (rc, ours) == (jrc, theirs) and rc == 0


def test_cli_with_a_trace_file(tmp_path, capsys):
    trace = tmp_path / "trace.csv"
    trace.write_text("# arrival_ns,prompt,output\n5e5,24,3\n0,16,2\n"
                     "0,40,4\n\n2e9,8,2\n")
    argv = GRANITE + ["--arrival", "trace", "--trace", str(trace),
                      "--requests", "3", "--retention-ns", "1e6",
                      "--per-step"]
    jrc, theirs, rc, ours = _both(argv, capsys)
    assert (rc, ours) == (jrc, theirs) and rc == 0
    assert "3 generated" in ours


@pytest.mark.parametrize("argv,message", [
    (GRANITE + ["--disagg", "1:1", "--fleet", "2"], "mutually exclusive"),
    (GRANITE + ["--disagg", "0:1"], "--disagg wants P:D"),
    (GRANITE + ["--disagg", "x"], "--disagg wants P:D"),
    (GRANITE + ["--router", "random"], "invalid choice"),
    (["--rps", "8"], "--arch"),
], ids=["disagg_and_fleet", "disagg_zero", "disagg_garbled", "router",
        "no_arch"])
def test_cli_argument_errors_are_the_reference_s(argv, message, capsys):
    with pytest.raises(SystemExit) as jexit:
        jcli.main(argv)
    theirs = capsys.readouterr().err
    with pytest.raises(SystemExit) as exit_:
        cli.main(argv)
    ours = capsys.readouterr().err
    assert exit_.value.code == jexit.value.code == 2
    assert message in ours
    # the usage lines wrap at the program's name, which differs
    assert ours.splitlines()[-1] == theirs.splitlines()[-1].replace(
        "python -m repro.serving", "python -m repro_torch.serving")
