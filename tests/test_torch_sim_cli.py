"""The port's command lines against the reference's, on the CPU.

``python -m repro_torch.workloads`` (derive and replay, roofline windows
or a saved ``--profile``) prints the lines of ``python -m
repro.workloads`` with the same arguments, and ``python -m
repro_torch.core.select`` those of ``python -m repro.core.select`` (and
the same table file).  Nothing here imports torch.
"""
import importlib

import pytest

from test_torch_sim_replay import profile_json  # noqa: F401 (fixture)

jcli = importlib.import_module("repro.workloads.__main__")
cli = importlib.import_module("repro_torch.workloads.__main__")
jselect = importlib.import_module("repro.core.select")
select = importlib.import_module("repro_torch.core.select")


CLI_ARGS = [
    ["--arch", "granite-moe-1b-a400m", "--steps", "4"],
    ["--arch", "qwen3-1.7b", "--steps", "2", "--engine", "vectorized",
     "--retention-ns", "50000"],
    ["--arch", "granite-moe-1b-a400m", "--steps", "2", "--policy", "auto",
     "--disagg", "4096"],
    ["--arch", "mamba2-780m", "--shape", "train_4k", "--steps", "1",
     "--topology", "two_tier", "--leaf", "8", "--oversub", "2"],
    ["--arch", "jamba-1.5-large-398b", "--shape", "prefill_32k", "--gpus",
     "8", "--steps", "1", "--topology", "multi_pod", "--pod-size", "4"],
]


@pytest.mark.parametrize("argv", CLI_ARGS, ids=["granite", "retention",
                                                "policy_disagg", "two_tier",
                                                "multi_pod"])
def test_cli_prints_the_reference_s_lines(argv, capsys):
    assert jcli.main(argv) == 0
    theirs = capsys.readouterr().out
    assert cli.main(argv) == 0
    assert capsys.readouterr().out == theirs
    assert "# cold (step 0) degradation:" in theirs


def test_cli_replays_a_saved_profile_as_the_reference(profile_json, capsys):
    argv = ["--arch", "granite-moe-1b-a400m", "--steps", "3", "--profile",
            str(profile_json)]
    assert jcli.main(argv) == 0
    theirs = capsys.readouterr().out
    assert cli.main(argv) == 0
    assert capsys.readouterr().out == theirs


def test_select_cli_prints_the_reference_s_lines(tmp_path, capsys):
    argv = ["--sizes-mb", "0.25,2", "--gpus", "8", "--logicals",
            "allreduce,all_gather", "--page-kb", "4"]
    assert jselect.main(argv + ["--out", str(tmp_path / "j.json")]) == 0
    theirs = capsys.readouterr().out.replace(str(tmp_path / "j.json"), "T")
    assert select.main(argv + ["--out", str(tmp_path / "t.json")]) == 0
    ours = capsys.readouterr().out.replace(str(tmp_path / "t.json"), "T")
    assert ours == theirs
    assert "# wrote T: 8 entries" in ours
    assert (tmp_path / "t.json").read_bytes() \
        == (tmp_path / "j.json").read_bytes()
