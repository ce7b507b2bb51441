"""On the card: one short run of each cell through the command the
manifest names.  Skips without a CUDA device."""
import json
import subprocess
import sys

import pytest

from portbench.tests.helpers import CELLS, ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_cell_runs_on_the_card_and_is_correct(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels on the H100)")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cmd = [sys.executable if c == "python3" else c for c in bench["command"]]
    r = subprocess.run(cmd + ["--workload", cell, "--seed", str(2 ** 31 + 99),
                              "--seconds", "2", "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
