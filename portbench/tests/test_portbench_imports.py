"""What a run loads: the program, and nothing of JAX or the JAX package;
the references load nothing of the program."""
import json
import subprocess
import sys

from portbench.tests.helpers import ROOT

RUN_BOTH = """
import json, sys
from portbench.tests.helpers import run_small
for cell in ("granite-moe-1b-a400m.prefill", "mamba2-780m.prefill"):
    run_small(cell, traced=True)
tops = sorted({m.split(".", 1)[0] for m in sys.modules})
print(json.dumps(tops))
"""

REFERENCES = """
import json, sys
import portbench.reference.moe_transformer, portbench.reference.mamba2
import portbench.reference.plain
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def _tops(code):
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600,
                       env={"PATH": "/usr/bin:/bin",
                            "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}"})
    assert r.returncode == 0, r.stderr[-3000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_a_run_loads_the_program_and_no_jax():
    tops = _tops(RUN_BOTH)
    assert "repro_torch" in tops and "portbench" in tops
    # whole top-level names: repro_torch starts with repro, and is not it
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_the_references_load_nothing_of_the_program():
    tops = _tops(REFERENCES)
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    from portbench import bench
    monkeypatch.setattr(sys, "modules", {"repro_torch": None,
                                         "repro_torch.models": None,
                                         "jaxtyping": None, "torch": None})
    assert bench.loaded_forbidden() == []
    monkeypatch.setattr(sys, "modules", {"repro.core": None, "jax": None})
    assert bench.loaded_forbidden() == ["jax", "repro"]
