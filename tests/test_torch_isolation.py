"""The port stands alone: no jax, nothing of ``repro``, no silent CPU.

``src/repro_torch``, ``chip_smoke.py`` and the torch examples
(``examples/*_torch.py``) must run on a machine where jax is absent and
the JAX package is not importable (nor ``ml_dtypes``: bf16 checkpoints
are read through torch), and their entry points must refuse (not quietly
fall back) when no GPU is present.  The simulator's host examples
(``HOST_EXAMPLES``) and the serving path run no kernel: they need no GPU
and load no torch.  The dry-run and the report
(``launch.dryrun``, ``launch.report``) compute nothing, so they need no
GPU: a cell must allocate no tensor off the meta device instead.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))
# the simulator's examples: host code in numpy, which print the lines of
# the reference example of the same name without the suffix
HOST_EXAMPLES = tuple(ROOT / "examples" / f"{name}_torch.py" for name in
                      ("quickstart", "workload_replay", "serving_traffic"))
# the examples that run on the card
CARD_EXAMPLES = [p for p in EXAMPLES if p not in HOST_EXAMPLES]
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES
BANNED = ("jax", "jaxlib", "repro", "ml_dtypes")


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [(ln, mod) for ln, mod in _imported_roots(path) if mod in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_every_module_loads_no_jax_or_repro():
    mods = list(_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {BANNED!r})\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_refuse_without_gpu():
    """No CUDA here: the default device raises instead of using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch import configs
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.models.api import CausalLM
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CausalLM.random(configs.get_smoke_config("granite-moe-1b-a400m"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "mamba2-780m", "--smoke"])
    assert resolve_device("cpu").type == "cpu"


def test_dryrun_allocates_only_on_meta():
    """A production cell of the dry-run runs with no GPU, under a counter
    that raises on any tensor off the meta device; importing the dry-run
    and the report sets no environment and starts no process group, and
    loads no jax."""
    code = (
        "import os, sys\n"
        "env = dict(os.environ)\n"
        "import torch.distributed as dist\n"
        "from repro_torch.launch import dryrun, report\n"
        "assert dict(os.environ) == env\n"
        "assert not dist.is_initialized()\n"
        "cell = dryrun.run_cell('granite-moe-1b-a400m', 'decode_32k',\n"
        "                       verbose=False)\n"
        "assert cell['status'] == 'ok', cell.get('traceback')\n"
        "assert cell['counts']['kernels'] and cell['counts']['peak_bytes']\n"
        "assert not dist.is_initialized()\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {BANNED!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


# Installed through PYTHONPATH into every process of a run (spawned workers
# too): each process leaves a file named by its pid, and an import of a
# blocked package leaves a file named by it and fails.
_SITECUSTOMIZE = """
import importlib.abc, os, sys
LOG = os.environ["ISOLATION_LOG"]
open(os.path.join(LOG, "pid-" + str(os.getpid())), "w").close()
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in %r:
            open(os.path.join(LOG, "blocked-" + name), "w").close()
            raise ImportError(name + " is blocked")
sys.meta_path.insert(0, _Block())
""" % ((*BANNED, "torch"),)

_SIM_SCRIPT = """
import sys
from repro_torch.core import MB, ratsim
from repro_torch.workloads.derive import derive_workload
from repro_torch.workloads.replay import replay

if __name__ == "__main__":
    pooled = ratsim.sweep([1 * MB, 2 * MB], [8], workers=2)
    assert pooled == ratsim.sweep([1 * MB, 2 * MB], [8], workers=0)
    trace = derive_workload("granite-moe-1b-a400m", "decode_32k",
                            n_gpus=16, n_steps=2)
    rep = replay(trace)
    assert rep.cold_degradation > rep.steady_degradation
    print("ok")
"""


def test_simulator_path_loads_no_torch(tmp_path):
    """``repro_torch.core``, ``workloads.derive`` and ``.replay``, a sweep
    on a pool of two spawned workers, and the replay CLI without
    ``--calibrate``: no process of the run imports torch, jax or
    ``repro``."""
    site, log = tmp_path / "site", tmp_path / "log"
    site.mkdir()
    log.mkdir()
    (site / "sitecustomize.py").write_text(_SITECUSTOMIZE)
    script = tmp_path / "sim.py"
    script.write_text(_SIM_SCRIPT)
    env = {**os.environ, "ISOLATION_LOG": str(log),
           "PYTHONPATH": os.pathsep.join([str(site), str(ROOT / "src")])}
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"
    assert len(list(log.glob("pid-*"))) >= 3      # the pool did spawn
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.workloads", "--arch",
         "granite-moe-1b-a400m", "--steps", "2"], capture_output=True,
        text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert cli.returncode == 0, cli.stderr[-3000:]
    assert "# cold (step 0) degradation:   1.0385" in cli.stdout
    assert not list(log.glob("blocked-*")), sorted(log.glob("blocked-*"))


_SERVING_SCRIPT = """
from repro_torch.serving import TrafficPoint, sweep_traffic

if __name__ == "__main__":
    pts = [TrafficPoint(rps=40.0, arrival=arrival, n_requests=3, seed=2,
                        steps_cap=6, prompt_mean=16, output_mean=2,
                        retention_ns=50_000.0, profile_path=%r)
           for arrival in ("poisson", "bursty")]
    pooled = sweep_traffic(pts, workers=2)
    serial = sweep_traffic(pts, workers=0)
    for pt in pts:
        assert [(s.t_start, s.t_end, s.comm_ns, s.walks)
                for s in pooled[pt].steps] == [
            (s.t_start, s.t_end, s.comm_ns, s.walks)
            for s in serial[pt].steps]
        assert pooled[pt].ttft_percentiles() == serial[pt].ttft_percentiles()
    print("ok")
"""


def _blocked_env(tmp_path):
    """PYTHONPATH with the blocking ``sitecustomize`` first, and its log."""
    site, log = tmp_path / "site", tmp_path / "log"
    site.mkdir()
    log.mkdir()
    (site / "sitecustomize.py").write_text(_SITECUSTOMIZE)
    env = {**os.environ, "ISOLATION_LOG": str(log),
           "PYTHONPATH": os.pathsep.join([str(site), str(ROOT / "src")])}
    return env, log


def test_serving_path_loads_no_torch(tmp_path):
    """``repro_torch.serving``: ``sweep_traffic`` on a pool of two spawned
    workers (each loading a saved profile), and ``python -m
    repro_torch.serving`` with ``--fleet 2`` and with ``--disagg 1:1
    --profile``: no process of the run imports torch, jax or ``repro``."""
    from repro_torch.workloads.calibrate import ComputeProfile, PhaseWindow
    prof = tmp_path / "granite.json"
    ComputeProfile(
        arch="granite-moe-1b-a400m", shape="decode_32k", n_gpus=16, ep=16,
        tp=1, dp=1, phases={ph: PhaseWindow(
            phase=ph, kernels=(), roofline_ns=1000.0,
            measured_wall_ns=1000.0, measured_flops=1.0,
            calibrated_ns=ns) for ph, ns in (("attn_mixer", 2500.0),
                                             ("moe_ffn", 4000.0))}).save(prof)
    env, log = _blocked_env(tmp_path)
    script = tmp_path / "serve.py"
    script.write_text(_SERVING_SCRIPT % str(prof))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"
    assert len(list(log.glob("pid-*"))) >= 3      # the pool did spawn
    base = [sys.executable, "-m", "repro_torch.serving", "--arch",
            "granite-moe-1b-a400m", "--requests", "3", "--steps-cap", "12",
            "--prompt-mean", "16", "--output-mean", "2"]
    for extra, want in ((["--fleet", "2", "--autoscale"], "# fleet:"),
                        (["--disagg", "1:1", "--profile", str(prof)],
                         "# disagg: 1 prefill + 1 decode pods")):
        cli = subprocess.run(base + extra, capture_output=True, text=True,
                             timeout=300, cwd=str(tmp_path), env=env)
        assert cli.returncode == 0, cli.stderr[-3000:]
        assert want in cli.stdout and "metric,p50_us" in cli.stdout
    assert not list(log.glob("blocked-*")), sorted(log.glob("blocked-*"))


@pytest.mark.parametrize("path", HOST_EXAMPLES, ids=lambda p: p.name)
def test_host_examples_print_the_reference_s_lines(path, tmp_path):
    """Each simulator example exits 0 with no GPU, loads no torch, jax or
    ``repro`` (spawned workers included), and prints the lines of the
    reference example it copies."""
    env, log = _blocked_env(tmp_path)
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(path)], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert not list(log.glob("blocked-*")), sorted(log.glob("blocked-*"))
    ref = ROOT / "examples" / path.name.replace("_torch", "")
    theirs = subprocess.run(
        [sys.executable, str(ref)], capture_output=True, text=True,
        timeout=300, cwd=str(ROOT),
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert theirs.returncode == 0, theirs.stderr[-3000:]
    assert out.stdout == theirs.stdout
    assert "===" in out.stdout


@pytest.mark.parametrize("path", CARD_EXAMPLES, ids=lambda p: p.name)
def test_torch_examples_refuse_without_gpu(path, tmp_path):
    """The torch examples run on the card: without one they exit non-zero
    with the port's error, before any step, and load no jax."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{str(path)!r}, '--ckpt', {str(tmp_path)!r}]\n"
        "try:\n"
        f"    runpy.run_path({str(path)!r}, run_name='__main__')\n"
        "finally:\n"
        "    bad = sorted(m for m in sys.modules\n"
        f"                 if m.split('.')[0] in {BANNED!r})\n"
        "    assert not bad, bad\n")
    if not path.name.startswith("train"):        # only training takes --ckpt
        code = code.replace(", '--ckpt', " + repr(str(tmp_path)), "")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr, out.stderr[-2000:]
    assert "AssertionError" not in out.stderr
    assert not any(tmp_path.glob("step_*"))


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """Run alone (no repo beside it) or on a GPU-less machine,
    chip_smoke.py exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, src in ((ROOT, ROOT / "chip_smoke.py"),
                     (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            src.write_text((ROOT / "chip_smoke.py").read_text())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run([sys.executable, str(src)], capture_output=True,
                             text=True, timeout=120, cwd=str(cwd), env=env)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
