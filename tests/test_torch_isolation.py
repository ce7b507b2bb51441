"""The port stands alone: no jax, nothing of ``repro``, no silent CPU.

``src/repro_torch`` and ``chip_smoke.py`` must run on a machine where jax
is absent and the JAX package is not importable, and their entry points
must refuse (not quietly fall back) when no GPU is present.
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
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
    bad = [(ln, mod) for ln, mod in _imported_roots(path)
           if mod in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_every_module_loads_no_jax_or_repro():
    mods = list(_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
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
