"""Build the port's CUDA kernels from ``kernels/csrc`` and load them.

Each ``csrc/*.cu`` has plain C entry points (``<entry>_launch``: the
forward, and the backward beside it: dX and dW for grouped_matmul) and is
compiled by its own ``nvcc`` into a shared library, all of them started
together, then loaded with :mod:`ctypes`.  No source includes PyTorch's
headers, so the whole build takes seconds rather than the minutes a
``torch.utils.cpp_extension`` binding costs, which matters because every
fresh checkout builds at first use.  Libraries land in ``build/torch_ext/``
of the checkout (listed in ``.gitignore``), named by a hash of the
``.cu`` file, every header under ``csrc/`` and the compiler flags, so an
edited kernel or helper header is rebuilt and an unchanged one is reused.
The TMA tensor maps are encoded through the runtime's driver entry point
(``csrc/hopper.cuh``), so no library links against ``libcuda``.

Nothing here runs at import: the CPU tests import every module on a machine
without ``nvcc``.  A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
KERNELS = ("rmsnorm", "flash_attention", "grouped_matmul", "ssd_chunk")
# entry point -> the source (library) that holds it
ENTRIES = {"rmsnorm": "rmsnorm", "rmsnorm_bwd": "rmsnorm",
           "rmsnorm_part": "rmsnorm", "rmsnorm_scale": "rmsnorm",
           "rmsnorm_bwd_part": "rmsnorm", "rmsnorm_bwd_scale": "rmsnorm",
           "flash_attention": "flash_attention",
           "flash_attention_bwd": "flash_attention",
           "grouped_matmul": "grouped_matmul",
           "grouped_matmul_dx": "grouped_matmul",
           "grouped_matmul_dw": "grouped_matmul", "ssd_chunk": "ssd_chunk",
           "ssd_chunk_bwd": "ssd_chunk"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_SIGNATURES = {
    # x, w, out, T, D, eps, dtype, stream
    "rmsnorm": (_P, _P, _P, _I, _I, _F, _I, _P),
    # x, w, dy, dx, dw, partial, T, D, eps, dtype, stream
    "rmsnorm_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P),
    # a row split over ranks: x, ss, T, D, dtype, stream; then x, w, ss,
    # out, T, D, the row's length, eps, dtype, stream
    "rmsnorm_part": (_P, _P, _I, _I, _I, _P),
    "rmsnorm_scale": (_P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # its backward: x, w, dy, sums, T, D, dtype, stream; then x, w, dy,
    # sums, dx, dw, partial, T, D, the row's length, eps, dtype, stream
    "rmsnorm_bwd_part": (_P, _P, _P, _P, _I, _I, _I, _P),
    "rmsnorm_bwd_scale": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                          _P),
    # q, k, v, o, lse, part, B, Sq, Sk, H, KV, Dh, scale, causal, window,
    # route, splits, keys a split, dtype, stream (ops.attention_plan)
    "flash_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                        _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, o, dout, lse, dq, dk, dv, Dd, B, Sq, Sk, H, KV, Dh, scale,
    # causal, window, route, dtype, stream (ops.attention_bwd_plan)
    "flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _I, _I, _F, _I, _I, _I, _I, _P),
    # lhs, rhs, offsets, out, T, D, F, E, dtype, stream
    "grouped_matmul": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # dy, w, offsets, dx, T, D, F, E, dtype, stream
    "grouped_matmul_dx": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # lhs, dy, offsets, dw, T, D, F, E, dtype, stream
    "grouped_matmul_dw": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, dt, a, B, C, y, state, BC, Q, H, P, N, stream (f32 only)
    "ssd_chunk": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, dt, a, B, C, dy, ds (either may be NULL), dx, ddt, da, dB, dC,
    # scratch, its length in floats, BC, Q, H, P, N, stream (f32 only)
    "ssd_chunk_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _L, _I, _I, _I, _I, _I, _P),
}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}       # kernel -> nvcc's ptxas report
BUILD_SECONDS: Optional[float] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("repro_torch: nvcc not found (set CUDA_HOME); the "
                       "CUDA kernels are built from kernels/csrc at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join([*NVCC_FLAGS, "-I", str(CSRC)]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile (in parallel) and load every kernel library not yet loaded."""
    global BUILD_SECONDS
    todo = [n for n in KERNELS if n not in _LIBS]
    if not todo:
        return _LIBS
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n"
                          f"{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("repro_torch: kernel build failed\n"
                           + "\n".join(failed))
    for name in todo:
        lib = ctypes.CDLL(str(_lib_path(name)))
        for entry, src in ENTRIES.items():
            if src == name:
                fn = getattr(lib, f"{entry}_launch")
                fn.argtypes = list(_SIGNATURES[entry])
                fn.restype = ctypes.c_int
        _LIBS[name] = lib
    BUILD_SECONDS = time.perf_counter() - t0
    return _LIBS


def sass(name: str) -> str:
    """The SASS of kernel library ``name`` (``cuobjdump --dump-sass``, from
    the toolkit beside ``nvcc``): what each kernel compiled to."""
    build_all()
    tool = Path(_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "--dump-sass", str(_lib_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def launcher(entry: str):
    """The C entry point ``<entry>_launch`` of a built kernel library."""
    return getattr(build_all()[ENTRIES[entry]], f"{entry}_launch")


def check(name: str, rc: int) -> None:
    """Raise if a kernel's launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"repro_torch: {name} kernel launch failed with "
                           f"CUDA error {rc}")
