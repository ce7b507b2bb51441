"""Measured compute windows for workload replay, timed on the H100.

The port of ``repro.workloads.calibrate``.  It runs the port's four
hand-written kernels (``rmsnorm`` + ``flash_attention`` for attention
mixers, ``ssd_scan``'s ``ssd_chunk`` for SSM mixers, ``grouped_matmul``
for MoE and dense FFNs) over capped slices of each phase's shapes, and
writes a :class:`ComputeProfile`: one calibrated window per ``(arch,
shape, phase)``.  The JSON is the reference's byte for byte, so either
package's ``--profile`` replay reads the other's profile unchanged.

Calibration model (roofline-anchored relative timing), as the reference:

    inv_eff(p)       = wall_ns(p) / flops_measured(p)
    wbar             = sum_p n_p * roofline_ns(p) * inv_eff(p)
                       / sum_p n_p * roofline_ns(p)
    calibrated_ns(p) = roofline_ns(p) * inv_eff(p) / wbar

where ``n_p`` is the phase's layer multiplicity.  The step total is kept
(``sum_p n_p * calibrated == sum_p n_p * roofline``); the phases share it
by their measured cost per useful FLOP.

Where the reference times its Pallas kernels in interpret mode on a CPU,
this module times the CUDA kernels' device time with CUDA events on the
current stream, queued behind a spin kernel so that host dispatch stays
out of the window (best of ``reps`` after one warm-up call, which also
absorbs the kernels' build at first use), and writes ``interpret=False``.
It times bf16 inputs (``ssd_chunk`` takes f32 only), the type that
``PodSpec``'s anchor (``dtype_bytes=2``, a bf16 ``peak_tflops``)
describes.  On the CPU, which
only the tests ask for, the kernels' plain versions run, the clock is
``time.perf_counter`` and the profile says ``interpret=True``: those are
not hardware kernel times.

Module import is torch-free (profiles load on the simulator's replay
path, which imports no torch); the measurers import torch and the kernel
tier when they run.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import TYPE_CHECKING, Dict, Optional

import numpy as np

from ..configs import SHAPES, get_config
from .derive import (PodSpec, ffn_phase, layer_roofline_ns, mixer_phase,
                     resolve_pod, step_shape)

if TYPE_CHECKING:  # pragma: no cover - typing only
    import torch

# v2: per-phase `layers` multiplicity entered the anchor normalization —
# v1 caches carry unweighted calibrated windows and must be re-measured.
PROFILE_VERSION = 2

# The reference's caps: the measured slice uses the model's true head and
# state dims; only the token, sequence, head, expert and FFN extents
# shrink.
_CAP_TOKENS = 128
_CAP_SEQ = 128
_CAP_HEADS = 4
_CAP_EXPERTS = 4
_CAP_FF = 128

# The spin queued ahead of each timed call (``_time_call``): 2^23 cycles,
# about 4 ms at the H100's 1.98 GHz (the host queues a measured call in
# under 1 ms), doubled after a call the host was slower than, up to 2^30.
_SPIN_CYCLES = 1 << 23
_SPIN_MAX_CYCLES = 1 << 30


@dataclass
class PhaseWindow:
    """One phase's measured + calibrated compute window (per layer)."""

    phase: str                 # attn_mixer | ssm_mixer | moe_ffn | dense_ffn
    kernels: tuple             # kernel names measured for this phase
    roofline_ns: float         # derive.py's per-layer roofline window
    measured_wall_ns: float    # kernel time of the capped slice
    measured_flops: float      # analytic flops of the measured slice
    calibrated_ns: float = 0.0
    layers: int = 1            # layer multiplicity (anchor weight)

    @property
    def inv_eff(self) -> float:
        return self.measured_wall_ns / max(self.measured_flops, 1.0)


@dataclass
class ComputeProfile:
    """Per-(arch, shape) calibrated compute windows, keyed by phase."""

    arch: str
    shape: str
    n_gpus: int
    ep: int
    tp: int
    dp: int
    interpret: bool = True     # False when measured on real hardware
    version: int = PROFILE_VERSION
    phases: Dict[str, PhaseWindow] = field(default_factory=dict)

    def window_ns(self, phase: str) -> Optional[float]:
        w = self.phases.get(phase)
        return w.calibrated_ns if w is not None else None

    def matches(self, arch: str, shape: str, n_gpus: int,
                ep: Optional[int] = None, tp: Optional[int] = None,
                dp: Optional[int] = None) -> bool:
        """Is this profile valid for the given workload?  Rooflines (and
        hence calibrated windows) scale with ep/tp/dp, so a profile for one
        split must not be applied to another.  ``None`` skips a
        component."""
        return (self.arch == arch and self.shape == shape
                and self.n_gpus == n_gpus
                and (ep is None or self.ep == ep)
                and (tp is None or self.tp == tp)
                and (dp is None or self.dp == dp))

    # ------------------------------------------------------------- JSON I/O
    def to_json(self) -> str:
        d = asdict(self)
        for p in d["phases"].values():
            p["kernels"] = list(p["kernels"])
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ComputeProfile":
        d = json.loads(text)
        if d.get("version") != PROFILE_VERSION:
            raise ValueError(
                f"compute profile version {d.get('version')!r} != "
                f"{PROFILE_VERSION}; re-run calibration")
        phases = {k: PhaseWindow(**{**v, "kernels": tuple(v["kernels"])})
                  for k, v in d.pop("phases").items()}
        return cls(phases=phases, **d)

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json())
        return path

    @classmethod
    def load(cls, path) -> "ComputeProfile":
        return cls.from_json(Path(path).read_text())


def default_cache_path(arch: str, shape: str, n_gpus: int,
                       root="calibration") -> Path:
    return Path(root) / f"{arch}_{shape}_g{n_gpus}.json"


# --------------------------------------------------------------------------
# Measurement harness
# --------------------------------------------------------------------------
def _time_call(fn, reps: int, device: torch.device) -> float:
    """Best-of-``reps`` time (ns) of ``fn()``, after one warm-up call.

    On the card the window is device time: a spin kernel is queued ahead of
    the start event, so the host has queued all of ``fn``'s work before the
    device reaches it, and the events hold the kernels back to back, not the
    host's dispatch between them.  A call whose start event the device
    passed before its end event was queued is not kept, and the spin is
    doubled for the next; so ``fn`` runs ``reps + 1`` times whatever the
    host does.  On the CPU, the host clock."""
    import torch

    fn()                                   # build at first use, warm caches
    best = math.inf
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        spin = _SPIN_CYCLES
        with torch.cuda.device(device):
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(spin)
                start.record(stream)
                fn()
                end.record(stream)
                early = start.query()
                end.synchronize()
                if early:
                    spin = min(2 * spin, _SPIN_MAX_CYCLES)
                    continue
                best = min(best, start.elapsed_time(end) * 1e6)
        if best == math.inf:
            raise RuntimeError(f"calibrate: in each of {reps} timed calls "
                               f"the host took longer to queue the work "
                               f"than the spin ahead of it")
        return best
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e9


def _generator(device: torch.device, seed: int) -> torch.Generator:
    import torch

    return torch.Generator(device=device).manual_seed(seed)


def slice_shape(cfg, phase: str) -> tuple:
    """The capped slice a phase is measured at: ``(T, D, S, H, KV, Dh)``
    for ``attn_mixer`` (rmsnorm [T,D]; flash_attention q [1,S,H,Dh], k, v
    [1,S,KV,Dh]), ``(S, chunk, H, P, N)`` for ``ssm_mixer`` (ssd_scan over
    [1,S,H,P], B, C [1,S,N]) and ``(T, D, F, E)`` for the FFN phases
    (grouped_matmul [T,D] x [E,D,F])."""
    if phase == "attn_mixer":
        H = min(cfg.n_heads, _CAP_HEADS)
        return (_CAP_TOKENS, cfg.d_model, _CAP_SEQ, H,
                max(1, min(cfg.n_kv_heads, H)), cfg.d_head)
    if phase == "ssm_mixer":
        H = min(max(1, cfg.d_model * cfg.ssm_expand
                    // max(cfg.ssm_head_dim, 1)), 2)
        return (_CAP_SEQ, 64, H, max(cfg.ssm_head_dim, 8),
                min(max(cfg.ssm_state, 16), 64))
    E = min(cfg.n_experts, _CAP_EXPERTS) if phase == "moe_ffn" else 1
    return _CAP_TOKENS, cfg.d_model, _CAP_FF, E


def ffn_offsets(T: int, E: int) -> torch.Tensor:
    """Equal ragged groups covering every row (the hot MoE case)."""
    import torch

    return torch.from_numpy(np.linspace(0, T, E + 1, dtype=np.int32))


def _measure_attn_mixer(cfg, reps: int, device: torch.device):
    import torch

    from ..kernels import ops

    T, D, S, H, KV, Dh = slice_shape(cfg, "attn_mixer")
    g = _generator(device, 0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    q = randn(1, S, H, Dh)
    k = randn(1, S, KV, Dh)
    v = randn(1, S, KV, Dh)
    x = randn(T, D)
    w = randn(D, dtype=torch.float32)

    wall = (_time_call(lambda: ops.rmsnorm(x, w), reps, device)
            + _time_call(lambda: ops.flash_attention(q, k, v, causal=True),
                         reps, device))
    flops = 4.0 * T * D + 4.0 * H * S * S * Dh
    return wall, flops, ("rmsnorm", "flash_attention")


def _measure_ssm_mixer(cfg, reps: int, device: torch.device):
    import torch

    from ..kernels import ops

    S, chunk, H, P, N = slice_shape(cfg, "ssm_mixer")
    g = _generator(device, 1)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    x = randn(1, S, H, P)
    dt = torch.nn.functional.softplus(randn(1, S, H))
    A_log = randn(H) * 0.5
    B = randn(1, S, N) / math.sqrt(N)
    C = randn(1, S, N) / math.sqrt(N)

    wall = _time_call(lambda: ops.ssd_scan(x, dt, A_log, B, C, chunk=chunk),
                      reps, device)
    nc = S // chunk
    flops = nc * H * (2.0 * chunk * chunk * (N + P) + 2.0 * chunk * P * N)
    return wall, flops, ("ssd_scan",)


def _measure_ffn(cfg, moe: bool, reps: int, device: torch.device):
    import torch

    from ..kernels import ops

    T, D, F, E = slice_shape(cfg, "moe_ffn" if moe else "dense_ffn")
    g = _generator(device, 2)
    lhs = torch.randn(T, D, generator=g, device=device).to(torch.bfloat16)
    rhs = (torch.randn(E, D, F, generator=g, device=device)
           / math.sqrt(D)).to(torch.bfloat16)
    offs = ffn_offsets(T, E).to(device)

    wall = _time_call(lambda: ops.grouped_matmul(lhs, rhs, offs), reps,
                      device)
    flops = 2.0 * T * D * F
    return wall, flops, ("grouped_matmul",)


# --------------------------------------------------------------------------
# Roofline windows per phase (derive.py's step_shape / layer_roofline_ns
# are the single source of the formulas).
# --------------------------------------------------------------------------
def _phase_rooflines(cfg, spec, pod: PodSpec):
    """(phase -> per-layer roofline ns, phase -> layer multiplicity)."""
    t_step, _, flop_mult = step_shape(spec, pod)
    roof: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for i in range(cfg.n_layers):
        roof_mixer, roof_ffn = layer_roofline_ns(cfg, i, t_step, pod,
                                                 flop_mult)
        for phase, ns in ((mixer_phase(cfg, i), roof_mixer),
                          (ffn_phase(cfg, i), roof_ffn)):
            roof.setdefault(phase, ns)
            count[phase] = count.get(phase, 0) + 1
    return roof, count


_MEASURERS = {
    "attn_mixer": lambda cfg, reps, device: _measure_attn_mixer(cfg, reps,
                                                                device),
    "ssm_mixer": lambda cfg, reps, device: _measure_ssm_mixer(cfg, reps,
                                                              device),
    "moe_ffn": lambda cfg, reps, device: _measure_ffn(cfg, True, reps,
                                                      device),
    "dense_ffn": lambda cfg, reps, device: _measure_ffn(cfg, False, reps,
                                                        device),
}


def calibrate(arch, shape: str, *, pod: Optional[PodSpec] = None,
              n_gpus: Optional[int] = None, reps: int = 3,
              cache_path=None, force: bool = False,
              device=None) -> ComputeProfile:
    """Measure (or load) the :class:`ComputeProfile` of ``(arch, shape)``.

    ``cache_path`` is read unless ``force`` and written after measurement;
    a stale or corrupt cache is measured again.  ``device=None`` is the
    card (raising without one); ``"cpu"`` runs the plain versions.
    """
    from ..device import resolve_device

    device = resolve_device(device)
    cfg = get_config(arch) if isinstance(arch, str) else arch
    spec = SHAPES[shape]

    pod = pod or PodSpec()
    if n_gpus is not None:
        pod = dataclasses.replace(pod, n_gpus=n_gpus)
    pod = resolve_pod(pod, cfg, spec.kind)

    if cache_path is not None and not force:
        p = Path(cache_path)
        if p.exists():
            try:
                prof = ComputeProfile.load(p)
            except (ValueError, KeyError, TypeError,
                    json.JSONDecodeError):
                prof = None      # stale version / corrupt cache: re-measure
            if prof is not None and prof.matches(cfg.name, shape,
                                                 pod.n_gpus, pod.ep,
                                                 pod.tp, pod.dp):
                return prof

    rooflines, counts = _phase_rooflines(cfg, spec, pod)
    phases: Dict[str, PhaseWindow] = {}
    for phase, roof in rooflines.items():
        wall, flops, kernels = _MEASURERS[phase](cfg, reps, device)
        phases[phase] = PhaseWindow(
            phase=phase, kernels=kernels, roofline_ns=roof,
            measured_wall_ns=wall, measured_flops=flops,
            layers=counts[phase])

    # Roofline-anchored redistribution (module docstring): preserve the
    # layer-weighted step total while phases inherit their measured
    # relative inefficiency.
    total_roof = sum(w.layers * w.roofline_ns for w in phases.values())
    wbar = (sum(w.layers * w.roofline_ns * w.inv_eff
                for w in phases.values())
            / total_roof) if total_roof > 0 else 1.0
    for w in phases.values():
        w.calibrated_ns = (w.roofline_ns * w.inv_eff / wbar
                           if wbar > 0 else w.roofline_ns)

    prof = ComputeProfile(arch=cfg.name, shape=shape, n_gpus=pod.n_gpus,
                          ep=pod.ep, tp=pod.tp, dp=pod.dp,
                          interpret=device.type != "cuda", phases=phases)
    if cache_path is not None:
        prof.save(cache_path)
    return prof
