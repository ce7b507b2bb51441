"""Shared by the ``test_torch_sim_*`` and serving files (not collected):
moves the simulator's values from ``repro`` to ``repro_torch`` and
compares results of the two packages exactly.

A reference dataclass (a ``SimConfig`` and everything in it, a
``PodSpec``, a ``StepArrays``...) crosses as the port's class of the same
name in the matching module, rebuilt field by field, the way weights
cross.  :func:`assert_same` walks two results the same way and wants every
field equal: floats bit for bit, arrays with their dtype and shape, dict
keys in their order.  :func:`assert_same_result` adds every aggregate a
serving result is read by, and :func:`same_or_same_fault` holds a
reference fault the port copies as parity.
"""
import dataclasses
import importlib
import math

import numpy as np
import pytest

# (wall ns, flops, kernels) each phase's measurer returns in place of a
# measurement, so that a profile is the same numbers in every run
FIXED = {
    "attn_mixer": (1.5e6, 3.3e7, ("rmsnorm", "flash_attention")),
    "ssm_mixer": (2.5e6, 1.1e7, ("ssd_scan",)),
    "moe_ffn": (7.0e5, 1.6e7, ("grouped_matmul",)),
    "dense_ffn": (9.0e5, 3.2e7, ("grouped_matmul",)),
}


def port_class(cls):
    """The port's class of the same name as the reference's ``cls``."""
    mod = cls.__module__
    assert mod.startswith("repro."), mod
    port = importlib.import_module("repro_torch." + mod[len("repro."):])
    return getattr(port, cls.__name__)


def to_port(obj):
    """``obj`` with every reference dataclass in it rebuilt as the port's."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return port_class(type(obj))(**{
            f.name: to_port(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, list):
        return [to_port(x) for x in obj]
    if isinstance(obj, tuple):
        return tuple(to_port(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_port(v) for k, v in obj.items()}
    return obj


def reference_profile(monkeypatch, arch, shape, n_gpus, cache_path=None):
    """``repro.workloads.calibrate.calibrate`` on :data:`FIXED`."""
    jcal = importlib.import_module("repro.workloads.calibrate")
    monkeypatch.setattr(jcal, "_MEASURERS", {
        p: (lambda cfg, reps, _p=p: FIXED[_p]) for p in FIXED})
    return jcal.calibrate(arch, shape, n_gpus=n_gpus, cache_path=cache_path)


def assert_same(ref, port, path="result"):
    """``port`` equals ``ref`` field by field, floats bit for bit."""
    if dataclasses.is_dataclass(ref) and not isinstance(ref, type):
        assert type(port) is port_class(type(ref)), (path, type(port))
        for f in dataclasses.fields(ref):
            assert_same(getattr(ref, f.name), getattr(port, f.name),
                        f"{path}.{f.name}")
    elif isinstance(ref, np.ndarray):
        assert isinstance(port, np.ndarray), path
        assert (port.dtype, port.shape) == (ref.dtype, ref.shape), path
        assert np.array_equal(port, ref, equal_nan=ref.dtype.kind == "f"), \
            path
    elif isinstance(ref, (list, tuple)):
        assert type(port) is type(ref) and len(port) == len(ref), path
        for i, (r, p) in enumerate(zip(ref, port)):
            assert_same(r, p, f"{path}[{i}]")
    elif isinstance(ref, dict):
        assert list(port) == list(ref), path
        for k in ref:
            assert_same(ref[k], port[k], f"{path}[{k!r}]")
    elif isinstance(ref, float):
        assert type(port) is type(ref), (path, type(port))
        assert port == ref or (math.isnan(ref) and math.isnan(port)), \
            (path, ref, port)
    else:
        assert type(port) is type(ref) and port == ref, (path, ref, port)


# what every serving result is read by, besides its fields
AGGREGATES = ("finished", "first_token_served", "ttft_percentiles",
              "itl_percentiles", "ttft_degradations", "mean_ttft_degradation",
              "p99_ttft_degradation", "cold_comm_ns", "warm_comm_ns",
              "cold_steps", "fastpath_calls", "fastpath_step_fraction")
DISAGG_AGGREGATES = ("steps", "kv_transfer_total_ns", "kv_excess_total_ns",
                     "kv_walks", "kv_cold_handoffs", "kv_fastpath_calls",
                     "ttft_breakdown", "replica_rows")


def assert_same_result(ref, port, extra=()):
    """Every field, then every aggregate, of two serving results."""
    assert_same(ref, port)
    for name in AGGREGATES + tuple(extra):
        want, got = getattr(ref, name), getattr(port, name)
        if callable(want):
            want, got = want(), got()
        assert_same(want, got, name)


def same_or_same_fault(ref_fn, port_fn):
    """``(ref_fn(), port_fn())``, or ``(None, None)`` where the reference
    raises and the port raises the same error: a reference fault the port
    copies on purpose (ROADMAP.md section 3) is held as parity too."""
    try:
        ref = ref_fn()
    except Exception as fault:          # whatever it is, the port's too
        with pytest.raises(type(fault)) as err:
            port_fn()
        assert str(err.value) == str(fault)
        return None, None
    return ref, port_fn()
