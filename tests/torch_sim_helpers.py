"""Shared by the ``test_torch_sim_*`` files (not collected): moves the
simulator's values from ``repro`` to ``repro_torch`` and compares results
of the two packages exactly.

A reference dataclass (a ``SimConfig`` and everything in it, a
``PodSpec``, a ``StepArrays``...) crosses as the port's class of the same
name in the matching module, rebuilt field by field, the way weights
cross.  :func:`assert_same` walks two results the same way and wants every
field equal: floats bit for bit, arrays with their dtype and shape, dict
keys in their order.
"""
import dataclasses
import importlib
import math

import numpy as np

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
