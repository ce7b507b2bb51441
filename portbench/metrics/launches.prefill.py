"""Device kernels a profiled call."""


def read(run):
    t = run.trace
    return t.kernels / t.calls if t is not None and t.kernels else None
