"""Runtime calls that held the host until the device caught up
(stream, event and device synchronizes, blocking copies), a profiled
call."""


def read(run):
    t = run.trace
    return t.syncs / t.calls if t is not None and t.kernels else None
