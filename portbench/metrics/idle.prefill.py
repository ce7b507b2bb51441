"""The share (%) of the traced window, first issue to last return of the
profiled calls, that the union of the device's operations (kernels,
copies, fills) leaves uncovered."""


def read(run):
    t = run.trace
    if t is None or not t.kernels or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
