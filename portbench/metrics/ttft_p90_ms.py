"""The 90th percentile, over every request of the window, of the time from
its call's issue to its first token on the host (the argmax and its copy
included; the requests of a call share the call's time), in ms."""
from portbench.window import percentile


def read(run):
    t = run.window.ttfts()
    return percentile(t, 90) * 1e3 if t else None
