"""Seconds from the process's start to the window's start: imports, the
card's start-up, the kernels' build or load, the weights, the warm-up."""


def read(run):
    return run.setup_s
