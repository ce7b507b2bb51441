"""The model FLOPs of the profiled calls (the ``model_flops`` of the
configuration's reference family, ``reference/<family>.py``) over their
traced wall time at the H100's bf16 peak, 989 TFLOP/s, in %.  The card's
power limit is printed beside it."""


def read(run):
    t = run.trace
    if t is None or not t.kernels or t.window_s <= 0:
        return None
    flops = sum(run.reference.model_flops(run.model, c["batch"],
                                          c["prompt_len"])
                for c in run.profiled)
    return 100.0 * flops / (t.window_s * run.yardstick.PEAK_FLOPS["bfloat16"])
