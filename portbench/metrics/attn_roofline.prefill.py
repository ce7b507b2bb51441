"""Attention's share (%) of its roofline: the sum of each launch's least
time (``roofline.attention_cost`` at bf16, causal, one launch a layer)
over the device time of the kernels whose names start with ``flash_``."""

PREFIX = "flash_"


def read(run):
    t = run.trace
    if t is None:
        return None
    dev_s, n = t.device_time(PREFIX)
    if n == 0 or dev_s <= 0:
        return None
    y, m = run.yardstick, run.model
    bound = 0.0
    for c in run.profiled:
        B, S = c["batch"], c["prompt_len"]
        cost = y.attention_cost(B, S, S, m["n_heads"], m["n_kv_heads"],
                                m["d_head"], True, 0, 2)
        bound += m["n_layers"] * y.bound_s(*cost, "bfloat16")
    return 100.0 * bound / dev_s
