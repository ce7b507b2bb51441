"""The SSD chunk kernel's share (%) of its roofline: the sum of each
launch's least time (``roofline.ssd_cost``, f32, against the 67 TFLOP/s
f32 peak; one launch a layer over every (prompt, chunk) cell) over the
device time of the kernels whose names start with ``ssd_chunk``."""

PREFIX = "ssd_chunk"


def read(run):
    t = run.trace
    if t is None:
        return None
    dev_s, n = t.device_time(PREFIX)
    if n == 0 or dev_s <= 0:
        return None
    y, m = run.yardstick, run.model
    P, N = m["ssm_head_dim"], m["ssm_state"]
    H = m["ssm_expand"] * m["d_model"] // P
    bound = 0.0
    for c in run.profiled:
        B, S = c["batch"], c["prompt_len"]
        Q = y.ssd_chunk_len(S, m["ssm_chunk"])
        cost = y.ssd_cost(B * (S // Q), Q, H, P, N)
        bound += m["n_layers"] * y.bound_s(*cost, "float32")
    return 100.0 * bound / dev_s
