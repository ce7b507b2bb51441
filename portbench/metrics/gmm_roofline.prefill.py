"""The grouped matmuls' share (%) of their roofline: the sum of each
launch's least time (``roofline.gmm_cost`` at bf16: the rows kept and the
experts used, counted by the reference's routing of the profiled calls'
prompts; gate, up and down a layer) over the device time of the kernels
whose names start with ``gmm``."""

NEEDS = ("route_stats",)
PREFIX = "gmm"


def read(run):
    t = run.trace
    if t is None:
        return None
    dev_s, n = t.device_time(PREFIX)
    if n == 0 or dev_s <= 0:
        return None
    y, m = run.yardstick, run.model
    D, F, E = m["d_model"], m["d_ff_expert"], m["n_experts"]
    bound = 0.0
    for c in run.profiled:
        r = c["route"]
        for rows, used in zip(r["moe_kept"], r["moe_used"]):
            for K, N in ((D, F), (D, F), (F, D)):
                bound += y.bound_s(*y.gmm_cost(rows, K, N, E, rows, used, 2),
                                   "bfloat16")
    return 100.0 * bound / dev_s
