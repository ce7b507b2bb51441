"""The benchmark's yardstick: the H100's peaks and each kernel's operations
and bytes (a family's model FLOPs sit beside its reference, as
``reference/<family>.py``'s ``model_flops``).  Frozen here, so that a change
to the program cannot move the measure it is held to.

Peaks: NVIDIA's H100 Tensor Core GPU data sheet, SXM part, dense rates
without sparsity, at its 700 W limit.  The kernels' formulas are those of
``repro_torch/launch/roofline.py`` when this benchmark was written: each
input read once and each output written once; where the work depends on
the data (a grouped matmul's kept rows) the caller passes what these
inputs need.  Every function returns (bytes, flops).
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12            # bytes/s, HBM3


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the card could take: the larger of bytes over the
    bandwidth and operations over the dtype's peak."""
    return max(nbytes / HBM_BW, flops / PEAK_FLOPS[dtype])


# ------------------------------------------------------ kernel formulas
def rmsnorm_cost(T: int, D: int, es: int):
    """x read and y written in x's dtype, w in f32; 4 flops an element."""
    return 2 * T * D * es + 4 * D, 4 * T * D


def attention_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the mask keeps: the causal band only."""
    if not causal:
        return Sq * Sk
    w = window if window > 0 else Sq
    n = min(w, Sq)
    return n * (n + 1) // 2 + (Sq - n) * w


def attention_cost(B, Sq, Sk, H, KV, Dh, causal, window, es):
    """q, k, v read, out written; 4 Dh flops a kept pair, per head."""
    return ((2 * B * Sq * H * Dh + 2 * B * Sk * KV * Dh) * es,
            4 * B * H * Dh * attention_pairs(Sq, Sk, causal, window))


def gmm_cost(T, K, N, E, rows, used, es):
    """lhs [T,K] x rhs [E,K,N] -> [T,N]: the ``rows`` the group offsets
    cover read, the weights of the ``used`` experts read, every output row
    written, the int32 offsets read; 2 K N flops a covered row."""
    return ((rows * K + used * K * N + T * N) * es + 4 * (E + 1),
            2 * rows * K * N)


def ssd_cost(BC: int, Q: int, H: int, P: int, N: int):
    """One ``ssd_chunk`` launch over BC (batch, chunk) cells of Q steps,
    f32: operands read and outputs (y, the chunk states) written once;
    C.B^T once a cell for k <= q, as are the y terms."""
    pairs = Q * (Q + 1) // 2
    nbytes = 4 * (2 * BC * Q * H * P + 2 * BC * Q * H + 2 * BC * Q * N
                  + BC * H * P * N)
    flops = 2 * BC * pairs * N + 2 * BC * H * (pairs * P + Q * P * N)
    return nbytes, flops


def ssd_chunk_len(S: int, chunk: int) -> int:
    """The chunk a scan of S steps runs at: the model's, shrunk until it
    divides S."""
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    return Q
