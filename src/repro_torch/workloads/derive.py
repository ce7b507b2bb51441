"""Pod sizing and roofline windows: the part of ``repro.workloads.derive``
that the calibration harness needs, copied (the port imports nothing of
``repro``).

:class:`PodSpec` keeps every field and default of the reference.
:func:`resolve_pod` fills in the ep/tp/dp split, and :func:`step_shape`
and :func:`layer_roofline_ns` give the per-layer roofline windows that the
harness anchors its measurements to, by the reference's formulas, and
:func:`moe_a2a_bytes` the size of the EP all-to-all it prices.  The
topology layer is not copied: :func:`tier0_group` computes the one number
``resolve_pod`` reads from it.  Pure Python; no torch.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

# FabricConfig.gpus_per_node's default: two_tier's leaf when leaf_size is 0.
GPUS_PER_NODE = 4
TOPOLOGIES = ("multi_pod", "single_clos", "two_tier")


@dataclass(frozen=True)
class PodSpec:
    """The scale-up pod a workload is mapped onto.

    ``ep``/``tp``/``dp`` default per shape kind (see :func:`resolve_pod`):
    inference uses the largest tier-0 group for TP (the whole pod on the
    flat default, one leaf/pod on hierarchical topologies) and the largest
    compatible EP group — which may span tiers, so MoE dispatch/combine
    crosses the oversubscribed uplink while TP activation collectives stay
    on cheap intra-tier paths; train splits the pod into TP x DP replicas
    the same way.
    """

    n_gpus: int = 16
    ep: Optional[int] = None       # expert-parallel group size
    tp: Optional[int] = None       # tensor-parallel group size
    dp: Optional[int] = None       # data-parallel replicas inside the pod
    dtype_bytes: int = 2           # bf16 activations
    grad_bytes: int = 2            # bf16 gradient all-reduce
    peak_tflops: float = 990.0     # dense bf16 peak per GPU
    mfu: float = 0.4               # achieved fraction of peak in compute
    microbatch_tokens: int = 8192  # prefill/train tokens per microbatch
    # Buffer granularity: "per_layer" (every layer owns distinct pages) or
    # "pooled" (one reused arena per collective kind).
    buffer_reuse: str = "per_layer"
    # Pod topology and tier parameters, as the simulator's fabric reads
    # them.
    topology: str = "single_clos"
    leaf_size: int = 0             # two_tier leaf (0 => fabric default)
    oversubscription: float = 1.0  # two_tier leaf->spine uplink
    pod_size: int = 0              # multi_pod pod (0 => whole fabric)


def tier0_group(pod: PodSpec) -> int:
    """Largest GPU group whose all-pairs traffic stays on the first tier
    (``get_topology(pod_fabric(pod)).tier0_group()`` in the reference).

    ``single_clos`` is one tier: the whole pod.  ``two_tier`` and
    ``multi_pod`` partition the pod into blocks (a leaf of ``leaf_size``,
    default 4 GPUs; a pod of ``pod_size``, default the whole fabric), each
    capped at ``n_gpus`` and required to divide it.
    """
    n = pod.n_gpus
    if pod.topology == "single_clos":
        return n
    if pod.topology == "two_tier":
        block = pod.leaf_size if pod.leaf_size > 0 else GPUS_PER_NODE
    elif pod.topology == "multi_pod":
        block = pod.pod_size
    else:
        raise ValueError(f"unknown topology {pod.topology!r}; "
                         f"known: {sorted(TOPOLOGIES)}")
    block = min(block, n) if block > 0 else n
    if block <= 0 or n % block:
        raise ValueError(f"{pod.topology} needs n_gpus divisible by the "
                         f"block size (got {n} / {block})")
    return block


def resolve_pod(pod: PodSpec, cfg, kind: str) -> PodSpec:
    """Fill in default ep/tp/dp for a shape kind (see :class:`PodSpec`)."""
    n = pod.n_gpus
    ep = pod.ep
    if ep is None:
        ep = math.gcd(n, cfg.n_experts) if cfg.n_experts else 1
    elif ep > 1:
        # A user-supplied EP group must be realizable: experts shard
        # exactly (E_loc = E // ep) inside the pod.
        if ep > n:
            raise ValueError(f"ep({ep}) exceeds pod n_gpus({n})")
        if cfg.n_experts % ep:
            raise ValueError(
                f"ep({ep}) does not divide n_experts({cfg.n_experts})")
    tp = pod.tp
    dp = pod.dp
    tier0 = tier0_group(pod)
    if kind == "train":
        if tp is None:
            cap = min(8, tier0)
            tp = 1
            while tp * 2 <= cap and tp * 2 <= n and n % (tp * 2) == 0:
                tp *= 2
        if dp is None:
            dp = n // tp
    else:
        if tp is None:
            tp = min(n, tier0)
        if dp is None:
            dp = n // tp
    if tp * dp != n:
        raise ValueError(f"tp({tp}) x dp({dp}) != pod n_gpus({n})")
    return dataclasses.replace(pod, ep=ep, tp=tp, dp=dp)


def _layer_is_moe(cfg, i: int) -> bool:
    return cfg.n_experts > 0 and i % cfg.moe_every == cfg.moe_every - 1


def _attn_params(cfg) -> int:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return d * h * dh * 2 + d * kv * dh * 2      # q,o + k,v projections


def _ffn_params(cfg, i: int, active: bool) -> int:
    if _layer_is_moe(cfg, i):
        experts = cfg.top_k if active else cfg.n_experts
        return (3 * cfg.d_model * cfg.d_ff_expert * experts
                + cfg.d_model * cfg.n_experts)   # experts + router
    return 3 * cfg.d_model * cfg.d_ff if cfg.d_ff > 0 else 0


def _compute_ns(flops_per_gpu: float, pod: PodSpec) -> float:
    return flops_per_gpu / (pod.peak_tflops * 1e3 * pod.mfu)


def step_shape(spec, pod: PodSpec):
    """(t_step, n_microbatches, flop_mult) of one model step of ``spec``."""
    total_tokens = spec.global_batch * (1 if spec.kind == "decode"
                                        else spec.seq_len)
    if spec.kind == "decode":
        t_step, n_micro = spec.global_batch, 1
    else:
        t_step = min(pod.microbatch_tokens, total_tokens)
        n_micro = -(-total_tokens // t_step)
    return t_step, n_micro, (3.0 if spec.kind == "train" else 1.0)


def layer_roofline_ns(cfg, i: int, t_step: int, pod: PodSpec,
                      flop_mult: float):
    """Roofline (mixer_ns, ffn_ns) compute windows of layer ``i``."""
    mixer_ns = _compute_ns(
        flop_mult * 2.0 * _attn_params(cfg) * t_step / pod.tp, pod)
    is_moe = _layer_is_moe(cfg, i)
    ffn_ns = _compute_ns(
        flop_mult * 2.0 * _ffn_params(cfg, i, active=True)
        * t_step / (pod.ep if is_moe and pod.ep > 1 else pod.tp), pod)
    return mixer_ns, ffn_ns


def moe_a2a_bytes(cfg, tokens_local: int, ep: int, dtype_bytes: int) -> int:
    """Per-GPU bytes of one EP dispatch/combine all-to-all.

    The ``nbytes`` of the send buffer ``[ep, C, d_model]`` that
    ``repro_torch.models.moe.ep_dispatch`` builds, ``C = _capacity(T_loc)
    * E_loc`` with ``_capacity = max(8, T_loc * top_k * capacity_factor /
    E)``: the all-to-all size the simulator prices.
    """
    e_loc = cfg.n_experts // ep
    cap = max(8, int(tokens_local * cfg.top_k * cfg.capacity_factor
                     / cfg.n_experts))
    return ep * cap * e_loc * cfg.d_model * dtype_bytes
