"""Derive per-step collective sequences from real model configs (DESIGN.md §8).

The port's copy of ``repro.workloads.derive``, with every float expression
in the reference's operand order.  Given a model config, an input shape
(``decode_32k`` / ``prefill_32k`` / ``train_4k``) and a pod description,
it emits the ordered sequence of collectives one model step fires — sized
from the model's own dimensions — ready to replay through a persistent-TLB
session (:mod:`repro_torch.workloads.replay`).  The calibration harness
(:mod:`repro_torch.workloads.calibrate`) anchors its measured windows to
the rooflines of :func:`step_shape` and :func:`layer_roofline_ns`.

Derivation formulas (first-order, documented in DESIGN.md §8):

* **MoE expert-parallel dispatch/combine** (the paper's collective): the
  all-to-all of :func:`repro_torch.models.moe.moe_block_ep` exchanges a
  ``[ep, C, d_model]`` buffer where ``C = max(8, T_loc*top_k*cf/E) * E_loc``
  — so ``bytes = ep * C * d_model * dtype_bytes``, twice per MoE layer.
* **Tensor-parallel activation collectives**: sequence-parallel Megatron
  form — one all-gather + one reduce-scatter of the full activation
  (``T_step * d_model * dtype_bytes``) around each sharded sublayer.
* **Data-parallel gradient sync** (train only): one ring all-reduce per
  layer of that layer's TP-sharded parameter bytes, each layer a distinct
  buffer (cold pages every step — unlike the reused activation buffers).
* **Compute windows**: roofline gaps between collectives,
  ``flops / (peak_tflops * mfu)``, with fwd ``2·P_active·T`` (×3 for train).

Pure-Python sizing only — importing this module imports no torch, and
neither does the registry lookup (``arch`` by name).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, List, Optional

from ..core.config import FabricConfig
from ..core.select import get_policy
from ..core.topology import get_topology

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..models.spec import ModelConfig


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
    # Buffer granularity.  "per_layer": zero-copy semantics — collectives
    # write directly into each layer's persistent tensors, so every layer
    # owns distinct pages (UALink remote stores target the real destination
    # buffer; this is the faithful default).  "pooled": all layers exchange
    # through one reused communication arena per collective kind
    # (NCCL-channel-style staging), collapsing the Link-TLB working set.
    buffer_reuse: str = "per_layer"
    # Pod topology (repro_torch.core.topology) + tier parameters, mirrored into
    # the replay FabricConfig so the derived EP/TP/DP placement and the
    # simulated fabric agree.
    topology: str = "single_clos"
    leaf_size: int = 0             # two_tier leaf (0 => fabric default)
    oversubscription: float = 1.0  # two_tier leaf->spine uplink
    pod_size: int = 0              # multi_pod pod (0 => whole fabric)


def pod_fabric(pod: PodSpec) -> FabricConfig:
    """The :class:`FabricConfig` a pod spec describes (replay + placement)."""
    return FabricConfig(n_gpus=pod.n_gpus, topology=pod.topology,
                        leaf_size=pod.leaf_size,
                        oversubscription=pod.oversubscription,
                        pod_size=pod.pod_size)


@dataclass(frozen=True)
class CollectiveCall:
    """One collective of the derived sequence."""

    label: str          # e.g. "tok0/L3/moe_dispatch"
    collective: str     # concrete pattern registry name (resolved)
    nbytes: int         # per-GPU buffer size (pattern semantics)
    group: int          # participating GPU count
    compute_ns: float   # compute window preceding this collective
    buffer: str         # logical buffer id (distinct ids -> distinct pages)
    step: int           # model step (decode: token index)
    # Pod-rank stride of the group (SimSession.run rank_stride): a DP
    # replica group has one member per TP island, so its ring sits on
    # ranks 0, tp, 2*tp, ... — on hierarchical topologies that is what
    # makes gradient sync cross tiers.  1 = contiguous ranks.
    stride: int = 1
    # Provenance of the window: the calibration phase whose *entire*
    # per-layer window precedes this call ("" when the gap is zero or an
    # accumulation of carried sublayer windows).  Lets a ComputeProfile be
    # re-applied at replay time without re-deriving the trace.
    phase: str = ""
    # Exact decomposition of ``compute_ns`` into (phase, ns) sublayer
    # windows, carried windows included in accumulation order — so
    # replay-time profile application (SimSession.resolve_gap) reproduces
    # derive-time application bit-for-bit even when tp == 1 folds several
    # sublayer windows into one gap.  Empty when the gap is zero.
    window_parts: tuple = ()
    # Resolution provenance (DESIGN.md §14): the *logical* collective the
    # emitter requested ("allreduce", "all_to_all", ...) and which policy
    # decision resolved it to ``collective`` ("fixed", "auto:cold",
    # "table:warm", ...).  Empty strings on hand-built traces.
    logical: str = ""
    resolved_by: str = ""


@dataclass
class WorkloadTrace:
    """A derived sequence of collectives plus its provenance."""

    arch: str
    shape: str
    pod: PodSpec
    calls: List[CollectiveCall] = field(default_factory=list)
    tokens_per_step: int = 0
    n_microbatches: int = 1     # prefill/train: microbatches per full pass

    @property
    def n_steps(self) -> int:
        return (self.calls[-1].step + 1) if self.calls else 0

    def step_calls(self, step: int) -> List[CollectiveCall]:
        return [c for c in self.calls if c.step == step]

    def total_bytes(self) -> int:
        return sum(c.nbytes for c in self.calls)


def _largest_common_group(pod_gpus: int, n_experts: int) -> int:
    """Largest EP group that divides both the pod and the expert count."""
    return math.gcd(pod_gpus, n_experts)


def resolve_pod(pod: PodSpec, cfg: "ModelConfig", kind: str) -> PodSpec:
    """Fill in default ep/tp/dp for a shape kind (see module docstring)."""
    n = pod.n_gpus
    ep = pod.ep
    if ep is None:
        ep = _largest_common_group(n, cfg.n_experts) if cfg.n_experts else 1
    elif ep > 1:
        # A user-supplied EP group must be realizable: moe_block_ep shards
        # experts exactly (E_loc = E // ep) inside the pod.
        if ep > n:
            raise ValueError(f"ep({ep}) exceeds pod n_gpus({n})")
        if cfg.n_experts % ep:
            raise ValueError(
                f"ep({ep}) does not divide n_experts({cfg.n_experts})")
    tp = pod.tp
    dp = pod.dp
    # TP activation collectives are latency-bound and fire twice per
    # sublayer: map them onto the largest all-pairs-tier-0 group (the whole
    # pod on the flat default — unchanged — one leaf / one pod on
    # hierarchical topologies).  EP keeps its expert-divisibility group and
    # may span tiers: the MoE a2a is exactly the cross-tier traffic.
    tier0 = get_topology(pod_fabric(pod)).tier0_group()
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


def _layer_is_moe(cfg: "ModelConfig", i: int) -> bool:
    return cfg.n_experts > 0 and i % cfg.moe_every == cfg.moe_every - 1


def _attn_params(cfg: "ModelConfig") -> int:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return d * h * dh * 2 + d * kv * dh * 2      # q,o + k,v projections


def _ffn_params(cfg: "ModelConfig", i: int, active: bool) -> int:
    if _layer_is_moe(cfg, i):
        experts = cfg.top_k if active else cfg.n_experts
        return (3 * cfg.d_model * cfg.d_ff_expert * experts
                + cfg.d_model * cfg.n_experts)   # experts + router
    return 3 * cfg.d_model * cfg.d_ff if cfg.d_ff > 0 else 0


def layer_param_bytes(cfg: "ModelConfig", i: int, grad_bytes: int) -> int:
    """Total parameter bytes of layer ``i`` (full experts, for grad sync)."""
    return (_attn_params(cfg) + _ffn_params(cfg, i, active=False)) * grad_bytes


def moe_a2a_bytes(cfg: "ModelConfig", tokens_local: int, ep: int,
                  dtype_bytes: int) -> int:
    """Per-GPU bytes of one EP dispatch/combine all-to-all.

    The ``nbytes`` of the send buffer ``[ep, C, d_model]`` that
    ``repro_torch.models.moe.ep_dispatch`` builds, ``C = _capacity(T_loc)
    * E_loc`` with ``_capacity = max(8, T_loc * top_k * capacity_factor
    / E)``: the all-to-all size the simulator prices.
    """
    e_loc = cfg.n_experts // ep
    cap = max(8, int(tokens_local * cfg.top_k * cfg.capacity_factor
                     / cfg.n_experts))
    return ep * cap * e_loc * cfg.d_model * dtype_bytes


def kv_transfer_fabric(pod: PodSpec) -> FabricConfig:
    """The prefill→decode pair fabric one KV handoff is priced on.

    Two ``pod.n_gpus``-GPU pods joined over the ``multi_pod`` scale-out hop
    (pod 0 = prefill ranks, pod 1 = decode ranks), so every transfer flow
    crosses the oversubscribed inter-pod tier and pays reverse translation
    at the decode pod's Link-MMU (DESIGN.md §16).  The pods' internal
    topology is irrelevant here — the ``kv_transfer`` patterns emit only
    cross-pod flows — so the pair fabric is always ``multi_pod`` regardless
    of ``pod.topology``.
    """
    return FabricConfig(n_gpus=2 * pod.n_gpus, topology="multi_pod",
                        pod_size=pod.n_gpus)


def kv_shard_bytes(cfg: "ModelConfig", prompt_tokens: int,
                   pod: PodSpec) -> int:
    """Per-GPU KV shard of one request's handoff (pattern ``nbytes``).

    The prompt's full KV cache — ``kv_bytes_per_token * prompt_tokens`` —
    is sharded across the prefill pod's GPUs, so each of the ``pod.n_gpus``
    transfer pairs moves the ceiling share.  This is the per-GPU buffer
    size :class:`~repro_torch.core.patterns.KVTransfer` expects.
    """
    total = cfg.kv_bytes_per_token(pod.dtype_bytes) * prompt_tokens
    return max(1, -(-total // pod.n_gpus))


def derive_kv_transfer(cfg: "ModelConfig", prompt_tokens: int, pod: PodSpec,
                       *, policy=None, state: str = "cold",
                       label: str = "kv_transfer",
                       step: int = 0) -> CollectiveCall:
    """The KV-cache handoff of one prefilled request as a CollectiveCall.

    Requested logically as ``"kv_transfer"`` and resolved by ``policy``
    (DESIGN.md §14) keyed on the decode arena's TLB ``state`` — so a table
    or auto policy can pick the striped re-shard variant where it wins,
    while the fixed default keeps the rail-aligned push.  ``group`` is the
    whole pair fabric (``2 * pod.n_gpus``).
    """
    fab = kv_transfer_fabric(pod)
    nbytes = kv_shard_bytes(cfg, prompt_tokens, pod)
    pol = get_policy(policy) or get_policy("fixed")
    res = pol.resolve("kv_transfer", nbytes, fab, state=state)
    return CollectiveCall(
        label=label, collective=res.collective, nbytes=nbytes,
        group=fab.n_gpus, compute_ns=0.0, buffer="kv_arena", step=step,
        logical=res.logical, resolved_by=res.provenance)


def _compute_ns(flops_per_gpu: float, pod: PodSpec) -> float:
    return flops_per_gpu / (pod.peak_tflops * 1e3 * pod.mfu)


def step_shape(spec, pod: PodSpec):
    """(t_step, n_microbatches, flop_mult) of one model step of ``spec``.

    Single source of truth shared by :func:`derive_workload` and the
    calibration harness (:mod:`repro_torch.workloads.calibrate`), so measured
    windows are anchored to exactly the rooflines derivation emits.
    """
    total_tokens = spec.global_batch * (1 if spec.kind == "decode"
                                        else spec.seq_len)
    if spec.kind == "decode":
        t_step, n_micro = spec.global_batch, 1
    else:
        t_step = min(pod.microbatch_tokens, total_tokens)
        n_micro = -(-total_tokens // t_step)
    return t_step, n_micro, (3.0 if spec.kind == "train" else 1.0)


def layer_roofline_ns(cfg: "ModelConfig", i: int, t_step: int,
                      pod: PodSpec, flop_mult: float):
    """Roofline (mixer_ns, ffn_ns) compute windows of layer ``i``."""
    mixer_ns = _compute_ns(
        flop_mult * 2.0 * _attn_params(cfg) * t_step / pod.tp, pod)
    is_moe = _layer_is_moe(cfg, i)
    ffn_ns = _compute_ns(
        flop_mult * 2.0 * _ffn_params(cfg, i, active=True)
        * t_step / (pod.ep if is_moe and pod.ep > 1 else pod.tp), pod)
    return mixer_ns, ffn_ns


# --------------------------------------------------------------------------
# Phase naming shared with the calibration harness (duck-typed configs
# default to attn).
# --------------------------------------------------------------------------
def layer_kind(cfg, i: int) -> str:
    pattern = getattr(cfg, "layer_pattern", ()) or ("attn",)
    return pattern[i % len(pattern)]


def mixer_phase(cfg, i: int) -> str:
    return "attn_mixer" if layer_kind(cfg, i) == "attn" else "ssm_mixer"


def ffn_phase(cfg, i: int) -> str:
    return "moe_ffn" if _layer_is_moe(cfg, i) else "dense_ffn"


class StepEmitter:
    """Emits the per-layer collective sequence of model steps.

    Single source of truth for the per-layer emission loop, shared by
    :func:`derive_workload` (fixed ``t_step`` per shape spec) and a
    serving layer, where each step's ``t_step`` is the *live* batch
    composition — decode tokens plus admitted prefill
    chunk — so collective sizes track continuous batching step by step.

    Compute windows accumulate between emitted collectives: when a sublayer
    emits no traffic (e.g. ``tp == 1``), its window still ages the session
    and is delivered as the next call's gap.  ``_pending_parts`` records the
    ``(phase, ns)`` decomposition of the carried amount so the gap stays
    re-resolvable against a compute profile at replay time.  The pending
    state persists across :meth:`step` calls, exactly as a session clock
    would.

    Collectives are requested *logically* ("allreduce", "all_to_all", ...)
    and resolved to a concrete algorithm by ``policy`` (an
    :class:`~repro_torch.core.select.AlgorithmPolicy` or spec string; default
    fixed — bit-for-bit the historical hard-coded choices).  Resolution is
    keyed on the logical buffer's TLB state: the first emission on a buffer
    since the last :meth:`mark_cold` resolves as cold, repeats as warm —
    the serving layer calls :meth:`mark_cold` whenever an idle gap crosses
    the retention window, so post-flush steps re-select cold-optimal
    algorithms.
    """

    def __init__(self, cfg: "ModelConfig", pod: PodSpec, window=None,
                 policy=None):
        self.cfg = cfg
        self.pod = pod
        # window(phase, roofline_ns) -> ns: profile resolution hook.
        self.window = window if window is not None else (lambda ph, ns: ns)
        self.policy = get_policy(policy) or get_policy("fixed")
        self._fab = pod_fabric(pod)
        self._warm_buffers: set = set()
        self.calls: List[CollectiveCall] = []
        self._mixer_phase = mixer_phase
        self._ffn_phase = ffn_phase
        self._pending_ns = 0.0
        self._pending_parts: List[tuple] = []

    def mark_cold(self) -> None:
        """Forget buffer warmth (the emitter-side mirror of a TLB flush)."""
        self._warm_buffers.clear()

    def emit(self, label, collective, nbytes, group, compute_ns, buffer,
             step, phase="", stride=1):
        fab_g = (self._fab if group == self._fab.n_gpus
                 else dataclasses.replace(self._fab, n_gpus=group))
        res = self.policy.resolve(
            collective, nbytes, fab_g,
            state="warm" if buffer in self._warm_buffers else "cold")
        self._warm_buffers.add(buffer)
        parts = list(self._pending_parts)
        if compute_ns or phase:
            parts.append((phase, compute_ns))
        # A carried window mixes sublayer provenances: drop the single-phase
        # tag (window_parts keeps the exact decomposition).
        if self._pending_ns:
            phase = ""
        self.calls.append(CollectiveCall(
            label, res.collective, nbytes, group,
            compute_ns=compute_ns + self._pending_ns, buffer=buffer,
            step=step, phase=phase, window_parts=tuple(parts),
            stride=stride, logical=res.logical,
            resolved_by=res.provenance))
        self._pending_ns = 0.0
        self._pending_parts = []

    def carry(self, phase: str, compute_ns: float) -> None:
        """Accumulate a window that emits no traffic of its own."""
        self._pending_ns += compute_ns
        self._pending_parts.append((phase, compute_ns))

    def step(self, step: int, t_step: int, *, flop_mult: float = 1.0,
             prefix: Optional[str] = None) -> None:
        """Emit one model step (every layer) over ``t_step`` active tokens.

        ``prefix`` overrides the default ``s{step}`` label prefix (serving
        labels steps by request batch instead).
        """
        cfg, pod = self.cfg, self.pod
        ep, tp = pod.ep, pod.tp
        prefix = f"s{step}" if prefix is None else prefix
        per_layer = pod.buffer_reuse == "per_layer"
        actv_bytes = t_step * cfg.d_model * pod.dtype_bytes
        t_loc = max(1, t_step // ep)
        a2a = (moe_a2a_bytes(cfg, t_loc, ep, pod.dtype_bytes)
               if cfg.n_experts and ep > 1 else 0)
        for i in range(cfg.n_layers):
            tag = f"{prefix}/L{i}"
            suffix = f"_l{i}" if per_layer else ""
            mp, fp = self._mixer_phase(cfg, i), self._ffn_phase(cfg, i)
            roof_mixer, roof_ffn = layer_roofline_ns(cfg, i, t_step, pod,
                                                     flop_mult)
            attn_ns = self.window(mp, roof_mixer)
            is_moe = _layer_is_moe(cfg, i)
            ffn_ns = self.window(fp, roof_ffn)
            # Mixer sublayer (attention or SSM): sequence-parallel TP pair,
            # ag -> mixer compute -> rs (the compute window sits between the
            # pair, so it is the rs that finds aged TLBs under retention).
            if tp > 1:
                self.emit(f"{tag}/mixer_ag", "all_gather", actv_bytes, tp,
                          0.0, "actv" + suffix, step)
                self.emit(f"{tag}/mixer_rs", "reduce_scatter", actv_bytes,
                          tp, attn_ns, "actv" + suffix, step, phase=mp)
            else:
                self.carry(mp, attn_ns)
            # FFN sublayer: EP all-to-all pair for MoE layers (dispatch ->
            # expert compute -> combine); MoE without an EP group (ep == 1,
            # all experts local) and dense FFNs shard over TP instead.
            if is_moe and a2a > 0:
                self.emit(f"{tag}/moe_dispatch", "all_to_all", a2a, ep,
                          0.0, "moe_disp" + suffix, step)
                self.emit(f"{tag}/moe_combine", "all_to_all", a2a, ep,
                          ffn_ns, "moe_comb" + suffix, step, phase=fp)
            elif tp > 1 and (cfg.d_ff > 0 or is_moe):
                self.emit(f"{tag}/ffn_ag", "all_gather", actv_bytes, tp,
                          0.0, "actv" + suffix, step)
                self.emit(f"{tag}/ffn_rs", "reduce_scatter", actv_bytes, tp,
                          ffn_ns, "actv" + suffix, step, phase=fp)
            else:
                self.carry(fp, ffn_ns)


def derive_workload(arch, shape: str, *, pod: Optional[PodSpec] = None,
                    n_gpus: Optional[int] = None,
                    n_steps: int = 1,
                    compute_profile=None,
                    policy=None) -> WorkloadTrace:
    """Derive the collective sequence of ``n_steps`` model steps.

    ``arch`` is a registry name (``"qwen3-moe-235b-a22b"``) or a
    ``ModelConfig``; ``shape`` names a
    :data:`repro_torch.configs.shapes.SHAPES` entry.  One *step* is one
    decoded token position (``decode``) or one microbatch forward/train
    pass (``prefill``/``train``); successive steps repeat the same
    per-layer sequence on the same buffers, which is what a persistent-TLB
    replay turns into a warm-vs-cold trajectory.

    ``compute_profile`` (a :class:`~repro_torch.workloads.calibrate.
    ComputeProfile` for this exact ``(arch, shape, pod)``) replaces the
    roofline compute windows with the profile's measured-and-calibrated
    per-phase windows; ``None`` (the default) keeps the roofline
    bit-for-bit.

    ``policy`` selects the concrete algorithm per logically-requested
    collective (:mod:`repro_torch.core.select`); ``None``/``"fixed"``
    reproduces the historical hard-coded choices bit-for-bit, and each emitted
    :class:`CollectiveCall` records the logical name plus the resolving
    decision (``logical``/``resolved_by``).
    """
    if isinstance(arch, str):
        from ..configs import get_config            # torch-free registry
        cfg = get_config(arch)
    else:
        cfg = arch
    from ..configs.shapes import SHAPES             # pure-python
    spec = SHAPES[shape]

    pod = pod or PodSpec()
    if n_gpus is not None:
        pod = dataclasses.replace(pod, n_gpus=n_gpus)
    pod = resolve_pod(pod, cfg, spec.kind)
    ep, tp, dp = pod.ep, pod.tp, pod.dp

    if compute_profile is not None and not compute_profile.matches(
            cfg.name, shape, pod.n_gpus, ep, tp, dp):
        raise ValueError(
            f"compute profile ({compute_profile.arch}/{compute_profile.shape}"
            f"/g{compute_profile.n_gpus} ep={compute_profile.ep} "
            f"tp={compute_profile.tp} dp={compute_profile.dp}) does not "
            f"match workload ({cfg.name}/{shape}/g{pod.n_gpus} ep={ep} "
            f"tp={tp} dp={dp})")

    def window(phase: str, roofline_ns: float) -> float:
        if compute_profile is not None:
            w = compute_profile.window_ns(phase)
            if w is not None:
                return w
        return roofline_ns

    t_step, n_micro, flop_mult = step_shape(spec, pod)

    trace = WorkloadTrace(arch=cfg.name, shape=shape, pod=pod,
                          tokens_per_step=t_step, n_microbatches=n_micro)
    em = StepEmitter(cfg, pod, window=window, policy=policy)
    trace.calls = em.calls
    for step in range(n_steps):
        em.step(step, t_step, flop_mult=flop_mult)
        # Train: bucketed gradient sync, one ring all-reduce per layer over
        # the DP group.  Distinct buffer per layer: gradient regions are as
        # large as the weights and never share pages with activations.
        # DP replicas sit one per TP island (ranks p, p+tp, p+2*tp, ...),
        # so on hierarchical topologies the ring is strided across tiers —
        # gradient sync is cross-tier traffic.  On the flat default the
        # stride is immaterial (any rank labeling is isomorphic) and is
        # kept at 1, bit-for-bit the pre-topology trace.
        if spec.kind == "train" and dp > 1:
            grad_stride = tp if pod.topology != "single_clos" else 1
            for i in range(cfg.n_layers):
                nb = max(1, layer_param_bytes(cfg, i, pod.grad_bytes) // tp)
                em.emit(f"s{step}/L{i}/grad_ar", "allreduce", nb, dp,
                        0.0, f"grad_l{i}", step, stride=grad_stride)
    return trace
