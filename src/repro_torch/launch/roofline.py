"""Roofline terms of one rank's step on an H100 (counterpart of
``repro.launch.roofline``), and the :class:`Counter` that sums them.

Three terms per (arch x shape x mesh), seconds a step:

    compute    = sum over dtypes of FLOPs / PEAK_FLOPS[dtype]
    memory     = HBM bytes / HBM_BW
    collective = collective bytes / LINK_BW

The reference reads them from compiled HLO.  The port is eager, so a
:class:`Counter` counts what a step does while it runs, on the card or
on the meta device (``launch.dryrun``):

- **FLOPs**: the matmul-class aten ops (``torch.utils.flop_counter``'s
  registry: mm, addmm, bmm, baddbmm, convolutions, SDPA) plus each kernel
  launch's formula below; no elementwise op counts.  The reference's
  ``hlo_analysis`` counts 1 FLOP an element of elementwise ops too, so the
  two conventions differ by those.
- **HBM bytes**: the operand and output bytes of each aten op, view and
  allocation ops excluded (the eager analogue of ``hlo_analysis``'s
  per-top-level-op traffic), plus each kernel launch's formula.
- **Kernel records**: each launch of a ``kernels.ops`` entry, by name:
  launches, FLOPs, bytes (and the rows a grouped matmul's offsets cover),
  whichever route ran it.  The aten ops inside a kernel's wrapper, and
  the plain version's on the CPU, are not counted.
- **Collectives** by kind and by mesh axis, count and bytes, by the
  reference dry-run's convention (``repro/launch/hlo_analysis.py``): a
  collective's output bytes for one rank, an all-reduce counted twice.
- **Peak memory**: the most bytes of live tensor storage at once, those
  the counter was told the step holds (``hold``) and every storage an op
  made since, each freed when its storage dies.  The plain version of a
  kernel counts its outputs alone, as the kernel allocates them.

The H100 SXM peaks are NVIDIA's data sheet's (H100 Tensor Core GPU, dense,
no sparsity, at the 700 W limit).  The kernels' cost formulas count each
input read once and each output written once; ``chip_smoke.py``'s bounds
and ``PERF.md``'s kernel table read them.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 Tensor Core GPU datasheet, SXM, dense: tensor-core bf16, and
# f32 outside the tensor cores
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12             # bytes/s, HBM3
LINK_BW = 450e9              # bytes/s one way: NVLink 4, 900 GB/s both ways
# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 (chip_smoke.py phase (a) prints it)
HBM_BYTES = 85_017_493_504


# ----------------------------------------------------------- model FLOPs
def model_flops_train(n_active_params: int, tokens: int) -> float:
    """6*N*D forward+backward useful FLOPs."""
    return 6.0 * n_active_params * tokens


def model_flops_decode(n_active_params: int, tokens: int) -> float:
    """2*N per generated token (forward only)."""
    return 2.0 * n_active_params * tokens


# ------------------------------------------------------ kernel formulas
# Each returns (bytes, flops) of the kernel's function: every input read
# once and every output written once.

def bound_ms(nbytes: float, flops: float, dtype: str) -> Tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it:
    bytes over HBM_BW or operations over the dtype's peak."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rmsnorm_cost(T: int, D: int, es: int):
    """x read and y written in x's dtype, w in f32; 4 flops an element."""
    return 2 * T * D * es + 4 * D, 4 * T * D


def rmsnorm_bwd_cost(T: int, D: int, es: int):
    """x and dy read, dx written; w read and dw written in f32."""
    return 3 * T * D * es + 8 * D, 10 * T * D


def rmsnorm_part_cost(T: int, D: int, es: int):
    """x read, a row's f32 sum written; 2 flops an element."""
    return T * D * es + 4 * T, 2 * T * D


def rmsnorm_scale_cost(T: int, D: int, es: int):
    """x and the rows' sums read, y written; w in f32; 2 flops an
    element."""
    return 2 * T * D * es + 4 * T + 4 * D, 2 * T * D


def rmsnorm_bwd_part_cost(T: int, D: int, es: int):
    """x and dy read, w in f32, the rows' two f32 sums written; 5 flops an
    element."""
    return 2 * T * D * es + 4 * D + 8 * T, 5 * T * D


def rmsnorm_bwd_scale_cost(T: int, D: int, es: int):
    """x, dy and the rows' sums read, dx written; w read and dw written in
    f32; 7 flops an element."""
    return 3 * T * D * es + 8 * T + 8 * D, 7 * T * D


def attention_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the mask keeps: the causal band only."""
    if not causal:
        return Sq * Sk
    w = window if window > 0 else Sq
    # sum over i < Sq of min(i + 1, w)
    n = min(w, Sq)
    return n * (n + 1) // 2 + (Sq - n) * w


def attention_cost(B, Sq, Sk, H, KV, Dh, causal, window, es):
    """q, k, v read, out written; 4 Dh flops a kept pair, per head."""
    return ((2 * B * Sq * H * Dh + 2 * B * Sk * KV * Dh) * es,
            4 * B * H * Dh * attention_pairs(Sq, Sk, causal, window))


def attention_bwd_cost(B, Sq, Sk, H, KV, Dh, causal, window, es):
    """q, o, dO read and dq written at H heads, k, v read and dk, dv
    written at KV heads, the f32 LSE read; 10 Dh flops a kept pair."""
    return ((4 * B * Sq * H * Dh + 4 * B * Sk * KV * Dh) * es
            + 4 * B * H * Sq,
            10 * B * H * Dh * attention_pairs(Sq, Sk, causal, window))


def gmm_cost(T, K, N, E, rows, used, es):
    """lhs [T,K] x rhs [E,K,N] -> [T,N] (the forward, and dX with K = F,
    N = D): the ``rows`` its offsets cover read, the weights of the
    ``used`` experts (those with rows) read, every output row written (the
    kernel zero-fills the rows no group covers), the int32 offsets read."""
    return ((rows * K + used * K * N + T * N) * es + 4 * (E + 1),
            2 * rows * K * N)


def gmm_dw_cost(D, F, E, rows, es):
    """dW [E,D,F] = X^T dY over the covered rows: X and dY rows read,
    every expert's dW written."""
    return ((rows * D + rows * F + E * D * F) * es + 4 * (E + 1),
            2 * rows * D * F)


def ssd_cost(BC: int, Q: int, H: int, P: int, N: int):
    """f32 operands read once and outputs written once; C.B^T once a
    (batch, chunk) cell (the same for every head), and only for k <= q,
    as are the y terms."""
    pairs = Q * (Q + 1) // 2
    nbytes = 4 * (2 * BC * Q * H * P + 2 * BC * Q * H + 2 * BC * Q * N
                  + BC * H * P * N)
    flops = 2 * BC * pairs * N + 2 * BC * H * (pairs * P + Q * P * N)
    return nbytes, flops


def ssd_bwd_cost(BC: int, Q: int, H: int, P: int, N: int, *,
                 dy: bool = True, ds: bool = True):
    """The backward kernel (csrc/ssd_chunk.cu, ``ssd_chunk_bwd_launch``):
    x, dt, a, B, C and the gradients given (``dy``, ``ds``) read once, dx,
    ddt, da, dB and dC written once, all f32.  FLOPs are 2 a multiply-add
    of its contractions, over k <= q only, with ``pairs = Q (Q+1) / 2`` a
    cell:

    * with dy: C.B^T once a cell (pairs N), then a head dM = dy x^T
      (pairs P) and M^T dy into dx (pairs P); dC = dCB B and dB += dCB^T C
      (pairs N each);
    * with ds: a head dsB = ds B^T into dx (Q P N) and dw = x . dsB
      (Q P); the state's part of dB, sum_h w x^T ds (Q P N).

    The elementwise work (L, G, the row and column sums, the cumsums)
    counts nothing, as in :func:`ssd_cost`.
    """
    pairs = Q * (Q + 1) // 2
    cells = BC * Q * H
    operands = cells * P + 2 * cells + 2 * BC * Q * N    # x, dt, a, B, C
    nbytes = 4 * 2 * operands                            # and their grads
    macs = 0
    if dy:
        nbytes += 4 * cells * P
        macs += pairs * N + 2 * H * pairs * P + 2 * pairs * N
    if ds:
        nbytes += 4 * BC * H * P * N
        macs += H * (2 * Q * P * N + Q * P)
    return nbytes, 2 * BC * macs


# ------------------------------------------------------------- the terms
@dataclass
class RooflineTerms:
    flops: float                 # per device
    hbm_bytes: float             # per device
    coll_bytes: int              # per device (sum over kinds)
    coll_by_kind: Dict[str, int] = field(default_factory=dict)
    peak_memory_bytes: Optional[float] = None
    flops_by_dtype: Dict[str, float] = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        # a dtype with no peak of its own (none on the steps' paths) is
        # priced at f32's, off the tensor cores
        return sum(f / PEAK_FLOPS.get(d, PEAK_FLOPS["float32"])
                   for d, f in self.flops_by_dtype.items())

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "coll_bytes_per_device": self.coll_bytes,
            "coll_by_kind": self.coll_by_kind,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "peak_memory_bytes": self.peak_memory_bytes,
        }


# ------------------------------------------------------------ the counter
# The counter in effect, if any: ``kernels.ops``, ``parallel.fsdp``,
# ``parallel.tp`` and ``core.overlap`` test this one name before counting
ACTIVE: Optional["Counter"] = None

# aten ops that move no bytes: allocation and metadata
_NO_TRAFFIC = {"empty", "empty_like", "new_empty", "empty_strided",
               "new_empty_strided", "lift_fresh", "sym_size", "sym_stride",
               "sym_numel", "sym_storage_offset", "is_contiguous",
               "_local_scalar_dense", "set_", "resize_"}


def tensors(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class Counter:
    """Sums one rank's work while it is active (``with Counter() as c``).

    ``only_device``: a device type ("meta" for the dry-run); an op that
    makes a tensor on any other device raises.  One counter at a time.
    """

    def __init__(self, only_device: Optional[str] = None):
        self.only_device = only_device
        self.aten_flops = 0
        self.aten_bytes = 0
        self.flops_by_dtype: Dict[str, float] = {}
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.collectives: Dict[str, Dict[str, int]] = {}
        self.axis_collectives: Dict[str, Dict[str, Dict[str, int]]] = {}
        # tag -> axis -> kind -> count and bytes (a cache's gathers: "cache")
        self.tagged: Dict[str, Dict[str, Dict[str, Dict[str, int]]]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, weakref.finalize] = {}
        self._quiet = 0          # > 0: aten ops count no FLOPs or bytes
        self._untracked = 0      # > 0: new storages are not tracked
        self._mode = None

    # ------------------------------------------------------ the context
    def __enter__(self) -> "Counter":
        global ACTIVE
        if ACTIVE is not None:
            raise RuntimeError("a Counter is already active")
        from torch.utils.flop_counter import flop_registry
        self._mode = _Mode(self, flop_registry)
        self._mode.__enter__()
        ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global ACTIVE
        ACTIVE = None
        self._mode.__exit__(*exc)
        self._mode = None

    def hold(self, *trees) -> None:
        """Count the storages of ``trees``' tensors as live (a step's
        inputs: params, optimizer state, batch, caches)."""
        for t in tensors(trees):
            self.track(t)

    # ------------------------------------------------------- recording
    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it dies."""
        st = t.untyped_storage()
        nb = st.nbytes()
        # an empty tensor holds nothing (torch.utils.checkpoint makes one
        # on the CPU)
        if nb and self.only_device is not None and \
                t.device.type != self.only_device:
            raise RuntimeError(f"Counter(only_device={self.only_device!r}):"
                               f" a tensor on {t.device} in the step")
        key = id(st)
        if key in self._live:
            return
        self.live_bytes += nb
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        self._live[key] = weakref.finalize(st, self._free, key, nb)

    def _free(self, key: int, nb: int) -> None:
        self.live_bytes -= nb
        self._live.pop(key, None)

    def _add_flops(self, dtype: str, flops: float) -> None:
        self.flops_by_dtype[dtype] = self.flops_by_dtype.get(dtype, 0) + flops

    def kernel(self, name: str, nbytes: int, flops: int, dtype: str,
               rows: Optional[int] = None) -> None:
        """One launch of kernel ``name`` doing ``flops`` over ``nbytes``
        (its formula); ``rows``: a grouped matmul's covered rows."""
        rec = self.kernels.setdefault(
            name, {"launches": 0, "flops": 0, "bytes": 0})
        rec["launches"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes
        if rows is not None:
            rec["rows"] = rec.get("rows", 0) + rows
        self._add_flops(dtype, flops)

    def collective(self, kind: str, axis: Optional[str], nbytes: int,
                   tag: Optional[str] = None) -> None:
        """One collective of ``kind`` (``all_gather``, ``all_reduce``,
        ``reduce_scatter``, ``all_to_all``) over ``axis`` (None: the
        world) whose output on this rank is ``nbytes``; an all-reduce
        counts twice its bytes.  With ``tag`` it counts in ``tagged``
        too."""
        kind = kind.replace("_", "-")
        nbytes *= 2 if kind == "all-reduce" else 1
        axis = axis or "world"
        recs = [self.collectives.setdefault(kind, {"count": 0, "bytes": 0}),
                self.axis_collectives.setdefault(axis, {}).setdefault(
                    kind, {"count": 0, "bytes": 0})]
        if tag is not None:
            recs.append(self.tagged.setdefault(tag, {}).setdefault(
                axis, {}).setdefault(kind, {"count": 0, "bytes": 0}))
        for rec in recs:
            rec["count"] += 1
            rec["bytes"] += nbytes

    def _aten(self, func, args, kwargs, out) -> None:
        if func.is_view or func._overloadpacket.__name__ in _NO_TRAFFIC:
            return
        ins = tensors((args, kwargs))
        self.aten_bytes += sum(_nbytes(t) for t in ins)
        self.aten_bytes += sum(_nbytes(t) for t in tensors(out))
        count = self._mode.flop_registry.get(func._overloadpacket)
        if count is not None:
            flops = count(*args, **kwargs, out_val=out)
            self.aten_flops += flops
            self._add_flops(dtype_name(ins[0].dtype), flops)

    # ------------------------------------------------------------ totals
    def terms(self) -> RooflineTerms:
        kflops = sum(r["flops"] for r in self.kernels.values())
        kbytes = sum(r["bytes"] for r in self.kernels.values())
        by_kind = {k: r["bytes"] for k, r in self.collectives.items()}
        return RooflineTerms(
            flops=self.aten_flops + kflops,
            hbm_bytes=self.aten_bytes + kbytes,
            coll_bytes=sum(by_kind.values()), coll_by_kind=by_kind,
            peak_memory_bytes=self.peak_bytes,
            flops_by_dtype=dict(self.flops_by_dtype))

    def as_dict(self) -> Dict:
        """What was counted, as JSON."""
        return {"aten_flops": self.aten_flops, "aten_bytes": self.aten_bytes,
                "flops_by_dtype": dict(self.flops_by_dtype),
                "kernels": {k: dict(v) for k, v in
                            sorted(self.kernels.items())},
                "collectives": {k: dict(v) for k, v in
                                sorted(self.collectives.items())},
                "axis_collectives": {
                    a: {k: dict(v) for k, v in sorted(kinds.items())}
                    for a, kinds in sorted(self.axis_collectives.items())},
                "tagged": {
                    t: {a: {k: dict(v) for k, v in sorted(kinds.items())}
                        for a, kinds in sorted(axes.items())}
                    for t, axes in sorted(self.tagged.items())},
                "peak_bytes": self.peak_bytes}


@contextlib.contextmanager
def quiet(untracked: bool = False):
    """Inside a kernel's wrapper: the active counter's aten ops count no
    FLOPs or bytes; with ``untracked``, their new storages are not tracked
    either (the plain version's temporaries, which the kernel does not
    allocate).  A no-op without a counter."""
    c = ACTIVE
    if c is None:
        yield
        return
    c._quiet += 1
    c._untracked += untracked
    try:
        yield
    finally:
        c._quiet -= 1
        c._untracked -= untracked


class _Mode(TorchDispatchMode):
    """The dispatch mode under a :class:`Counter`: every aten op's FLOPs
    and bytes, and every new storage."""

    def __init__(self, counter: Counter, flop_registry):
        super().__init__()
        self.counter = counter
        self.flop_registry = flop_registry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.counter
        if func.namespace == "aten":
            if not c._quiet:
                c._aten(func, args, kwargs, out)
            if not c._untracked:
                for t in tensors(out):
                    c.track(t)
        return out
