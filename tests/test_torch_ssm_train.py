"""The SSD backward on the CPU: ``ref.ssd_chunk_bwd_ref``, its f64 bound and
the port's autograd route against ``jax.vjp`` of the JAX package's plain
``repro.kernels.ref.ssd_chunk_ref``; and mamba2's smoke Trainer through
that route against ``repro.runtime.Trainer``.

The same seeded numpy inputs go to both.  Tolerance: 1e-4 of each
gradient's max |ref| (the SSD tests' tolerance; the JAX reference sums
a_cum in f32, the port in f64).  ``ops.ssd_chunk`` takes the
``autograd.Function`` route (forward kernel, backward kernel) on the card,
and on CPU tensors under a ``launch.roofline.Counter``, where each kernel
runs its plain version; without a counter autograd follows the plain
forward.  The CUDA kernel itself is held to the plain version on the card
(``tests/test_torch_kernels.py``, ``cuda`` marker, and ``chip_smoke.py``).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.base import set_logical_rules  # noqa: E402
from repro.runtime import Trainer as JTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.models.spec import ModelConfig  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402
from repro_torch.weights import flatten, from_jax_params  # noqa: E402

TOL = 1e-4
NAMES = ("dx", "ddt", "da", "dB", "dC")


@pytest.fixture(autouse=True)
def _no_logical_rules():
    # xdist workers share a process across test files; an earlier test may
    # have installed mesh rules (base.py: set_logical_rules is global).
    set_logical_rules(None)
    yield
    set_logical_rules(None)


def _flat_inputs(G, Q, P, N, seed):
    """The intra-chunk test's distributions (a <= 0, dt > 0) in the JAX
    layout, and the gradients of y and of the state."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, Q, P), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((G, Q)))).astype(np.float32)
    a = -np.abs(rng.standard_normal((G, Q))).astype(np.float32)
    B = rng.standard_normal((G, Q, N)).astype(np.float32)
    C = rng.standard_normal((G, Q, N)).astype(np.float32)
    dy = rng.standard_normal((G, Q, P)).astype(np.float32)
    ds = rng.standard_normal((G, P, N)).astype(np.float32)
    return (x, dt, a, B, C), (dy, ds)


def _model_inputs(BC, Q, H, P, N, seed):
    """mamba2's distributions (chip_smoke.ssd_inputs) in the model's
    layout, and the gradients of y and of the state, as tensors."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BC, Q, H, P), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((BC, Q, H)))).astype(np.float32)
    a = (-dt * np.exp(0.1 * rng.standard_normal(H))).astype(np.float32)
    B = rng.standard_normal((BC, Q, N)).astype(np.float32)
    C = rng.standard_normal((BC, Q, N)).astype(np.float32)
    dy = rng.standard_normal((BC, Q, H, P)).astype(np.float32)
    ds = rng.standard_normal((BC, H, P, N)).astype(np.float32)
    return [torch.from_numpy(t) for t in (x, dt, a, B, C, dy, ds)]


def _jax_grads(args, dy, ds):
    """jax.vjp of the JAX package's plain ssd_chunk_ref; an absent (None)
    gradient is a zero cotangent."""
    (y, s), vjp = jax.vjp(jref.ssd_chunk_ref, *map(jnp.asarray, args))
    dy = jnp.zeros_like(y) if dy is None else jnp.asarray(dy)
    ds = jnp.zeros_like(s) if ds is None else jnp.asarray(ds)
    return [np.asarray(g) for g in vjp((dy, ds))]


def _close(got, want, tol=TOL):
    for name, g, w in zip(NAMES, got, want):
        g = g.detach().numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol * scale, name


def _autograd(args, dy, ds, counter: bool):
    """The gradients through ops.ssd_chunk: the Function route under a
    counter (with its records), the plain forward's autograd without."""
    leaves = [torch.from_numpy(t).requires_grad_() for t in args]
    outs, grads = [], []
    with rl.Counter() if counter else _null() as c:
        y, s = ops.ssd_chunk(*leaves)
        for out, g in ((y, dy), (s, ds)):
            if g is not None:
                outs.append(out)
                grads.append(torch.from_numpy(g))
        got = torch.autograd.grad(outs, leaves, grads)
    return got, (c.kernels if counter else None)


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


# ------------------------------------------------------- against jax.vjp
@pytest.mark.parametrize("G,Q,P,N", [
    (6, 32, 16, 24),        # test_kernels.test_ssd_intra_chunk_kernel_vs_ref
    (4, 64, 16, 16),
    (3, 13, 8, 16),         # odd Q
    (2, 1, 8, 16),          # one step
    (2, 100, 30, 18),       # Q past one 64-row tile, P and N off 4
])
def test_ssd_chunk_bwd_matches_jax_vjp(G, Q, P, N):
    args, (dy, ds) = _flat_inputs(G, Q, P, N, G * Q + P + N)
    want = _jax_grads(args, dy, ds)
    _close(ref.ssd_chunk_bwd_ref(*map(torch.from_numpy, (*args, dy, ds))),
           want)
    for counter in (False, True):
        got, records = _autograd(args, dy, ds, counter)
        _close(got, want)
    assert set(records) == {"ssd_chunk", "ssd_chunk_bwd"}
    assert all(r["launches"] == 1 for r in records.values())
    assert all(n == 0 for n in ops.LAUNCHES.values())


@pytest.mark.parametrize("absent", ["dy", "ds"])
def test_ssd_chunk_bwd_with_a_gradient_absent(absent):
    """An absent gradient counts as zero (ssm_layer with one chunk leaves
    the state unused): the plain version, the wrapper and the Function
    route against jax.vjp with a zero cotangent."""
    args, (dy, ds) = _flat_inputs(4, 40, 16, 24, 5)
    dy, ds = (None, ds) if absent == "dy" else (dy, None)
    want = _jax_grads(args, dy, ds)
    tens = [None if t is None else torch.from_numpy(t) for t in (dy, ds)]
    _close(ref.ssd_chunk_bwd_ref(*map(torch.from_numpy, args), *tens), want)
    _close(ops.ssd_chunk_bwd(*map(torch.from_numpy, args), *tens), want)
    got, records = _autograd(args, dy, ds, True)
    _close(got, want)
    assert records["ssd_chunk_bwd"]["launches"] == 1
    with_both = rl.ssd_bwd_cost(4, 40, 1, 16, 24)
    assert records["ssd_chunk_bwd"]["flops"] < with_both[1]
    assert records["ssd_chunk_bwd"]["bytes"] < with_both[0]


@pytest.mark.parametrize("dy,ds", [(True, True), (True, False),
                                   (False, True)])
def test_ssd_bwd_cost_moves_each_tensor_once(dy, ds):
    """``roofline.ssd_bwd_cost``'s bytes at mamba2's training shape are
    those of the f32 tensors the backward must move: x, dt, a, B, C and the
    gradients given read once, dx, ddt, da, dB and dC written once."""
    BC, Q, H, P, N = 16, 256, 48, 64, 128
    operands = [(BC, Q, H, P), (BC, Q, H), (BC, Q, H), (BC, Q, N),
                (BC, Q, N)]
    moved = operands * 2 + [(BC, Q, H, P)] * dy + [(BC, H, P, N)] * ds
    want = 4 * sum(math.prod(s) for s in moved)
    assert rl.ssd_bwd_cost(BC, Q, H, P, N, dy=dy, ds=ds)[0] == want
    if dy and ds:
        assert want == 187_695_104


def test_ssd_bwd_scratch_fits_its_budget():
    """The backward kernel's scratch at mamba2's training shape
    (x[16,256,48,64], N 128) stays within 64 MiB; one head more (49) opens
    one more dCB partial (a group of up to 12 heads) and one more state
    partial (a split of up to 16), each a cell's [Q, Q] and [Q, N]."""
    BC, Q, H, N = 16, 256, 48, 128
    floats = ops.ssd_bwd_scratch_floats(BC, Q, H, N)
    assert 4 * floats <= 64 * 2 ** 20
    tiles = Q // ops.SSD_TILE
    per_head = BC * (3 * Q + 4 * tiles * Q)
    grown = ops.ssd_bwd_scratch_floats(BC, Q, H + 1, N) - floats
    assert grown == per_head + BC * (Q * Q + Q * N)


def test_ssd_chunk_bwd_heads_layout_equals_broadcast_layout():
    """The model's layout (B and C shared by the H heads of a cell, so dB
    and dC sum the heads) gives what the JAX layout gives with B and C
    broadcast per head, its dB and dC summed over the heads."""
    BC, Q, H, P, N = 3, 24, 4, 8, 16
    x, dt, a, B, C, dy, ds = _model_inputs(BC, Q, H, P, N, 11)
    got = ref.ssd_chunk_bwd_ref(x, dt, a, B, C, dy, ds)
    assert [tuple(g.shape) for g in got] == [
        (BC, Q, H, P), (BC, Q, H), (BC, Q, H), (BC, Q, N), (BC, Q, N)]

    def flat(t):                       # [BC, Q, H, ...] -> [BC*H, Q, ...]
        return t.movedim(2, 1).reshape(BC * H, Q, *t.shape[3:])

    def bcast(t):
        return t[:, None].expand(BC, H, Q, N).reshape(BC * H, Q, N)

    args = [flat(x), flat(dt), flat(a), bcast(B), bcast(C)]
    want = _jax_grads([t.numpy() for t in args], flat(dy).numpy(),
                      ds.reshape(BC * H, P, N).numpy())
    heads = [flat(got[0]), flat(got[1]), flat(got[2])]
    _close(heads + [got[3], got[4]],
           want[:3] + [w.reshape(BC, H, Q, N).sum(1) for w in want[3:]])
    fl = ref.ssd_chunk_bwd_ref(*args, flat(dy), ds.reshape(BC * H, P, N))
    for g, w in zip(heads, fl[:3]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_ssd_chunk_bwd_wrapper_rejects_bad_gradients():
    x, dt, a, B, C, dy, ds = _model_inputs(2, 8, 3, 4, 8, 1)
    with pytest.raises(ValueError, match="ssd_chunk_bwd: dy"):
        ref.ssd_chunk_bwd_ref(x, dt, a, B, C, dy[:, :4], ds)
    with pytest.raises(ValueError, match="ssd_chunk_bwd: ds"):
        ref.ssd_chunk_bwd_ref(x, dt, a, B, C, dy, ds[..., :4])


# ------------------------------------------------------------ f64 bound
@pytest.mark.parametrize("BC,Q,H,P,N,absent", [
    (1, 200, 2, 130, 300, None),
    (2, 256, 48, 64, 128, None),    # mamba2's chunk (2 of its 16 cells)
    (2, 256, 4, 64, 128, "ds"),
    (2, 100, 9, 30, 18, "dy"),      # dx is w dsB alone: exponents near -65
    (3, 1, 13, 64, 128, None),      # one step: da is 0
])
def test_ssd_chunk_bwd_f64_bound_holds_plain_f32(BC, Q, H, P, N, absent):
    """The f64 evaluation's bound is not below f32's own rounding: the
    plain f32 version meets it with room to spare."""
    x, dt, a, B, C, dy, ds = _model_inputs(BC, Q, H, P, N, Q + H)
    dy, ds = (None if absent == "dy" else dy, None if absent == "ds" else ds)
    vals, bounds = ref.ssd_chunk_bwd_f64(x, dt, a, B, C, dy, ds)
    got = ref.ssd_chunk_bwd_ref(x, dt, a, B, C, dy, ds)
    for name, g, v, b in zip(NAMES, got, vals, bounds):
        assert v.dtype == torch.float64 and v.shape == b.shape == g.shape
        ratio = float(((g.double() - v).abs() / b.clamp_min(1e-300)).max())
        assert ratio < 0.5, (name, ratio)


def test_ssd_chunk_bwd_f64_matches_jax_vjp():
    args, (dy, ds) = _flat_inputs(6, 32, 16, 24, 3)
    vals, _ = ref.ssd_chunk_bwd_f64(*map(torch.from_numpy, (*args, dy, ds)))
    _close(vals, _jax_grads(args, dy, ds))


def test_ssd_chunk_bwd_f64_bound_catches_a_missing_term():
    """A fault as small as one missing row of dy, or one missing row of
    ds, exceeds the bound in every output that row reaches: the plain
    version with the row zeroed against the f64 terms of the real inputs.
    da, whose terms cancel, is caught as well."""
    x, dt, a, B, C, dy, ds = _model_inputs(1, 200, 2, 130, 300, 7)
    vals, bounds = ref.ssd_chunk_bwd_f64(x, dt, a, B, C, dy, ds)
    got = ref.ssd_chunk_bwd_ref(x, dt, a, B, C, dy, ds)

    def over(outs):
        return {n for n, g, v, b in zip(NAMES, outs, vals, bounds)
                if bool(((g.double() - v).abs() > b).any())}

    assert over(got) == set()
    dy_cut = dy.clone()
    dy_cut[:, 100] = 0.0
    assert over(ref.ssd_chunk_bwd_ref(x, dt, a, B, C, dy_cut, ds)) == \
        set(NAMES)
    ds_cut = ds.clone()
    ds_cut[:, :, 5] = 0.0             # dC does not read ds
    assert over(ref.ssd_chunk_bwd_ref(x, dt, a, B, C, dy, ds_cut)) == \
        {"dx", "ddt", "da", "dB"}


# -------------------------------------------- mamba2 through the route
def test_mamba2_trainer_through_the_kernel_route_matches_reference():
    """The port's Trainer on mamba2's smoke config (f32, two 16-step chunks
    a sequence, so the state's gradient flows) with every kernel on the
    ``autograd.Function`` route (a counter active), against
    ``repro.runtime.Trainer(...)._step`` from the same weights on the same
    batches: three steps' losses within 1e-5 (test_torch_train.py's loss
    bound), and after the first step AdamW's moments, which hold the
    gradient and its square, within 1e-4 of their max (its gradient
    bound).  Not the master: Adam's first update ``lr g / (|g| + eps)``
    turns the rounding of gradients near eps into a tenth of a step on
    either route, past test_torch_train.py's 2% of a step."""
    jcfg = jconfigs.get_smoke_config("mamba2-780m").replace(dtype="float32")
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    tkw = dict(batch_size=2, seq_len=32, peak_lr=1e-2, warmup=1, seed=4,
               log_every=1)
    jt = JTrainer(jcfg, JTrainerConfig(steps=3, **tkw))
    jstate = jt.init_state()
    # with_master's f32 master is the params' own buffer, which the jitted
    # step would be given (and donate) twice: give it a copy
    jstate["opt"] = jax.tree.map(lambda t: jnp.array(t, copy=True),
                                 jstate["opt"])
    tp = from_jax_params(jax.tree.map(np.asarray, jstate["params"]))
    it = jdata.make_batch_iterator(jcfg, 2, 32, seed=4)
    jlosses, jopt = [], []
    params, opt, comp = jstate["params"], jstate["opt"], jstate["comp"]
    for _ in range(3):
        batch = {k: jnp.asarray(v) for k, v in next(it).items()}
        params, opt, comp, m = jt._step(params, opt, comp, batch)
        jlosses.append(float(m["loss"]))
        jopt.append(flatten(jax.tree.map(np.asarray, opt)))
    outs = []
    for steps in (1, 3):
        with rl.Counter() as counter:
            outs.append(Trainer(cfg, TrainerConfig(steps=steps, **tkw),
                                device="cpu").run(params=tp))
        launches = {k: r["launches"] for k, r in counter.kernels.items()}
        # a step: 2 layers, each its forward twice (remat) and its
        # backward once
        assert launches["ssd_chunk"] == steps * 2 * 2
        assert launches["ssd_chunk_bwd"] == steps * 2
    np.testing.assert_allclose([h["loss"] for h in outs[1]["history"]],
                               jlosses, rtol=1e-5)
    mine = flatten(outs[0]["state"]["opt"])
    moments = {p: w for p, w in jopt[0].items() if "/m/" in p or "/v/" in p}
    assert moments and set(mine) == set(jopt[0])
    for path, w in moments.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(mine[path].numpy() - w).max()) <= TOL * scale, \
            path


def test_kernel_wrappers_on_cpu_run_their_plain_versions():
    """With no counter, a kernel wrapper given CPU tensors returns its
    plain version (ssd_chunk_bwd, rmsnorm_bwd) and counts no launch."""
    x, dt, a, B, C, dy, ds = _model_inputs(2, 20, 3, 8, 16, 2)
    for g, w in zip(ops.ssd_chunk_bwd(x, dt, a, B, C, dy, ds),
                    ref.ssd_chunk_bwd_ref(x, dt, a, B, C, dy, ds)):
        assert torch.equal(g, w)
    xr, wr, gr = torch.randn(5, 8), torch.randn(8), torch.randn(5, 8)
    for g, w in zip(ops.rmsnorm_bwd(xr, wr, gr, 1e-6),
                    ref.rmsnorm_bwd_ref(xr, wr, gr, eps=1e-6)):
        assert torch.equal(g, w)
    assert all(n == 0 for n in ops.LAUNCHES.values())
