"""Port kernels: plain PyTorch versions against the JAX package's kernels.

On the CPU each ``repro_torch.kernels.ops`` wrapper runs its kernel's plain
version; the reference is ``repro.kernels.ops`` (Pallas in interpret mode
off-TPU).  The same numpy inputs, made from a seed, go to both.
Tolerances follow ``tests/test_kernels.py``: f32 2e-5, bf16 2e-2.  The
CUDA kernels themselves are held against the plain versions on the card
(``cuda`` marker here, and ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models.base import set_logical_rules  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402



@pytest.fixture(autouse=True)
def _no_logical_rules():
    # the windowed attention reference reads the global logical rules
    # (base.py: set_logical_rules), which xdist workers share across files
    set_logical_rules(None)
    yield
    set_logical_rules(None)


DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _both(a: np.ndarray, dtype: str):
    """One f32 numpy array -> (torch, jax) arrays of the same values."""
    tdt, jdt, _ = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


def _close(t_out, j_out, dtype: str):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out, np.float32),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------------ rmsnorm
@pytest.mark.parametrize("T,D", [(256, 64), (512, 1024), (256, 3072),
                                 (256, 1536),     # mamba2's d_model
                                 (256, 12288)])   # wider than the registers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax_kernel(T, D, dtype):
    rng = np.random.default_rng(T * D)
    x_t, x_j = _both(rng.standard_normal((T, D), np.float32), dtype)
    w_t, w_j = _both(rng.standard_normal((D,), np.float32), dtype)
    before = dict(ops.LAUNCHES)
    out = ops.rmsnorm(x_t, w_t, eps=1e-6)
    assert out.dtype == x_t.dtype and out.shape == (T, D)
    _close(out, jops.rmsnorm(x_j, w_j, eps=1e-6), dtype)
    assert ops.LAUNCHES == before      # CPU tensors never count a launch


def test_rmsnorm_any_row_count():
    """The port takes any T (the TPU kernel asserts T % block_rows == 0)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((5, 96), np.float32)
    w = rng.standard_normal((96,), np.float32)
    out = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(jref.rmsnorm_ref(
        jnp.asarray(x), jnp.asarray(w))), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------- flash attention
ATTN_SHAPES = [
    # (B, Sq, Sk, H, KV, Dh, causal): a subset of test_kernels.ATTN_SHAPES
    (1, 128, 128, 4, 4, 64, True),
    (2, 256, 256, 8, 2, 64, True),      # GQA group=4
    (2, 128, 128, 4, 4, 128, False),    # bidirectional
    (1, 128, 128, 4, 4, 96, True),      # phi-3-vision's head dim
    (2, 128, 256, 4, 2, 96, False),     # cross-attention: Sq != Sk
]


# the bf16 forward's wgmma route (a (b, kv head) with Sq x G >= 64 rows) about
# its tiles, small enough for interpret mode: 64 and 128 rows exactly, a row
# or a query past them, G 8 with Sq 17 (136 rows, 16 queries a block), Dh 96
# with Sq 129, and Sk off the 64- and 128-key tiles
ATTN_WGMMA_EDGES = [
    (2, 32, 32, 4, 2, 64, True),        # 64 rows
    (1, 64, 64, 4, 2, 64, True),        # 128 rows
    (1, 65, 65, 2, 2, 64, True),        # 65 rows (G 1)
    (1, 33, 33, 4, 2, 128, False),      # 66 rows (G 2)
    (1, 17, 17, 8, 1, 64, True),        # G 8
    (1, 129, 129, 2, 2, 96, True),      # Dh 96, 129 rows
    (1, 100, 300, 4, 2, 64, False),     # Sk off the key tile
]


# the split decode route's shapes (bf16 on the card: Sq x G <= 16 rows a (b,
# kv head), not causal, Sk >= 128): Sq 1 at G 1, 4 and 8 and Dh 64 and 128,
# whisper's decoder cross-attention (one row a (b, kv head) against 1500
# frames), 16 rows (Sq 2, G 8 at Dh 96, Sk off a tile), and Sk 64 below the
# route (mma.sync)
ATTN_DECODE = [
    (2, 1, 300, 4, 4, 64, False),
    (1, 1, 1500, 16, 16, 64, False),
    (2, 1, 200, 16, 2, 128, False),
    (1, 2, 257, 8, 4, 96, False),
    (1, 1, 64, 4, 4, 64, False),
]


def _jax_block(S: int) -> int:
    """The JAX kernel's block along a length: 128 where it divides the
    length (its default), else the whole length (its blocks must divide)."""
    return 128 if S % min(128, S) == 0 else S


@pytest.mark.parametrize("B,Sq,Sk,H,KV,Dh,causal",
                         ATTN_SHAPES + ATTN_WGMMA_EDGES + ATTN_DECODE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax_kernel(B, Sq, Sk, H, KV, Dh, causal,
                                            dtype):
    rng = np.random.default_rng(B * Sq * H * Dh + KV)
    q_t, q_j = _both(rng.standard_normal((B, Sq, H, Dh), np.float32), dtype)
    k_t, k_j = _both(rng.standard_normal((B, Sk, KV, Dh), np.float32), dtype)
    v_t, v_j = _both(rng.standard_normal((B, Sk, KV, Dh), np.float32), dtype)
    out = ops.flash_attention(q_t, k_t, v_t, causal=causal)
    assert out.dtype == q_t.dtype and out.shape == (B, Sq, H, Dh)
    _close(out, jops.flash_attention(q_j, k_j, v_j, causal=causal,
                                     block_q=_jax_block(Sq),
                                     block_k=_jax_block(Sk)), dtype)


# (shape (B, Sq, Sk, H, KV, Dh), dtype, causal, scale) -> the forward's route
# and, on the split decode route, (splits, keys a split): the timed rows
# (granite's prefill, the whisper encoder, its cross-attention at Sq 224 and
# 1, phi-3, jamba's window), then the route's edges
ATTN_PLANS = [
    ((8, 512, 512, 16, 8, 64), "bfloat16", True, None, "wgmma", None),
    ((8, 1500, 1500, 16, 16, 64), "bfloat16", False, None, "wgmma", None),
    ((8, 224, 1500, 16, 16, 64), "bfloat16", False, None, "wgmma", None),
    ((8, 1, 1500, 16, 16, 64), "bfloat16", False, None, "split decode",
     (8, 192)),
    ((8, 768, 768, 32, 32, 96), "bfloat16", True, None, "wgmma", None),
    ((1, 8192, 8192, 64, 8, 128), "bfloat16", True, None, "wgmma", None),
    ((8, 1, 1500, 16, 16, 64), "float32", False, None, "f32 FMA", None),
    ((8, 512, 512, 16, 8, 64), "float32", True, None, "f32 FMA", None),
    ((2, 1, 0, 8, 8, 64), "bfloat16", False, None, "mma.sync", None),
    ((2, 64, 0, 8, 8, 64), "bfloat16", False, None, "mma.sync", None),
    ((2, 17, 1500, 4, 4, 64), "bfloat16", False, None, "mma.sync", None),
    ((2, 2, 1500, 16, 2, 64), "bfloat16", False, None, "split decode",
     None),
    ((2, 1, 127, 8, 8, 64), "bfloat16", False, None, "mma.sync", None),
    ((2, 1, 128, 8, 8, 64), "bfloat16", False, None, "split decode",
     None),
    ((1, 1, 129, 4, 4, 64), "bfloat16", False, None, "split decode",
     (3, 64)),
    ((2, 1, 1, 8, 2, 64), "bfloat16", True, None, "mma.sync", None),
    ((1, 16, 16, 4, 4, 64), "bfloat16", True, None, "mma.sync", None),
    ((2, 1, 1500, 8, 8, 64), "bfloat16", False, -0.125, "mma.sync", None),
    ((1, 1, 140000, 1, 1, 64), "bfloat16", False, None, "split decode",
     (274, 512)),
    ((1, 1, 4097, 16, 2, 128), "bfloat16", False, None, "split decode",
     None),
    ((1, 1, 200000, 8, 1, 128), "bfloat16", False, None, "split decode",
     None),
    ((1, 1, 64, 1, 1, 96), "bfloat16", False, 0.5, "mma.sync", None),
    ((2, 64, 300, 256, 1, 64), "bfloat16", False, None, "mma.sync", None),
]


@pytest.mark.parametrize("shape,dtype,causal,scale,route,split", ATTN_PLANS)
def test_attention_plan(shape, dtype, causal, scale, route, split):
    """``ops.attention_plan`` picks each route by shape, and its splits
    cover the keys in whole tiles within the kernel's shared memory, with
    no split empty; the backward's plan keeps its own rule."""
    B, Sq, Sk, H, KV, Dh = shape
    plan = ops.attention_plan(B, Sq, Sk, H, KV, Dh, getattr(torch, dtype),
                              causal, scale)
    assert plan.route == route and plan.code == ops.ATTN_ROUTES.index(route)
    assert str(plan).startswith(f"{route} ({plan.kernels[0]}")
    if route != "split decode":
        assert (plan.splits, plan.keys) == (1, 0)
        return
    assert plan.kernels == ("flash_decode_split_kernel",
                            "flash_decode_merge_kernel")
    if split is not None:
        assert (plan.splits, plan.keys) == split
    tiles = plan.keys // ops.ATTN_TILE
    assert plan.keys % ops.ATTN_TILE == 0
    assert 1 <= tiles <= ops.DECODE_MAX_TILES[Dh]
    assert plan.splits * plan.keys >= Sk > (plan.splits - 1) * plan.keys
    if shape == (1, 1, 129, 4, 4, 64):        # the last split has one key
        assert Sk - (plan.splits - 1) * plan.keys == 1


@pytest.mark.parametrize("shape,dtype,route", [
    ((8, 512, 512, 16, 8), "bfloat16", "wgmma"),
    ((8, 1, 1500, 16, 16), "bfloat16", "mma.sync"),
    ((2, 63, 63, 4, 4), "bfloat16", "mma.sync"),
    ((1, 64, 0, 4, 4), "bfloat16", "mma.sync"),
    ((1, 2, 2, 130, 1), "bfloat16", "mma.sync"),
    ((8, 512, 512, 16, 8), "float32", "f32 FMA"),
])
def test_attention_bwd_plan(shape, dtype, route):
    plan = ops.attention_bwd_plan(*shape, getattr(torch, dtype))
    assert plan.route == route and plan.backward
    assert plan.kernels[0].startswith("flash_bwd_dkdv")


# windows about the wgmma route's 64-key tiles: 65 at Dh 128 (one past a
# tile), with GQA, and at Dh 64 with G 2
ATTN_WINDOWS = [(1, 150, 4, 1, 128, 65), (2, 130, 4, 2, 64, 65)]


@pytest.mark.parametrize("B,S,H,KV,Dh,window", ATTN_WINDOWS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_window_matches_jax_masked_attention(B, S, H, KV, Dh,
                                                             window, dtype):
    """The JAX kernel has no window: the model's masked attention
    (``layers._blocked_sdpa``) is the reference, in f32 on the same
    (rounded) inputs."""
    rng = np.random.default_rng(B * S * H * Dh + window)
    q_t, k_t, v_t = (_both(rng.standard_normal(sh, np.float32), dtype)[0]
                     for sh in ((B, S, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh)))
    out = ops.flash_attention(q_t, k_t, v_t, causal=True, window=window)
    assert out.dtype == q_t.dtype and out.shape == (B, S, H, Dh)
    jcfg = jconfigs.get_smoke_config("granite-moe-1b-a400m").replace(
        dtype="float32")
    want = jL._blocked_sdpa(jcfg, *(jnp.asarray(t.float().numpy())
                                    for t in (q_t, k_t, v_t)),
                            causal=True, window=window)
    _close(out, want, dtype)


def test_flash_attention_rejects_causal_offset():
    """Causal with Sq != Sk is outside the kernel's contract (no Sk-Sq
    offset in its mask), so the port refuses it instead of diverging."""
    q = torch.zeros(1, 64, 2, 64)
    kv = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError, match="Sq == Sk"):
        ops.flash_attention(q, kv, kv, causal=True)
    with pytest.raises(ValueError, match="Sq == Sk"):
        ref.flash_attention_ref(q, kv, kv, causal=True)
    # bidirectional attention takes any Sk
    assert ops.flash_attention(q, kv, kv, causal=False).shape == q.shape


def test_flash_attention_window_rules():
    """A window needs causal attention and is not negative; a window that
    covers the sequence changes nothing, and window 1 attends to the
    diagonal alone (out = v of the row's own key)."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 40, 4, 16),
                                                    np.float32))
               for _ in range(3))
    for kw in (dict(causal=False, window=8), dict(causal=True, window=-1)):
        with pytest.raises(ValueError, match="window"):
            ops.flash_attention(q, k, v, **kw)
        with pytest.raises(ValueError, match="window"):
            ref.flash_attention_ref(q, k, v, **kw)
    full = ops.flash_attention(q, k, v, causal=True)
    for w in (40, 1000):
        torch.testing.assert_close(
            ops.flash_attention(q, k, v, causal=True, window=w), full,
            rtol=0, atol=0)
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, causal=True, window=1), v,
        rtol=2e-5, atol=2e-5)


# ----------------------------------------------------------- grouped matmul
GMM_SHAPES = [
    # (T, D, F, E): a subset of test_kernels.GMM_SHAPES
    (256, 64, 128, 4),
    (512, 128, 256, 8),
    (384, 64, 128, 6),      # T not a power of two (3 tiles)
]


def _gmm_inputs(T, D, F, E, dtype, seed):
    rng = np.random.default_rng(seed)
    lhs_t, lhs_j = _both(rng.standard_normal((T, D), np.float32), dtype)
    rhs_t, rhs_j = _both(
        rng.standard_normal((E, D, F), np.float32) / np.sqrt(D), dtype)
    return lhs_t, lhs_j, rhs_t, rhs_j, rng


@pytest.mark.parametrize("T,D,F,E", GMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_matches_jax_kernel(T, D, F, E, dtype):
    lhs_t, lhs_j, rhs_t, rhs_j, rng = _gmm_inputs(T, D, F, E, dtype,
                                                  T * D + F + E)
    cuts = np.sort(rng.integers(0, T + 1, E - 1))     # some groups empty
    offs = np.concatenate([[0], cuts, [T]]).astype(np.int32)
    out = ops.grouped_matmul(lhs_t, rhs_t, torch.from_numpy(offs))
    assert out.dtype == lhs_t.dtype and out.shape == (T, F)
    _close(out, jops.grouped_matmul(lhs_j, rhs_j, jnp.asarray(offs)), dtype)


@pytest.mark.parametrize("offs", [
    [0, 0, 256, 256, 256],      # every row in expert 1, the rest empty
    [0, 0, 0, 0, 0],            # all groups empty: all rows uncovered
    [0, 64, 64, 64, 64],        # uncovered tail
    [32, 64, 100, 100, 200],    # uncovered head and tail
])
def test_grouped_matmul_empty_and_uncovered(offs):
    """Empty groups contribute nothing and rows that no group covers are
    exactly zero, as the JAX kernel gives them (not ref.py's clip onto the
    last expert)."""
    lhs_t, lhs_j, rhs_t, rhs_j, _ = _gmm_inputs(256, 64, 128, 4, "float32",
                                                7)
    out = ops.grouped_matmul(lhs_t, rhs_t, torch.tensor(offs, dtype=torch.int32))
    expect = np.asarray(jops.grouped_matmul(lhs_j, rhs_j,
                                            jnp.asarray(offs, jnp.int32)))
    np.testing.assert_allclose(out.numpy(), expect, rtol=2e-5, atol=2e-5)
    covered = np.zeros(256, bool)
    covered[offs[0]:offs[-1]] = True
    assert (out.numpy()[~covered] == 0).all()


def test_grouped_matmul_decode_shape():
    """The decode shape of granite: T = B*top_k = 64 rows over 32 experts,
    two rows each (f32, against the JAX kernel)."""
    lhs_t, lhs_j, rhs_t, rhs_j, _ = _gmm_inputs(64, 64, 32, 32, "float32", 3)
    offs = np.arange(0, 65, 2, dtype=np.int32)
    out = ops.grouped_matmul(lhs_t, rhs_t, torch.from_numpy(offs))
    expect = jops.grouped_matmul(lhs_j, rhs_j, jnp.asarray(offs),
                                 block_t=64, block_f=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), rtol=2e-5,
                               atol=2e-5)


def test_gmm_bf16_shape_rule():
    """The bf16 kernels read rows of D and F elements with 16-byte copies:
    both must be multiples of 8, and a call that breaks the rule raises
    instead of taking another route."""
    for D, F in [(1024, 512), (512, 1024), (64, 128), (8, 8), (136, 200)]:
        ops.check_gmm_bf16_shape(D, F)
    for D, F in [(100, 64), (64, 100), (1001, 512), (4, 8)]:
        with pytest.raises(ValueError, match="divisible by 8"):
            ops.check_gmm_bf16_shape(D, F)


# ---------------------------------------------------------------- backward
# The plain backward versions against jax.vjp of the JAX oracles
# (repro.kernels.ref) and against torch.autograd of the port's forward
# versions, in f32: 2e-5, attention 1e-4 (the tolerance of its gradients,
# sums of Sk products), relative to each output's max |ref|.
def _rel_close(got, want, tol, scale=None):
    """max |got - want| within tol x max |want| (or tol x ``scale``)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if not want.size:
        return
    if scale is None:
        scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _autograd(fn, inputs, dout):
    leaves = [t.clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    if not out.requires_grad:          # the output depends on no input
        return [torch.zeros_like(t) for t in inputs]
    return torch.autograd.grad(out, leaves, dout)


# the kernel's routes: T off its blocks of rows with D off the 16-byte
# vectors (the scalar route), short rows that share a warp (D 128), and
# rows past the register budget (the wide route: few rows of D 3072, runs
# of rows of D 3072, and D 2048 in f32 with T off the runs' groups)
@pytest.mark.parametrize("T,D", [(64, 64), (37, 1024), (16, 1001),
                                 (300, 1001), (129, 128), (5, 3072),
                                 (600, 2048), (64, 3072)])
def test_rmsnorm_bwd_ref_matches_jax_vjp(T, D):
    rng = np.random.default_rng(T + D)
    x, dy = (rng.standard_normal((T, D), np.float32) for _ in range(2))
    w = rng.standard_normal((D,), np.float32)
    dx, dw = ref.rmsnorm_bwd_ref(*map(torch.from_numpy, (x, w, dy)),
                                 eps=1e-6)
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm_ref(a, b, eps=1e-6),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    _rel_close(dx, jdx, 2e-5)
    _rel_close(dw, jdw, 2e-5)
    adx, adw = _autograd(lambda a, b: ref.rmsnorm_ref(a, b, eps=1e-6),
                         [torch.from_numpy(x), torch.from_numpy(w)],
                         torch.from_numpy(dy))
    _rel_close(dx, adx, 2e-5)
    _rel_close(dw, adw, 2e-5)


# the split backward's plain halves (the yardsticks of rmsnorm_bwd_part
# and rmsnorm_bwd_scale on the card) over m column shards: mamba2's gate
# rows whole and over 2 and 4 ranks, few rows, rows past the kernel's
# shared memory for two groups (D 12288), and D off the 16-byte vectors
@pytest.mark.parametrize("T,D,m", [(5, 3072, 1), (64, 3072, 1),
                                   (64, 3072, 2), (64, 3072, 4),
                                   (8, 12288, 2), (37, 1001, 1)])
def test_split_rmsnorm_bwd_ref_matches_jax_vjp(T, D, m):
    rng = np.random.default_rng(T * m + D)
    x, dy = (rng.standard_normal((T, D), np.float32) for _ in range(2))
    w = rng.standard_normal((D,), np.float32)
    shards = [[torch.from_numpy(np.ascontiguousarray(a)) for a in s]
              for s in zip(*(np.array_split(a, m, axis=-1)
                             for a in (x, w, dy)))]
    sums = sum(ref.rmsnorm_bwd_part_ref(*s) for s in shards)
    parts = [ref.rmsnorm_bwd_scale_ref(xi, wi, gi, sums, D, eps=1e-6)
             for xi, wi, gi in shards]
    dx = torch.cat([p[0] for p in parts], dim=-1)
    dw = torch.cat([p[1] for p in parts])
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm_ref(a, b, eps=1e-6),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    _rel_close(dx, jdx, 2e-5)
    _rel_close(dw, jdw, 2e-5)


ATTN_BWD = [
    # (B, Sq, Sk, H, KV, Dh, causal, window)
    (2, 40, 40, 4, 2, 16, True, 0),       # GQA, causal
    (1, 33, 33, 4, 4, 64, True, 0),
    (2, 24, 56, 6, 3, 16, False, 0),      # not causal, Sq != Sk
    (1, 48, 48, 8, 2, 16, True, 5),       # a window, GQA
    (2, 16, 16, 2, 1, 96, True, 16),      # a window of the whole sequence
    # the tensor-core backward's tiles: Sq 65 about its 64-key and 64- or
    # 32-row tiles, at Dh 64 and 128; a window of 1 with GQA
    (1, 65, 65, 4, 2, 64, True, 0),
    (1, 65, 65, 2, 1, 128, True, 0),
    (1, 40, 40, 4, 2, 16, True, 1),
    # the wgmma backward's edges (chip_smoke.ATTN_BWD_WGMMA_EDGES): exactly
    # 64 rows (Sq 32, G 2) and 63; 65 rows with G 1; G 8 with Sq 17; Dh 96
    # at Sq 129, causal and not; Dh 128 with Sk off the key tiles (100
    # against 300) and below a dK/dV block (77); groups that do not divide
    # a 64-row step (G 3, G 12); a window of 65 crossing a tile with GQA at
    # Dh 64 and 128; a window of 1 with GQA at Dh 128
    (2, 32, 32, 4, 2, 64, True, 0),
    (1, 63, 63, 4, 4, 64, True, 0),
    (2, 65, 65, 4, 4, 64, True, 0),
    (2, 17, 17, 16, 2, 128, True, 0),
    (1, 129, 129, 4, 4, 96, False, 0),
    (2, 129, 129, 4, 2, 96, True, 0),
    (2, 100, 300, 8, 4, 128, False, 0),
    (1, 200, 77, 4, 1, 128, False, 0),
    (1, 100, 100, 6, 2, 64, True, 0),
    (1, 50, 50, 12, 1, 128, False, 0),
    (1, 300, 300, 8, 2, 64, True, 65),
    (2, 300, 300, 8, 2, 128, True, 65),
    (1, 150, 150, 8, 4, 128, True, 1),
]


def _attn_bwd_scales(q, k, o, do, window):
    """Scales for dq, dk, dv in ``_rel_close`` (None: max |want|).  With a
    window of 1 each row keeps its own key only: P is 1 and dS = dP - D is
    0 up to rounding (JAX's vjp gives exactly 0), so dq and dk are held
    against the size of the terms that cancel, max|D| max|k| / sqrt(Dh)
    and G max|D| max|q| / sqrt(Dh), with D = rowsum(dO * O)."""
    if window != 1:
        return [None] * 3
    Dh, G = q.shape[-1], q.shape[2] // k.shape[2]
    dd = float(np.abs((np.asarray(do) * np.asarray(o)).sum(-1)).max())
    return [dd * float(np.abs(k).max()) / np.sqrt(Dh),
            G * dd * float(np.abs(q).max()) / np.sqrt(Dh), None]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,Dh,causal,window", ATTN_BWD)
def test_flash_attention_bwd_ref_matches_jax_vjp(B, Sq, Sk, H, KV, Dh,
                                                 causal, window):
    rng = np.random.default_rng(B * Sq * Sk + H * Dh + window)
    q = rng.standard_normal((B, Sq, H, Dh), np.float32)
    k, v = (rng.standard_normal((B, Sk, KV, Dh), np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, Sq, H, Dh), np.float32)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    o = ref.flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    grads = ref.flash_attention_bwd_ref(qt, kt, vt, o, dot, causal=causal,
                                        window=window)
    if window:
        # the JAX oracle has no window: the model's masked attention does
        jcfg = jconfigs.get_smoke_config("granite-moe-1b-a400m").replace(
            dtype="float32")
        fn = lambda a, b, c: jL._blocked_sdpa(jcfg, a, b, c, causal=True,
                                              window=window)
    else:
        fn = lambda a, b, c: jref.attention_ref(a, b, c, causal=causal)
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    scales = _attn_bwd_scales(q, k, o.numpy(), do, window)
    for got, want, sc in zip(grads, vjp(jnp.asarray(do)), scales):
        _rel_close(got, want, 1e-4, sc)
    auto = _autograd(lambda a, b, c: ref.flash_attention_ref(
        a, b, c, causal=causal, window=window), [qt, kt, vt], dot)
    for got, want, sc in zip(grads, auto, scales):
        _rel_close(got, want, 1e-4, sc)


@pytest.mark.parametrize("offs", [
    [0, 30, 30, 70, 128],        # covered, with an empty expert
    [5, 40, 40, 90, 120],        # an uncovered head and tail
    [0, 0, 0, 0, 0],             # every row uncovered
    [3, 66, 130, 195, 200],      # groups of 63, 64, 65 rows off 64-row slices
    [0, 1, 300, 303, 310],       # a hot expert
    # (offsets, T, D, F): an empty expert between two full ones, and few
    # rows (T <= 16 E, dX's decode route) with D and F off the 64 tiles
    ([0, 300, 300, 700], 700, 136, 200),
    ([2, 9, 9, 20, 33, 40, 45], 48, 136, 200),
    ([0, 3, 3, 8, 8, 8, 20, 21, 30], 40, 72, 200),
])
def test_grouped_matmul_bwd_ref_matches_jax_vjp(offs):
    """dX and dW against jax.vjp of the oracle.  The oracle clips rows no
    group covers onto expert E-1, so it is fed a dY that is zero on those
    rows; the port, fed any dY there, gives them a zero dX and adds nothing
    of them to dW."""
    offs, T, D, F = (offs if isinstance(offs, tuple)
                     else (offs, max(128, offs[-1]), 32, 48))
    E = len(offs) - 1
    rng = np.random.default_rng(sum(offs))
    lhs = rng.standard_normal((T, D), np.float32)
    rhs = rng.standard_normal((E, D, F), np.float32) / np.sqrt(D)
    dy = rng.standard_normal((T, F), np.float32)
    covered = np.zeros(T, bool)
    covered[offs[0]:offs[-1]] = True
    offs_t = torch.tensor(offs, dtype=torch.int32)
    dx, dw = ref.grouped_matmul_bwd_ref(torch.from_numpy(lhs),
                                        torch.from_numpy(rhs), offs_t,
                                        torch.from_numpy(dy))
    assert (dx.numpy()[~covered] == 0).all()
    _, vjp = jax.vjp(lambda a, b: jref.grouped_matmul_ref(
        a, b, jnp.asarray(offs, jnp.int32)), jnp.asarray(lhs),
        jnp.asarray(rhs))
    jdx, jdw = vjp(jnp.asarray(np.where(covered[:, None], dy, 0.0)))
    _rel_close(dx.numpy()[covered], np.asarray(jdx)[covered], 2e-5)
    _rel_close(dw, jdw, 2e-5)
    adx, adw = _autograd(lambda a, b: ref.grouped_matmul_ref(a, b, offs_t),
                         [torch.from_numpy(lhs), torch.from_numpy(rhs)],
                         torch.from_numpy(dy))
    _rel_close(dx, adx, 2e-5)
    _rel_close(dw, adw, 2e-5)


def test_cpu_ops_train_through_the_plain_versions():
    """On the CPU the ops are the plain versions, so autograd reaches every
    operand, and no kernel is counted."""
    rng = np.random.default_rng(2)
    before = dict(ops.LAUNCHES)
    x = torch.from_numpy(rng.standard_normal((8, 32), np.float32))
    w = torch.ones(32)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 16), np.float32))
    lhs = torch.from_numpy(rng.standard_normal((8, 16), np.float32))
    rhs = torch.from_numpy(rng.standard_normal((2, 16, 8), np.float32))
    leaves = [t.requires_grad_() for t in (x, w, q, lhs, rhs)]
    loss = (ops.rmsnorm(x, w).sum() + ops.flash_attention(q, q, q).sum()
            + ops.grouped_matmul(lhs, rhs, torch.tensor([0, 3, 8])).sum())
    grads = torch.autograd.grad(loss, leaves)
    assert all(g is not None and bool(g.abs().sum() > 0) for g in grads)
    assert ops.LAUNCHES == before
    assert set(ops.LAUNCHES) == {
        "rmsnorm", "flash_attention", "grouped_matmul", "ssd_chunk",
        "rmsnorm_bwd", "flash_attention_bwd", "grouped_matmul_dx",
        "grouped_matmul_dw", "ssd_chunk_bwd", "rmsnorm_part",
        "rmsnorm_scale", "rmsnorm_bwd_part", "rmsnorm_bwd_scale"}


# ------------------------------------------------------------------ build
def test_build_names_libraries_by_source_and_raises_without_nvcc(
        monkeypatch, tmp_path):
    """Libraries are keyed by a hash of their sources and flags (an edited
    kernel rebuilds); with no nvcc the build raises, never falls back."""
    from repro_torch.kernels import build
    paths = {name: build._lib_path(name) for name in build.KERNELS}
    assert len(set(paths.values())) == len(build.KERNELS)
    assert all(p.parent == build.BUILD_DIR for p in paths.values())
    assert paths == {name: build._lib_path(name) for name in build.KERNELS}
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()


def test_build_hash_covers_every_header(monkeypatch, tmp_path):
    """A library's name hashes its .cu file and every header under csrc/,
    so an edited helper header rebuilds the libraries that include it."""
    import shutil
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build._lib_path(name) for name in build.KERNELS}
    headers = sorted(csrc.glob("*.cuh"))
    assert {h.name for h in headers} >= {"common.cuh", "hopper.cuh"}
    for header in headers:
        text = header.read_text()
        header.write_text(text + "\n// edited\n")
        after = {name: build._lib_path(name) for name in build.KERNELS}
        assert all(after[n] != before[n] for n in build.KERNELS), header.name
        header.write_text(text)
    assert {name: build._lib_path(name) for name in build.KERNELS} == before
    # a new header counts too; an edited .cu renames only its own library
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(build._lib_path(n) != before[n] for n in build.KERNELS)
    (csrc / "extra.cuh").unlink()
    src = csrc / "rmsnorm.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = {name: build._lib_path(name) for name in build.KERNELS}
    assert [n for n in build.KERNELS if after[n] != before[n]] == ["rmsnorm"]


# ------------------------------------------------------- on the card only
@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """Each CUDA kernel against its plain version, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: "
                    "python3 chip_smoke.py covers the same checks)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        x = torch.randn(300, 1024, generator=gen, device=dev).to(dt)
        w = torch.randn(1024, generator=gen, device=dev)
        torch.testing.assert_close(ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w),
                                   rtol=tol, atol=tol)
        # a warp a row: rows held in registers (D 1536), rows walked in
        # pieces (D 12288), the scalar route (D 1001), and a contiguous x
        # that starts one element in (not 16-byte aligned: scalar route)
        for T, D in ((37, 1536), (9, 12288), (37, 1001)):
            x = torch.randn(T, D, generator=gen, device=dev).to(dt)
            w = torch.randn(D, generator=gen, device=dev)
            torch.testing.assert_close(ops.rmsnorm(x, w),
                                       ref.rmsnorm_ref(x, w),
                                       rtol=tol, atol=tol)
        buf = torch.randn(300 * 1024 + 1, generator=gen, device=dev).to(dt)
        x = buf[1:].view(300, 1024)
        assert x.is_contiguous() and x.data_ptr() % 16
        w = torch.randn(1024, generator=gen, device=dev)
        torch.testing.assert_close(ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w),
                                   rtol=tol, atol=tol)
        q = torch.randn(2, 96, 8, 64, generator=gen, device=dev).to(dt)
        k = torch.randn(2, 96, 4, 64, generator=gen, device=dev).to(dt)
        v = torch.randn(2, 96, 4, 64, generator=gen, device=dev).to(dt)
        torch.testing.assert_close(ops.flash_attention(q, k, v),
                                   ref.flash_attention_ref(q, k, v),
                                   rtol=tol, atol=tol)
        lhs = torch.randn(200, 128, generator=gen, device=dev).to(dt)
        rhs = (torch.randn(4, 128, 96, generator=gen, device=dev)
               / 128 ** 0.5).to(dt)
        offs = torch.tensor([10, 50, 50, 120, 190], dtype=torch.int32,
                            device=dev)
        torch.testing.assert_close(ops.grouped_matmul(lhs, rhs, offs),
                                   ref.grouped_matmul_ref(lhs, rhs, offs),
                                   rtol=tol, atol=tol)
        # ragged groups of 1, 17 and 129 rows about the 128- and 16-row
        # tiles, after an uncovered head, at prefill (T > 16 E) and decode
        # (T <= 16 E) sizes
        for T, E, offs in [(160, 3, [4, 5, 22, 151]),
                           (160, 10, [4, 5, 22, 151] + [151] * 7)]:
            lhs = torch.randn(T, 128, generator=gen, device=dev).to(dt)
            rhs = (torch.randn(E, 128, 96, generator=gen, device=dev)
                   / 128 ** 0.5).to(dt)
            offs = torch.tensor(offs, dtype=torch.int32, device=dev)
            got = ops.grouped_matmul(lhs, rhs, offs)
            torch.testing.assert_close(got,
                                       ref.grouped_matmul_ref(lhs, rhs, offs),
                                       rtol=tol, atol=tol)
            assert bool((got[:4] == 0).all()) and bool((got[151:] == 0).all())
        # head dim 128 and Sq 129 across the 64-key and 16-row tiles
        q = torch.randn(1, 129, 4, 128, generator=gen, device=dev).to(dt)
        k = torch.randn(1, 129, 2, 128, generator=gen, device=dev).to(dt)
        v = torch.randn(1, 129, 2, 128, generator=gen, device=dev).to(dt)
        torch.testing.assert_close(ops.flash_attention(q, k, v),
                                   ref.flash_attention_ref(q, k, v),
                                   rtol=tol, atol=tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_flash_attention_window_and_head_dim_96():
    """The CUDA flash_attention at head dim 96, with windows (1, not a
    multiple of the 64-key tile, past the sequence) and non-causal with
    Sq != Sk, against its plain version, in f32 and bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: "
                    "python3 chip_smoke.py covers the same checks)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [(2, 129, 129, 8, 4, 96, True, 0),
             (2, 129, 77, 8, 4, 96, False, 0),
             (1, 300, 300, 4, 2, 96, True, 100),
             (2, 300, 300, 8, 2, 64, True, 1),
             (1, 257, 257, 8, 1, 128, True, 65),
             (1, 200, 200, 4, 4, 96, True, 1000)]
    for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for B, Sq, Sk, H, KV, Dh, causal, window in cases:
            q = torch.randn(B, Sq, H, Dh, generator=gen, device=dev).to(dt)
            k = torch.randn(B, Sk, KV, Dh, generator=gen, device=dev).to(dt)
            v = torch.randn(B, Sk, KV, Dh, generator=gen, device=dev).to(dt)
            torch.testing.assert_close(
                ops.flash_attention(q, k, v, causal=causal, window=window),
                ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window),
                rtol=tol, atol=tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_flash_attention_wgmma_route():
    """The bf16 forward's wgmma route (flash_wgmma_kernel, where a (b, kv
    head) has 64 rows or more) at its tile edges, against the plain version
    within 2e-2 of max|ref|; a second call gives the same bits, and the
    output with the LSE equals the output without."""
    dev = _cuda_or_skip()
    gen = torch.Generator(device=dev).manual_seed(9)
    cases = [(2, 32, 32, 4, 2, 64, True, 0),       # 64 rows
             (2, 64, 64, 4, 2, 64, True, 0),       # 128 rows
             (2, 65, 65, 4, 4, 64, True, 0),       # 65 rows
             (2, 33, 33, 8, 4, 128, False, 0),     # 66 rows
             (2, 17, 17, 16, 2, 128, True, 0),     # G 8
             (1, 129, 129, 4, 4, 96, False, 0),    # Dh 96, 129 rows
             (2, 100, 300, 8, 4, 96, False, 0),    # Sk off the key tile
             (1, 200, 77, 4, 1, 128, False, 0),    # Sk below one tile
             (2, 300, 300, 8, 2, 128, True, 65),   # a window of 65
             (1, 100, 100, 6, 2, 64, True, 0)]     # G 3: 126 rows a block
    for B, Sq, Sk, H, KV, Dh, causal, window in cases:
        q = torch.randn(B, Sq, H, Dh, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, Sk, KV, Dh, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, Sk, KV, Dh, generator=gen, device=dev).bfloat16()
        kw = dict(causal=causal, window=window)
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw).float()
        err = float((got.float() - want).abs().max())
        assert err <= 2e-2 * float(want.abs().max()), (B, Sq, Sk, H, KV, Dh)
        assert torch.equal(got, ops.flash_attention(q, k, v, **kw))
        o, lse = ops.flash_attention_fwd(q, k, v, with_lse=True, **kw)
        assert torch.equal(o, got)
        assert bool(torch.isfinite(lse).all())
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_flash_attention_split_decode_route():
    """The bf16 forward's split decode route (keys split across blocks, then
    an ordered merge) at its plan's edges, against the plain version within
    2e-2 of max|ref|: Sq 1 at G 1, 2 and 8 and Dh 64, 96 and 128, Sk 4097
    (off a tile and off a split), 16 rows (Sq 2, G 8), Sk 128 (its least),
    Sk 129 (the last split one key) and 140000 keys of one head (a warp
    runs two tiles); beside it 17 rows, Sk 127 and causal decode stay on
    mma.sync.  A second call gives the same bits, the output with the LSE
    equals the output without, and the LSE is within 2e-2 of a plain
    logsumexp."""
    dev = _cuda_or_skip()
    gen = torch.Generator(device=dev).manual_seed(13)
    cases = [(2, 1, 1500, H, KV, Dh, False) for Dh in (64, 96, 128)
             for H, KV in ((4, 4), (8, 4), (16, 2))] + [
                 (1, 1, 4097, 16, 2, 128, False),
                 (2, 2, 1500, 16, 2, 64, False),
                 (3, 1, 128, 4, 4, 128, False),
                 (1, 1, 129, 4, 4, 64, False),
                 (1, 1, 140000, 1, 1, 64, False),
                 (2, 17, 1500, 4, 4, 64, False),
                 (2, 1, 127, 8, 8, 64, False),
                 (2, 1, 1, 8, 2, 64, True)]
    for B, Sq, Sk, H, KV, Dh, causal in cases:
        split = ops.attention_plan(B, Sq, Sk, H, KV, Dh, torch.bfloat16,
                                   causal).route == "split decode"
        assert split == (not causal and Sq * H // KV <= 16 and Sk >= 128)
        q = torch.randn(B, Sq, H, Dh, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, Sk, KV, Dh, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, Sk, KV, Dh, generator=gen, device=dev).bfloat16()
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q, k, v, causal=causal).float()
        err = float((got.float() - want).abs().max())
        assert err <= 2e-2 * float(want.abs().max()), (B, Sq, Sk, H, KV, Dh)
        assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal))
        o, lse = ops.flash_attention_fwd(q, k, v, causal=causal,
                                         with_lse=True)
        assert torch.equal(o, got)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()
                         .repeat_interleave(H // KV, dim=2)) * Dh ** -0.5
        if causal:
            s = s.masked_fill(torch.ones(Sq, Sk, dtype=torch.bool,
                                         device=dev).triu(1), float("-inf"))
        torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1),
                                   rtol=2e-2, atol=2e-2)
    torch.cuda.synchronize()


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: "
                    "python3 chip_smoke.py covers the same checks)")
    return torch.device("cuda")


def _rel_err(got, want):
    want = want.float()
    return float((got.float() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


@pytest.mark.cuda
def test_cuda_backward_kernels_match_plain():
    """rmsnorm_bwd, flash_attention_bwd (from the LSE forward) and
    grouped_matmul's dX and dW on the card against the plain backward
    versions (f32: 2e-5, attention 1e-4; bf16 2e-2; relative to max|ref|),
    each deterministic, and through autograd."""
    dev = _cuda_or_skip()
    gen = torch.Generator(device=dev).manual_seed(8)

    def randn(*shape, dt):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    for dt, tol, atol_attn in ((torch.float32, 2e-5, 1e-4),
                               (torch.bfloat16, 2e-2, 2e-2)):
        for T, D in ((300, 1024), (37, 1001), (5, 64), (300, 1001),
                     (129, 128), (5, 3072)):
            x, dy = randn(T, D, dt=dt), randn(T, D, dt=dt)
            w = randn(D, dt=torch.float32)
            got = ops.rmsnorm_bwd(x, w, dy, 1e-6)
            want = ref.rmsnorm_bwd_ref(x, w, dy, eps=1e-6)
            for g, r in zip(got, want):
                assert _rel_err(g, r) <= tol
            again = ops.rmsnorm_bwd(x, w, dy, 1e-6)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
        for B, Sq, Sk, H, KV, Dh, causal, window in (
                (2, 129, 129, 8, 4, 64, True, 0),
                (1, 100, 77, 4, 2, 96, False, 0),
                (1, 200, 200, 4, 1, 128, True, 50),
                # the tensor-core tiles' edges: Sq 65 and 127, a window of
                # 1 with GQA, and Sk 0 (no row keeps a key)
                (1, 65, 65, 4, 2, 64, True, 0),
                (1, 65, 65, 2, 1, 128, True, 0),
                (2, 127, 127, 8, 2, 96, True, 0),
                (1, 127, 77, 4, 4, 128, False, 0),
                (2, 300, 300, 8, 2, 64, True, 1),
                (1, 65, 0, 4, 2, 64, False, 0),
                # the wgmma route's edges: 64 rows exactly and 63 (mma.sync),
                # 65 rows with G 1, G 8 with Sq 17, Dh 96 at Sq 129, Sk off
                # the key tiles (100 against 300), G 3 and G 12 (a step's
                # last rows zero), a window of 65 at Dh 128, a window of 1
                (2, 32, 32, 4, 2, 64, True, 0),
                (1, 63, 63, 4, 4, 64, True, 0),
                (2, 65, 65, 4, 4, 64, True, 0),
                (2, 17, 17, 16, 2, 128, True, 0),
                (2, 129, 129, 4, 2, 96, True, 0),
                (2, 100, 300, 8, 4, 128, False, 0),
                (1, 100, 100, 6, 2, 64, True, 0),
                (1, 50, 50, 12, 1, 128, False, 0),
                (2, 300, 300, 8, 2, 128, True, 65),
                (1, 150, 150, 8, 4, 128, True, 1)):
            q = randn(B, Sq, H, Dh, dt=dt)
            k, v = randn(B, Sk, KV, Dh, dt=dt), randn(B, Sk, KV, Dh, dt=dt)
            do = randn(B, Sq, H, Dh, dt=dt)
            o, lse = ops.flash_attention_fwd(q, k, v, causal=causal,
                                             window=window, with_lse=True)
            plain_o = ops.flash_attention_fwd(q, k, v, causal=causal,
                                              window=window)[0]
            assert torch.equal(o, plain_o)
            got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                          window=window)
            want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                               window=window)
            scales = _attn_bwd_scales(*(t.float().cpu().numpy()
                                        for t in (q, k, o, do)), window)
            for g, r, sc in zip(got, want, scales):
                assert bool(torch.isfinite(g).all())
                _rel_close(g.float().cpu(), r.float().cpu(), atol_attn, sc)
            again = ops.flash_attention_bwd(q, k, v, o, lse, do,
                                            causal=causal, window=window)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
        T, D, F, E = 300, 128, 96, 5
        offs = torch.tensor([7, 60, 60, 61, 200, 290], dtype=torch.int32,
                            device=dev)
        lhs, dy = randn(T, D, dt=dt), randn(T, F, dt=dt)
        rhs = (randn(E, D, F, dt=torch.float32) / D ** 0.5).to(dt)
        got = ops.grouped_matmul_bwd(lhs, rhs, offs, dy)
        want = ref.grouped_matmul_bwd_ref(lhs, rhs, offs, dy)
        for g, r in zip(got, want):
            assert _rel_err(g, r) <= tol
        assert bool((got[0][:7] == 0).all()) and bool((got[0][290:] == 0).all())
        assert bool((got[1][1] == 0).all())             # an expert, no rows
        again = ops.grouped_matmul_bwd(lhs, rhs, offs, dy)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        # dW's wgmma tiles: groups of 63, 64 and 65 rows off the 64-row
        # slices with D and F off the 128 x 256 tile, and a hot expert
        for o_, Dw, Fw in (([3, 66, 130, 195, 200], 200, 328),
                           ([0, 1, 1000, 1003, 1010], 256, 512)):
            offs_w = torch.tensor(o_, dtype=torch.int32, device=dev)
            xw, dyw = randn(o_[-1], Dw, dt=dt), randn(o_[-1], Fw, dt=dt)
            dw = ops.grouped_matmul_dw(xw, dyw, offs_w, 4)
            assert _rel_err(dw, ref.grouped_matmul_dw_ref(xw, dyw, offs_w,
                                                          4)) <= tol
            assert torch.equal(dw, ops.grouped_matmul_dw(xw, dyw, offs_w, 4))
        # dX on its decode route (T <= 16 E): D and F off the 64 tiles, and
        # granite's expert shape; uncovered rows ahead and behind
        for o_, Tx, Dx, Fx in (([2, 9, 9, 20, 33, 40, 45], 48, 136, 200),
                               ([0, 3, 3, 8, 8, 8, 20, 21, 30], 40, 72, 200),
                               ([min(2 + 2 * i, 61) for i in range(33)], 64,
                                1024, 512)):
            offs_x = torch.tensor(o_, dtype=torch.int32, device=dev)
            dyx = randn(Tx, Fx, dt=dt)
            wx = (randn(len(o_) - 1, Dx, Fx, dt=torch.float32)
                  / Dx ** 0.5).to(dt)
            dx, _ = ops.grouped_matmul_bwd(dyx, wx, offs_x, dyx,
                                           need_dw=False)
            want = ref.grouped_matmul_bwd_ref(dyx.new_zeros(Tx, Dx), wx,
                                              offs_x, dyx)[0]
            assert _rel_err(dx, want) <= tol
            assert bool((dx[:o_[0]] == 0).all())
            assert bool((dx[o_[-1]:] == 0).all())
            again = ops.grouped_matmul_bwd(dyx, wx, offs_x, dyx,
                                           need_dw=False)[0]
            assert torch.equal(dx, again)
        # through autograd, every operand gets the kernels' gradient
        leaves = [t.clone().requires_grad_() for t in (lhs, rhs)]
        before = dict(ops.LAUNCHES)
        out = ops.grouped_matmul(*leaves, offs)
        gl, gr = torch.autograd.grad(out, leaves, dy)
        assert torch.equal(gl, got[0]) and torch.equal(gr, got[1])
        assert ops.LAUNCHES["grouped_matmul_dx"] == \
            before["grouped_matmul_dx"] + 1
        assert ops.LAUNCHES["grouped_matmul_dw"] == \
            before["grouped_matmul_dw"] + 1
    torch.cuda.synchronize()


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.cuda
def test_cuda_rmsnorm_bwd_wide_route():
    """rmsnorm_bwd's wide route on the card: few rows and mamba2's gate
    rows of D 3072 in bf16 and rows of D 2048 in f32 against the plain
    version (bf16 2e-2, f32 2e-5 of max|ref|), the same bits twice; and
    over one rank rmsnorm_bwd_part then rmsnorm_bwd_scale give
    rmsnorm_bwd's bits."""
    dev = _cuda_or_skip()
    gen = torch.Generator(device=dev).manual_seed(37)
    for T, D, dt, tol in ((5, 3072, torch.bfloat16, 2e-2),
                          (4096, 3072, torch.bfloat16, 2e-2),
                          (600, 2048, torch.float32, 2e-5)):
        x, dy = (torch.randn(T, D, generator=gen, device=dev).to(dt)
                 for _ in range(2))
        w = 1 + 0.1 * torch.randn(D, generator=gen, device=dev)
        got = ops.rmsnorm_bwd(x, w, dy, 1e-6)
        want = ref.rmsnorm_bwd_ref(x, w, dy, eps=1e-6)
        for g, r in zip(got, want):
            assert _rel_err(g, r) <= tol
        again = ops.rmsnorm_bwd(x, w, dy, 1e-6)
        assert all(_same_bits(a, b) for a, b in zip(got, again))
        split = ops.rmsnorm_bwd_scale(x, w, dy, ops.rmsnorm_bwd_part(x, w, dy),
                                      D, 1e-6)
        assert all(_same_bits(a, b) for a, b in zip(got, split))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_ssd_chunk_bwd_matches_plain():
    """ssd_chunk_bwd on the card against its plain version (f32, 1e-4 of
    each output's max |ref|) and within ssd_chunk_bwd_f64's bound, the same
    bits twice, in both layouts, with ds or dy absent; and through autograd
    with grad on, where ops.ssd_chunk runs the forward and backward
    kernels and gives the backward kernel's gradients."""
    dev = _cuda_or_skip()
    gen = torch.Generator(device=dev).manual_seed(16)
    F = torch.nn.functional
    cases = [((4, 256, 3, 64, 128), True, True),
             ((2, 13, 5, 64, 128), True, True),
             ((6, 32, 1, 16, 24), True, True),      # the JAX layout
             ((2, 65, 13, 64, 128), True, False),   # ds absent
             ((2, 100, 9, 30, 18), False, True),    # dy absent
             ((1, 1024, 3, 64, 128), True, True)]
    for (BC, Q, H, P, N), has_dy, has_ds in cases:
        x = torch.randn(BC, Q, H, P, generator=gen, device=dev)
        dt = F.softplus(torch.randn(BC, Q, H, generator=gen, device=dev))
        a = -dt * torch.rand(H, generator=gen, device=dev)
        B = torch.randn(BC, Q, N, generator=gen, device=dev)
        C = torch.randn(BC, Q, N, generator=gen, device=dev)
        dy = torch.randn(x.shape, generator=gen, device=dev)
        ds = torch.randn(BC, H, P, N, generator=gen, device=dev)
        if H == 1:                                # the JAX layout
            x, dt, a, dy, ds = x[:, :, 0], dt[..., 0], a[..., 0], \
                dy[:, :, 0], ds[:, 0]
        dy, ds = dy if has_dy else None, ds if has_ds else None
        before = ops.LAUNCHES["ssd_chunk_bwd"]
        got = ops.ssd_chunk_bwd(x, dt, a, B, C, dy, ds)
        assert ops.LAUNCHES["ssd_chunk_bwd"] == before + 1
        want = ref.ssd_chunk_bwd_ref(x, dt, a, B, C, dy, ds)
        vals, bounds = ref.ssd_chunk_bwd_f64(x, dt, a, B, C, dy, ds)
        for g, w, v, b in zip(got, want, vals, bounds):
            assert g.shape == w.shape and g.dtype == torch.float32
            assert _rel_err(g, w) <= 1e-4
            assert bool(((g.double() - v).abs() <= b).all())
        again = ops.ssd_chunk_bwd(x, dt, a, B, C, dy, ds)
        assert all(torch.equal(u, v) for u, v in zip(got, again))
        if has_dy and has_ds:
            leaves = [t.clone().requires_grad_() for t in (x, dt, a, B, C)]
            y, s = ops.ssd_chunk(*leaves)
            grads = torch.autograd.grad((y, s), leaves, (dy, ds))
            assert all(torch.equal(u, v) for u, v in zip(grads, got))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_ssd_chunk_bwd_at_its_plan_edges():
    """ssd_chunk_bwd at the edges of its launch plan (csrc/ssd_chunk.cu):
    one head past a state split (H 25) with P off 16-byte rows, fewer heads
    than a dx group (H 5) with N off 16-byte rows, the most state splits
    and pairs groups (H 129), and a of both signs (a_cum not monotone);
    each against its plain version (1e-4 of max |ref|) and
    ssd_chunk_bwd_f64's bound, finite, the same bits twice, allocating no
    more than its outputs and ops.ssd_bwd_scratch_floats."""
    dev = _cuda_or_skip()
    gen = torch.Generator(device=dev).manual_seed(31)
    F = torch.nn.functional
    for (BC, Q, H, P, N), signed in [((1, 192, 25, 66, 128), False),
                                     ((2, 64, 5, 64, 62), False),
                                     ((1, 64, 129, 64, 64), False),
                                     ((2, 256, 13, 64, 128), True)]:
        x = torch.randn(BC, Q, H, P, generator=gen, device=dev)
        dt = F.softplus(torch.randn(BC, Q, H, generator=gen, device=dev))
        a = -dt * torch.rand(H, generator=gen, device=dev)
        if signed:
            a = 0.3 * torch.randn(a.shape, generator=gen, device=dev)
        B = torch.randn(BC, Q, N, generator=gen, device=dev)
        C = torch.randn(BC, Q, N, generator=gen, device=dev)
        dy = torch.randn(x.shape, generator=gen, device=dev)
        ds = torch.randn(BC, H, P, N, generator=gen, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        got = ops.ssd_chunk_bwd(x, dt, a, B, C, dy, ds)
        grads = sum(t.numel() for t in (x, dt, a, B, C))
        scratch = ops.ssd_bwd_scratch_floats(BC, Q, H, N)
        assert torch.cuda.max_memory_allocated(dev) - base <= \
            4 * (grads + scratch) + 4096
        want = ref.ssd_chunk_bwd_ref(x, dt, a, B, C, dy, ds)
        vals, bounds = ref.ssd_chunk_bwd_f64(x, dt, a, B, C, dy, ds)
        for g, w, v, b in zip(got, want, vals, bounds):
            assert bool(torch.isfinite(g).all())
            assert _rel_err(g, w) <= 1e-4
            assert bool(((g.double() - v).abs() <= b).all())
        again = ops.ssd_chunk_bwd(x, dt, a, B, C, dy, ds)
        assert all(torch.equal(u, v) for u, v in zip(got, again))
    torch.cuda.synchronize()
