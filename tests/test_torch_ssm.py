"""Port's SSD kernel, scan, SSM layer and SSM/hybrid models against ``repro``.

Everything runs on the CPU in f32.  The same numpy inputs, made from a
seed, go to both packages; model weights come from the JAX init through
``repro_torch.weights.from_jax_params``.  The JAX side runs the Pallas
``ssd_chunk_kernel`` in interpret mode, its ``ref.ssd_chunk_ref``, the
``ops.ssd_scan`` wrapper and the model's ``ssd_chunked``.  Tolerances: 1e-4
for the SSD terms (``tests/test_kernels.py``'s SSD tolerance) and for
logits after a whole stack; the CUDA kernel is held to 2e-5 against its
plain version on the card (``cuda`` marker, and ``chip_smoke.py``).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_chunk_kernel  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import ssd as jssd  # noqa: E402
from repro.models.base import set_logical_rules  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import api, ssd  # noqa: E402
from repro_torch.models.spec import ModelConfig  # noqa: E402
from repro_torch.models.transformer import block_params  # noqa: E402
from repro_torch.weights import flatten, from_jax_params  # noqa: E402

SSD_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = {"mamba2": "mamba2-780m", "jamba": "jamba-1.5-large-398b"}


@pytest.fixture(autouse=True)
def _no_logical_rules():
    # xdist workers share a process across test files; an earlier test may
    # have installed mesh rules (base.py: set_logical_rules is global).
    set_logical_rules(None)
    yield
    set_logical_rules(None)


def _np(t):
    return t.detach().float().numpy()


def _cfgs(arch: str):
    jcfg = jconfigs.get_smoke_config(arch).replace(dtype="float32")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _params(jcfg, seed=0):
    jp, _ = japi.init(jcfg, jax.random.PRNGKey(seed))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _chunk_inputs(G, Q, P, N, seed):
    """The intra-chunk test's distributions: a <= 0, dt > 0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, Q, P), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((G, Q)))).astype(np.float32)
    a = -np.abs(rng.standard_normal((G, Q))).astype(np.float32)
    B = rng.standard_normal((G, Q, N)).astype(np.float32)
    C = rng.standard_normal((G, Q, N)).astype(np.float32)
    return x, dt, a, B, C


# ------------------------------------------------------------- ssd_chunk
@pytest.mark.parametrize("G,Q,P,N", [
    (6, 32, 16, 24),        # test_kernels.test_ssd_intra_chunk_kernel_vs_ref
    (4, 64, 16, 16),
    (3, 13, 8, 16),         # odd Q, as a chunk shrunk to divide S = 13
    (2, 1, 8, 16),          # one step
])
def test_ssd_chunk_matches_jax_kernel(G, Q, P, N):
    args = _chunk_inputs(G, Q, P, N, G * Q + P + N)
    y_k, s_k = ssd_chunk_kernel(*map(jnp.asarray, args), interpret=True)
    y_r, s_r = jref.ssd_chunk_ref(*map(jnp.asarray, args))
    before = dict(ops.LAUNCHES)
    for fn in (ref.ssd_chunk_ref, ops.ssd_chunk):
        y, s = fn(*map(torch.from_numpy, args))
        assert y.dtype == s.dtype == torch.float32
        assert y.shape == (G, Q, P) and s.shape == (G, P, N)
        for want in (y_k, y_r):
            np.testing.assert_allclose(_np(y), np.asarray(want), **SSD_TOL)
        for want in (s_k, s_r):
            np.testing.assert_allclose(_np(s), np.asarray(want), **SSD_TOL)
    assert ops.LAUNCHES == before      # CPU tensors never count a launch


def test_ssd_chunk_heads_layout_equals_broadcast_layout():
    """The model's layout (heads minor, B and C shared by the heads of a
    cell) gives what the JAX layout gives with B and C broadcast per head,
    which is what ``repro.kernels.ops.ssd_scan`` passes its kernel."""
    BC, Q, H, P, N = 3, 24, 4, 8, 16
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((BC, Q, H, P), np.float32))
    dt = torch.from_numpy(rng.random((BC, Q, H), np.float32) + 0.1)
    a = -dt * 0.7
    B = torch.from_numpy(rng.standard_normal((BC, Q, N), np.float32))
    C = torch.from_numpy(rng.standard_normal((BC, Q, N), np.float32))
    y, s = ops.ssd_chunk(x, dt, a, B, C)
    assert y.shape == (BC, Q, H, P) and s.shape == (BC, H, P, N)

    def flat(t):                       # [BC, Q, H, ...] -> [BC*H, Q, ...]
        return t.movedim(2, 1).reshape(BC * H, Q, *t.shape[3:])

    def bcast(t):
        return t[:, None].expand(BC, H, Q, N).reshape(BC * H, Q, N)

    yf, sf = ops.ssd_chunk(flat(x), flat(dt), flat(a), bcast(B), bcast(C))
    np.testing.assert_allclose(_np(flat(y)), _np(yf), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(s.reshape(BC * H, P, N)), _np(sf),
                               rtol=1e-6, atol=1e-6)


def test_ssd_chunk_rejects_bad_shapes():
    x = torch.zeros(2, 8, 4, 8)
    dt = torch.zeros(2, 8, 4)
    B = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="ssd_chunk"):
        ops.ssd_chunk(x, dt, dt, B, torch.zeros(2, 8, 8))
    with pytest.raises(ValueError, match="ssd_chunk"):
        ops.ssd_chunk(x, dt[:, :4], dt, B, B)
    with pytest.raises(ValueError, match="ssd_chunk"):
        ref.ssd_chunk_ref(x[0], dt, dt, B, B)
    Q = ops.SSD_MAX_Q + 1          # past the kernel's shared-memory plan
    with pytest.raises(ValueError, match=f"chunk length {Q}"):
        ops.ssd_chunk(torch.zeros(1, Q, 1, 8), torch.zeros(1, Q, 1),
                      torch.zeros(1, Q, 1), torch.zeros(1, Q, 16),
                      torch.zeros(1, Q, 16))


def _mamba2_chunk_inputs(BC, Q, H, P, N, seed):
    """The main path's distributions (chip_smoke.ssd_inputs): dt =
    softplus(.), a = -exp(A_log) dt with A_log ~ N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BC, Q, H, P), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((BC, Q, H)))).astype(np.float32)
    a = (-dt * np.exp(0.1 * rng.standard_normal(H))).astype(np.float32)
    B = rng.standard_normal((BC, Q, N)).astype(np.float32)
    C = rng.standard_normal((BC, Q, N)).astype(np.float32)
    return tuple(torch.from_numpy(t) for t in (x, dt, a, B, C))


@pytest.mark.parametrize("BC,Q,H,P,N", [
    (1, 200, 2, 130, 300),  # where f32 misses 2e-5 + 2e-5 |y| against f64
    (2, 256, 48, 64, 128),  # mamba2's chunk (2 of the main path's 16 cells)
])
def test_ssd_chunk_f64_bound_holds_plain_f32(BC, Q, H, P, N):
    """The f64 evaluation's bound is not below f32's own rounding: the
    plain f32 version meets it with room to spare."""
    args = _mamba2_chunk_inputs(BC, Q, H, P, N, Q + H)
    y64, s64, y_bound, s_bound = ref.ssd_chunk_f64(*args)
    assert y64.dtype == torch.float64 and y64.shape == (BC, Q, H, P)
    assert s64.shape == s_bound.shape == (BC, H, P, N)
    y, s = ref.ssd_chunk_ref(*args)
    for got, want, bound in ((y, y64, y_bound), (s, s64, s_bound)):
        ratio = float(((got.double() - want).abs() / bound).max())
        assert ratio < 0.1, ratio


def test_ssd_chunk_f64_bound_catches_a_missing_term():
    """A fault as small as one missing key exceeds the bound: the plain
    version with x zeroed at key 100 (for y) and at the last key (for the
    state, where earlier keys are decayed by up to exp(-100)), against the
    f64 terms of the real inputs."""
    args = _mamba2_chunk_inputs(1, 200, 2, 130, 300, 7)
    y64, s64, y_bound, s_bound = ref.ssd_chunk_f64(*args)
    x = args[0].clone()
    x[:, 100] = 0.0
    x[:, 199] = 0.0
    y, s = ref.ssd_chunk_ref(x, *args[1:])
    assert bool(((y.double() - y64).abs() > y_bound)[:, 100:].any())
    assert bool(((s.double() - s64).abs() > s_bound).any())
    assert bool(((y.double() - y64).abs() <= y_bound)[:, :100].all())
    assert bool(((y.double() - y64).abs() > y_bound)[:, 199].any())


def test_ssd_chunk_f64_matches_jax_kernel():
    """The f64 evaluation agrees with the Pallas kernel (interpret mode) in
    the JAX layout, and takes that layout's shapes."""
    args = _chunk_inputs(6, 32, 16, 24, 3)
    y_k, s_k = ssd_chunk_kernel(*map(jnp.asarray, args), interpret=True)
    y64, s64, y_bound, s_bound = ref.ssd_chunk_f64(
        *map(torch.from_numpy, args))
    assert y64.shape == y_bound.shape == (6, 32, 16)
    assert s64.shape == s_bound.shape == (6, 16, 24)
    np.testing.assert_allclose(y64.numpy(), np.asarray(y_k), **SSD_TOL)
    np.testing.assert_allclose(s64.numpy(), np.asarray(s_k), **SSD_TOL)


# -------------------------------------------------------------- ssd_scan
@pytest.mark.parametrize("b,S,H,P,N,chunk", [
    (1, 64, 2, 16, 16, 16),     # test_kernels.SSD_SHAPES
    (2, 128, 4, 32, 64, 32),
    (1, 256, 2, 64, 128, 64),
    (2, 52, 3, 8, 16, 16),      # 52 % 16 != 0: the chunk shrinks to 13
])
def test_ssd_scan_matches_reference(b, S, H, P, N, chunk):
    rng = np.random.default_rng(b * S + H * P + N)
    x = rng.standard_normal((b, S, H, P), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(np.float32)
    A_log = (rng.standard_normal(H) * 0.5).astype(np.float32)
    B = (rng.standard_normal((b, S, N)) / np.sqrt(N)).astype(np.float32)
    C = (rng.standard_normal((b, S, N)) / np.sqrt(N)).astype(np.float32)
    args = (x, dt, A_log, B, C)
    y, s = ops.ssd_scan(*map(torch.from_numpy, args), chunk=chunk)
    assert y.shape == (b, S, H, P) and s.shape == (b, H, P, N)
    y_k, s_k = jops.ssd_scan(*map(jnp.asarray, args), chunk=chunk)
    y_m, s_m = jssd.ssd_chunked(*map(jnp.asarray, args), chunk)
    for want_y, want_s in ((y_k, s_k), (y_m, s_m)):
        np.testing.assert_allclose(_np(y), np.asarray(want_y), **SSD_TOL)
        np.testing.assert_allclose(_np(s), np.asarray(want_s), **SSD_TOL)


# ------------------------------------------------------------- SSM layer
@pytest.mark.parametrize("S", [16, 13, 2])   # one chunk; Q = 13; S < K-1
def test_ssm_layer_prefill_and_decode_match_reference(S):
    jcfg, cfg = _cfgs("mamba2-780m")
    jp, tp = _params(jcfg, seed=1)
    jl = jax.tree.map(lambda v: v[0], jp["blocks"]["l0"]["ssm"])
    tl = block_params(tp, 0)["l0"]["ssm"]
    rng = np.random.default_rng(S)
    B = 2
    x = rng.standard_normal((B, S, cfg.d_model), np.float32)
    out_t = ssd.ssm_layer(tl, cfg, torch.from_numpy(x))
    out_j = jssd.ssm_layer(jl, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), **SSD_TOL)

    out_t, c_t = ssd.ssm_prefill(tl, cfg, torch.from_numpy(x))
    out_j, c_j = jssd.ssm_prefill(jl, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), **SSD_TOL)
    assert c_t.conv.shape == c_j.conv.shape
    assert c_t.state.dtype == torch.float32
    np.testing.assert_allclose(_np(c_t.conv), np.asarray(c_j.conv),
                               **SSD_TOL)
    np.testing.assert_allclose(_np(c_t.state), np.asarray(c_j.state),
                               **SSD_TOL)
    for step in range(3):
        x1 = rng.standard_normal((B, 1, cfg.d_model), np.float32)
        out_t, c_t = ssd.ssm_decode(tl, cfg, torch.from_numpy(x1), c_t)
        out_j, c_j = jssd.ssm_decode(jl, jcfg, jnp.asarray(x1), c_j)
        np.testing.assert_allclose(_np(out_t), np.asarray(out_j),
                                   err_msg=f"decode step {step}", **SSD_TOL)
    np.testing.assert_allclose(_np(c_t.conv), np.asarray(c_j.conv),
                               **SSD_TOL)
    np.testing.assert_allclose(_np(c_t.state), np.asarray(c_j.state),
                               **SSD_TOL)


# ------------------------------------------------------------ whole models
@pytest.mark.parametrize("arch", list(ARCHS), ids=list(ARCHS))
def test_init_builds_the_reference_tree(arch):
    """Same leaf paths and shapes as the JAX init (hybrid: one ``l{pos}``
    per pattern position, MoE where the JAX init puts it), and the leaves
    the JAX code reads in f32 stay f32 after ``cast_for_serving``."""
    jcfg, cfg = _cfgs(ARCHS[arch])
    shapes = jax.eval_shape(lambda k: japi.init(jcfg, k)[0],
                            jax.ShapeDtypeStruct((2,), "uint32"))
    want = {path: tuple(leaf.shape) for path, leaf in flatten(shapes).items()}
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    got = {path: tuple(t.shape) for path, t in flatten(params).items()}
    assert got == want
    served = flatten(api.cast_for_serving(cfg.replace(dtype="bfloat16"),
                                          params))
    for path, t in served.items():
        leaf = path.split("/")[-1]
        keep = leaf in ("A_log", "D", "dt_bias", "norm", "ln1", "ln2",
                        "final_norm", "router")
        assert t.dtype == (torch.float32 if keep else torch.bfloat16), path


@pytest.mark.parametrize("arch", list(ARCHS), ids=list(ARCHS))
def test_prefill_and_decode_match_reference(arch):
    jcfg, cfg = _cfgs(ARCHS[arch])
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(3)
    B, S, n_steps = 2, 16, 4
    s_max = S + n_steps + 4
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    step_tokens = rng.integers(0, cfg.vocab_size, (n_steps, B))

    lj, cj = jax.jit(lambda p, t: japi.prefill(jcfg, p, {"inputs": t},
                                               s_max))(jp, jnp.asarray(tokens))
    lt, ct = api.prefill(cfg, tp, {"inputs": torch.from_numpy(tokens)},
                         s_max)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), **SSD_TOL)
    jstep = jax.jit(lambda p, t, c: japi.decode_step(jcfg, p, t, c))
    for i in range(n_steps):
        lj, cj = jstep(jp, jnp.asarray(step_tokens[i]), cj)
        lt, ct = api.decode_step(cfg, tp, torch.from_numpy(step_tokens[i]),
                                 ct)
        np.testing.assert_allclose(_np(lt), np.asarray(lj), **SSD_TOL,
                                   err_msg=f"decode step {i}")
    for pos, kind in enumerate(cfg.pattern):
        name = f"l{pos}"
        if kind == "attn":
            assert ct[name].length == S + n_steps
            np.testing.assert_allclose(_np(ct[name].k),
                                       np.asarray(cj[name].k), **SSD_TOL)
        else:
            for field in ("conv", "state"):
                np.testing.assert_allclose(
                    _np(getattr(ct[name], field)),
                    np.asarray(getattr(cj[name], field)), **SSD_TOL,
                    err_msg=f"{name} {field}")


def test_decode_agrees_with_prefill_over_generated_tokens():
    """Port-internal, mamba2 smoke: from a 2-token prompt (the conv tail is
    padded, S < K-1), each decode step's logits equal the prefill logits of
    the prompt extended by the tokens fed so far."""
    _, cfg = _cfgs("mamba2-780m")
    model = api.CausalLM.random(cfg, seed=4, device="cpu")
    rng = np.random.default_rng(4)
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 2)))
    logits, caches = model.prefill(seq, 8)
    for _ in range(5):
        tok = torch.argmax(logits, dim=-1)
        logits, caches = model.decode_step(tok, caches)
        seq = torch.cat([seq, tok[:, None]], dim=1)
        full, _ = model.prefill(seq, seq.shape[1])
        np.testing.assert_allclose(_np(logits), _np(full), **SSD_TOL)


def test_serve_cli_smoke_cpu_mamba2(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", "mamba2-780m", "--smoke", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8", "--tokens", "3"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.startswith("mamba2-780m-smoke on cpu")
    assert len(json.loads(out.split("sequence 0:")[1].strip())) == 3


# ------------------------------------------------------- on the card only
@pytest.mark.cuda
def test_cuda_ssd_chunk_matches_plain():
    """The CUDA ssd_chunk against its plain version, on the card, in f32
    (2e-5), in both layouts and at an odd Q."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: "
                    "python3 chip_smoke.py covers the same checks)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # the last five cross the kernel's groups of 8 heads (H 13, 50), its
    # 64-row tiles (Q 1, 65) and its panel of 4 k-tiles (Q 1024)
    for BC, Q, H, P, N in ((4, 256, 3, 64, 128), (2, 13, 5, 64, 128),
                           (6, 32, 1, 16, 24), (2, 65, 13, 64, 128),
                           (1, 64, 50, 64, 128), (3, 1, 13, 64, 128),
                           (2, 13, 50, 130, 300), (1, 1024, 3, 64, 128)):
        x = torch.randn(BC, Q, H, P, generator=gen, device=dev)
        dt = torch.nn.functional.softplus(
            torch.randn(BC, Q, H, generator=gen, device=dev))
        a = -dt * torch.rand(H, generator=gen, device=dev)
        B = torch.randn(BC, Q, N, generator=gen, device=dev) / N ** 0.5
        C = torch.randn(BC, Q, N, generator=gen, device=dev) / N ** 0.5
        before = ops.LAUNCHES["ssd_chunk"]
        for got, want in zip(ops.ssd_chunk(x, dt, a, B, C),
                             ref.ssd_chunk_ref(x, dt, a, B, C)):
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        assert ops.LAUNCHES["ssd_chunk"] == before + 1
    torch.cuda.synchronize()
