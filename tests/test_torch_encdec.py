"""Port encoder-decoder (whisper) and VLM trees against ``repro.models``, on
smoke configs, in f32, on the CPU.

Weights come from the JAX init, exported with ``np.asarray`` and loaded
with ``repro_torch.weights.from_jax_params``; inputs are numpy arrays made
from a seed and given to both.  The reference is ``repro.models.encdec``
(and its layers) called with no logical rules installed.  Tolerances as in
``test_torch_model.py``: 2e-5 for one layer (the f32 kernels' tolerance),
1e-4 after a stack of layers (the encoder, the logits): f32 sums taken in
other orders through a few layers.
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
from repro.models import api as japi  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models.base import set_logical_rules  # noqa: E402
from repro_torch.models import api, encdec, layers as L  # noqa: E402
from repro_torch.models.spec import ModelConfig  # noqa: E402
from repro_torch.models.transformer import layer_slice  # noqa: E402
from repro_torch.weights import flatten, from_jax_params  # noqa: E402

LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
STACK_TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "whisper-medium"


@pytest.fixture(autouse=True)
def _no_logical_rules():
    # xdist workers share a process across test files; an earlier test may
    # have installed mesh rules (base.py: set_logical_rules is global).
    set_logical_rules(None)
    yield
    set_logical_rules(None)


def _cfgs(arch: str = ARCH):
    jcfg = jconfigs.get_smoke_config(arch).replace(dtype="float32")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _params(jcfg, seed=0):
    jp, _ = japi.init(jcfg, jax.random.PRNGKey(seed))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _np(t):
    return t.detach().float().numpy()


def _enc_embeds(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.enc_frames, cfg.d_model), np.float32)


@pytest.mark.parametrize("arch", ["whisper-medium", "phi-3-vision-4.2b"])
def test_init_and_loader_carry_the_reference_tree(arch):
    """``api.init`` builds the reference's tree (``enc``/``dec`` stacked
    over their layers and ``enc_norm``, or ``mm_proj``) with its shapes, and
    ``from_jax_params`` carries every leaf of a JAX tree across unchanged."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    jflat = {k: np.asarray(v) for k, v in flatten(jp).items()}
    tflat = flatten(tp)
    assert tflat.keys() == jflat.keys()
    for path, arr in jflat.items():
        np.testing.assert_array_equal(tflat[path].numpy(), arr, err_msg=path)
    ours = flatten(api.init(cfg, torch.Generator().manual_seed(0),
                            device="cpu"))
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: v.shape for k, v in jflat.items()}
    wanted = {"enc_norm", "enc/ln1", "dec/ln_x", "dec/xattn/wq"} \
        if cfg.is_encoder_decoder else {"mm_proj"}
    assert wanted <= ours.keys()


def test_encoder_layers_match_reference():
    """``attention(causal=False)``, ``encode_kv`` and ``cross_attention``
    against the reference's layers (one layer: 2e-5), and ``encode`` (the
    whole encoder: 1e-4)."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(1)
    B, S = 2, 12
    frames = rng.standard_normal((B, cfg.enc_frames, cfg.d_model), np.float32)
    x = rng.standard_normal((B, S, cfg.d_model), np.float32)
    je = jax.tree.map(lambda v: v[0], jp["enc"])
    jd = jax.tree.map(lambda v: v[0], jp["dec"])
    te, td = layer_slice(tp["enc"], 0), layer_slice(tp["dec"], 0)

    np.testing.assert_allclose(
        _np(L.attention(te["attn"], cfg, torch.from_numpy(frames),
                        causal=False)),
        np.asarray(jL.attention(je["attn"], jcfg, jnp.asarray(frames),
                                causal=False)), **LAYER_TOL)
    tk, tv = L.encode_kv(td["xattn"], cfg, torch.from_numpy(frames))
    jk, jv = jL.encode_kv(jd["xattn"], jcfg, jnp.asarray(frames))
    np.testing.assert_allclose(_np(tk), np.asarray(jk), **LAYER_TOL)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), **LAYER_TOL)
    np.testing.assert_allclose(
        _np(L.cross_attention(td["xattn"], cfg, torch.from_numpy(x), tk, tv)),
        np.asarray(jL.cross_attention(jd["xattn"], jcfg, jnp.asarray(x), jk,
                                      jv)), **LAYER_TOL)
    np.testing.assert_allclose(
        _np(encdec.encode(cfg, tp, torch.from_numpy(frames))),
        np.asarray(jencdec.encode(jcfg, jp, jnp.asarray(frames))),
        **STACK_TOL)


def test_prefill_and_decode_match_reference():
    """Prefill logits, the self-attention caches and the cross K/V kept
    for decode, then 4 decode steps, against ``repro.models.encdec``."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(3)
    B, S, n_steps = 2, 16, 4
    s_max = S + n_steps + 4
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    frames = _enc_embeds(cfg, B, 4)
    step_tokens = rng.integers(0, cfg.vocab_size, (n_steps, B))

    lj, cj = jax.jit(lambda p, t, e: japi.prefill(
        jcfg, p, {"inputs": t, "enc_embeds": e}, s_max))(
            jp, jnp.asarray(tokens), jnp.asarray(frames))
    lt, ct = api.prefill(cfg, tp, {"inputs": torch.from_numpy(tokens),
                                   "enc_embeds": torch.from_numpy(frames)},
                         s_max)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), **STACK_TOL)
    for name in ("cross_k", "cross_v"):
        got, want = getattr(ct, name), np.asarray(getattr(cj, name))
        assert tuple(got.shape) == want.shape == (
            cfg.n_layers, B, cfg.enc_frames, cfg.n_kv_heads, cfg.d_head)
        np.testing.assert_allclose(_np(got), want, **STACK_TOL)
    np.testing.assert_allclose(_np(ct.self_kv.k), np.asarray(cj.self_kv.k),
                               **STACK_TOL)
    np.testing.assert_allclose(_np(ct.self_kv.v), np.asarray(cj.self_kv.v),
                               **STACK_TOL)
    assert ct.self_kv.length == S

    jstep = jax.jit(lambda p, t, c: japi.decode_step(jcfg, p, t, c))
    for i in range(n_steps):
        lj, cj = jstep(jp, jnp.asarray(step_tokens[i]), cj)
        lt, ct = api.decode_step(cfg, tp, torch.from_numpy(step_tokens[i]),
                                 ct)
        np.testing.assert_allclose(_np(lt), np.asarray(lj), **STACK_TOL,
                                   err_msg=f"decode step {i}")
    np.testing.assert_allclose(_np(ct.self_kv.k), np.asarray(cj.self_kv.k),
                               **STACK_TOL)
    assert ct.self_kv.length == S + n_steps


def test_decode_agrees_with_prefill_over_generated_tokens():
    """Port-internal: each decode step's logits equal the prefill logits of
    the prompt extended by the tokens fed so far, on the same frames."""
    _, cfg = _cfgs()
    model = api.CausalLM.random(cfg, seed=4, device="cpu")
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 4)))
    frames = torch.from_numpy(_enc_embeds(cfg, 2, 6))
    logits, caches = model.prefill(prompt, 12, enc_embeds=frames)
    seq = prompt
    for _ in range(4):
        tok = torch.argmax(logits, dim=-1)
        logits, caches = model.decode_step(tok, caches)
        seq = torch.cat([seq, tok[:, None]], dim=1)
        full, _ = model.prefill(seq, seq.shape[1], enc_embeds=frames)
        np.testing.assert_allclose(_np(logits), _np(full), **STACK_TOL)


def test_missing_frames_raise():
    _, cfg = _cfgs()
    model = api.CausalLM.random(cfg, seed=0, device="cpu")
    tokens = torch.zeros(2, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="enc_embeds"):
        model.prefill(tokens, 8)
    with pytest.raises(ValueError, match="enc_embeds"):
        model.prefill(tokens, 8, enc_embeds=torch.zeros(2, 5, 3))


def test_serve_cli_whisper_smoke_cpu(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8", "--tokens", "3"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "enc_embeds [2, 32, 64]" in out and "tok/s" in out
    assert len(json.loads(out.split("sequence 0:")[1].strip())) == 3
