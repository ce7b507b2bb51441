"""Port model tier against ``repro.models`` on smoke configs, in f32, on the CPU.

Weights come from the JAX init, exported with ``np.asarray`` and loaded
with ``repro_torch.weights.from_jax_params``, so both sides compute with
the same numbers.  The reference is ``repro.models.api`` (and its layers)
called with no logical rules installed, not ``launch/steps.py``.
Tolerances: 2e-5 for single layers (f32 kernels' tolerance), 1e-4 for
logits after the whole stack (f32 sums taken in other orders through a few
layers and the unembed).
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
from repro.models import layers as jL  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.base import set_logical_rules  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import api, layers as L, moe  # noqa: E402
from repro_torch.models.spec import ModelConfig  # noqa: E402
from repro_torch.models.transformer import block_params  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["granite-moe-1b-a400m", "qwen3-1.7b"]   # MoE; dense with qk-norm


@pytest.fixture(autouse=True)
def _no_logical_rules():
    # xdist workers share a process across test files; an earlier test may
    # have installed mesh rules (base.py: set_logical_rules is global).
    set_logical_rules(None)
    yield
    set_logical_rules(None)


def _cfgs(arch: str):
    jcfg = jconfigs.get_smoke_config(arch).replace(dtype="float32")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _params(jcfg, seed=0):
    jp, _ = japi.init(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jp)
    return jp, from_jax_params(tree)


def _np(t):
    return t.detach().float().numpy()


def _block0(tree):
    return jax.tree.map(lambda v: v[0], tree)


def test_registry_copies_reference_configs():
    """The port's ModelConfig and registry entries are copies of the JAX
    ones."""
    assert configs.list_archs() == [
        "granite-moe-1b-a400m", "jamba-1.5-large-398b", "mamba2-780m"]
    for arch in configs.list_archs():
        for get in ("get_config", "get_smoke_config"):
            ours = getattr(configs, get)(arch)
            theirs = getattr(jconfigs, get)(arch)
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert [f.name for f in dataclasses.fields(ModelConfig)] == [
        f.name for f in dataclasses.fields(type(theirs))]
    with pytest.raises(ValueError, match="not yet ported"):
        configs.get_config("whisper-medium")


# ------------------------------------------------------------------- layers
def test_layers_match_reference():
    jcfg, cfg = _cfgs("granite-moe-1b-a400m")
    jp, tp = _params(jcfg)
    jb, tb = _block0(jp["blocks"]["l0"]), block_params(tp, 0)["l0"]
    rng = np.random.default_rng(0)
    B, S, s_max = 2, 16, 24
    x = rng.standard_normal((B, S, cfg.d_model), np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)

    np.testing.assert_allclose(
        _np(L.rmsnorm(xt, tb["ln1"], cfg.norm_eps)),
        np.asarray(jL.rmsnorm(xj, jb["ln1"], jcfg.norm_eps)), **LAYER_TOL)

    h = rng.standard_normal((B, S, cfg.n_heads, cfg.d_head), np.float32)
    pos = np.broadcast_to(np.arange(3, 3 + S), (B, S))
    np.testing.assert_allclose(
        _np(L.apply_rope(torch.from_numpy(h), torch.from_numpy(pos.copy()),
                         cfg.rope_theta)),
        np.asarray(jL.apply_rope(jnp.asarray(h), jnp.asarray(pos),
                                 jcfg.rope_theta)), **LAYER_TOL)

    out_t, c_t = L.attention_prefill(tb["attn"], cfg, xt, s_max)
    out_j, c_j = jL.attention_prefill(jb["attn"], jcfg, xj, s_max)
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), **LAYER_TOL)
    np.testing.assert_allclose(_np(c_t.k), np.asarray(c_j.k), **LAYER_TOL)
    np.testing.assert_allclose(_np(c_t.v), np.asarray(c_j.v), **LAYER_TOL)
    assert c_t.length == int(c_j.length) == S

    x1 = rng.standard_normal((B, 1, cfg.d_model), np.float32)
    out_t, c_t = L.attention_decode(tb["attn"], cfg, torch.from_numpy(x1),
                                    c_t)
    out_j, c_j = jL.attention_decode(jb["attn"], jcfg, jnp.asarray(x1), c_j)
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), **LAYER_TOL)
    np.testing.assert_allclose(_np(c_t.k), np.asarray(c_j.k), **LAYER_TOL)
    assert c_t.length == int(c_j.length) == S + 1


# ---------------------------------------------------------------------- MoE
@pytest.mark.parametrize("hot_expert", [False, True])
def test_moe_gather_matches_reference(hot_expert):
    """Routing, capacity drops, aux loss and combine match ``moe_gather``;
    with one hot expert (forced through the router weights) the per-row
    capacity drops most of its assignments, and the same ones."""
    jcfg, cfg = _cfgs("granite-moe-1b-a400m")
    jp, tp = _params(jcfg, seed=1)
    jm = _block0(jp["blocks"]["l0"]["moe"])
    tm = block_params(tp, 0)["l0"]["moe"]
    rng = np.random.default_rng(2)
    B, S = 2, 64
    x = rng.standard_normal((B, S, cfg.d_model), np.float32)
    if hot_expert:
        x = np.abs(x) + 0.5          # every token has a large positive sum
        router = np.asarray(jm["router"]).copy()
        router[:, 0] = 1.0           # so expert 0 wins every token
        jm = dict(jm, router=jnp.asarray(router))
        tm = dict(tm, router=torch.from_numpy(router))
        probs = torch.softmax(torch.from_numpy(x) @ tm["router"], -1)
        top = torch.topk(probs, cfg.top_k, dim=-1).indices
        per_row = (top == 0).sum(dim=(1, 2))
        assert (per_row > jmoe._capacity(jcfg, S)).all()   # drops happen
    y_t, aux_t = moe.moe_gather(tm, cfg, torch.from_numpy(x))
    y_j, aux_j = jmoe.moe_gather(jm, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j), **LAYER_TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)


# ------------------------------------------------------- prefill + decode
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(3)
    B, S, n_steps = 2, 16, 4
    s_max = S + n_steps + 4
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    step_tokens = rng.integers(0, cfg.vocab_size, (n_steps, B))

    lj, cj = jax.jit(lambda p, t: japi.prefill(jcfg, p, {"inputs": t},
                                               s_max))(jp, jnp.asarray(tokens))
    lt, ct = api.prefill(cfg, tp, torch.from_numpy(tokens), s_max)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), **LOGIT_TOL)
    np.testing.assert_allclose(_np(ct["l0"].k), np.asarray(cj["l0"].k),
                               **LOGIT_TOL)
    np.testing.assert_allclose(_np(ct["l0"].v), np.asarray(cj["l0"].v),
                               **LOGIT_TOL)

    jstep = jax.jit(lambda p, t, c: japi.decode_step(jcfg, p, t, c))
    for i in range(n_steps):
        lj, cj = jstep(jp, jnp.asarray(step_tokens[i]), cj)
        lt, ct = api.decode_step(cfg, tp, torch.from_numpy(step_tokens[i]),
                                 ct)
        np.testing.assert_allclose(_np(lt), np.asarray(lj), **LOGIT_TOL,
                                   err_msg=f"decode step {i}")
    np.testing.assert_allclose(_np(ct["l0"].k), np.asarray(cj["l0"].k),
                               **LOGIT_TOL)
    assert ct["l0"].length == S + n_steps


def test_decode_agrees_with_prefill_over_generated_tokens():
    """Port-internal: logits of each decode step equal the prefill logits
    of the prompt extended by the tokens fed so far.  Sequences stay at 8
    tokens or fewer: a token picks an expert at most once, so no expert can
    exceed the capacity floor of 8 and neither path drops an assignment
    (over longer sequences prefill may drop where decode does not)."""
    _, cfg = _cfgs("granite-moe-1b-a400m")
    model = api.CausalLM.random(cfg, seed=4, device="cpu")
    rng = np.random.default_rng(4)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 4)))
    logits, caches = model.prefill(prompt, 12)
    seq = prompt
    for _ in range(4):
        tok = torch.argmax(logits, dim=-1)
        logits, caches = model.decode_step(tok, caches)
        seq = torch.cat([seq, tok[:, None]], dim=1)
        full, _ = model.prefill(seq, seq.shape[1])
        np.testing.assert_allclose(_np(logits), _np(full), **LOGIT_TOL)


def test_unported_families_raise():
    """Encoder-decoder, VLM and sliding-window attention still raise,
    naming their ROADMAP item."""
    cfgs = [_cfgs(arch)[1] for arch in ("whisper-medium", "phi-3-vision-4.2b")]
    cfgs.append(_cfgs("granite-moe-1b-a400m")[1].replace(sliding_window=16))
    for cfg in cfgs:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            api.init(cfg, torch.Generator().manual_seed(0), device="cpu")


def test_serve_cli_smoke_cpu(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                     "--prompt-len", "8", "--tokens", "3"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "tok/s" in out
    seq = out.split("sequence 0:")[1].strip()
    assert len(json.loads(seq)) == 3
