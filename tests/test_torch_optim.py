"""Port optimizers, schedule, clipping and gradient compression against
``repro.optim`` and ``repro.runtime.compression``, on the CPU.

The same numpy params and gradients go to both; after three updates the
params and every state leaf agree within 1e-6 (f32 arithmetic in the same
order; sums such as means and norms are taken in other orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.runtime import compression as jcomp  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.runtime import compression  # noqa: E402
from repro_torch.weights import flatten  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
# one leaf Adafactor factors (both trailing dims >= 128), one it does not,
# a stacked factored leaf, and a vector
SHAPES = {"w": (160, 128), "small": (24, 40), "stack": {"e": (2, 128, 136)},
          "b": (40,)}


def _tree(rng, scale=1.0, shapes=SHAPES):
    return {k: (_tree(rng, scale, v) if isinstance(v, dict) else
                (scale * rng.standard_normal(v)).astype(np.float32))
            for k, v in shapes.items()}


def _to_torch(tree, dtype=torch.float32):
    return {k: (_to_torch(v, dtype) if isinstance(v, dict)
                else torch.from_numpy(np.asarray(v, np.float32)).to(dtype))
            for k, v in tree.items()}


def _to_jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _close(torch_tree, jax_tree, **tol):
    a = flatten(torch_tree)
    b = flatten(jax.tree.map(np.asarray, jax_tree))
    assert set(a) == set(b)
    for path in b:
        np.testing.assert_allclose(a[path].float().numpy(),
                                   np.asarray(b[path], np.float32),
                                   err_msg=path, **(tol or TOL))


def _run(jopt, opt, jparams, params, grads_np):
    jstate, state = jopt.init(jparams), opt.init(params)
    for g in grads_np:
        jparams, jstate = jopt.update(_to_jax(g), jstate, jparams)
        params, state = opt.update(_to_torch(g), state, params)
    return jparams, jstate, params, state


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_reference(weight_decay):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng, 0.1) for _ in range(3)]
    jp, js, tp, ts = _run(
        joptim.adamw(joptim.cosine_with_warmup(1e-2, 2, 10),
                     weight_decay=weight_decay),
        optim.adamw(optim.cosine_with_warmup(1e-2, 2, 10),
                    weight_decay=weight_decay),
        _to_jax(p0), _to_torch(p0), grads)
    _close(tp, jp)
    _close(ts, js)
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 3


def test_adafactor_matches_reference():
    """Factored second moments (``vr``, ``vc``) on the leaves whose last two
    dims reach ``min_dim_size_to_factor``, a full ``v`` on the rest, and
    update clipping: the state tree has the reference's paths."""
    rng = np.random.default_rng(1)
    p0 = _tree(rng)
    grads = [_tree(rng, 0.1) for _ in range(3)]
    sched = (joptim.cosine_with_warmup(1e-2, 1, 10),
             optim.cosine_with_warmup(1e-2, 1, 10))
    jp, js, tp, ts = _run(joptim.adafactor(sched[0], weight_decay=0.01),
                          optim.adafactor(sched[1], weight_decay=0.01),
                          _to_jax(p0), _to_torch(p0), grads)
    _close(tp, jp)
    _close(ts, js)
    assert set(ts["v"]["w"]) == {"vr", "vc"}
    assert set(ts["v"]["small"]) == {"v"}
    assert ts["v"]["stack"]["e"]["vc"].shape == (2, 136)


def test_with_master_adamw_bf16_matches_reference():
    """bf16 working params with an f32 master: the master and moments agree
    within 1e-6, the bf16 params within one bf16 rounding."""
    rng = np.random.default_rng(2)
    p0 = _tree(rng)
    grads = [_tree(rng, 0.1) for _ in range(3)]
    jopt = joptim.with_master(joptim.adamw(joptim.cosine_with_warmup(
        1e-2, 2, 10)))
    opt = optim.with_master(optim.adamw(optim.cosine_with_warmup(1e-2, 2,
                                                                 10)))
    jparams, params = _to_jax(p0, jnp.bfloat16), _to_torch(p0, torch.bfloat16)
    jp, js, tp, ts = _run(jopt, opt, jparams, params, grads)
    assert all(t.dtype == torch.bfloat16 for t in flatten(tp).values())
    assert all(t.dtype == torch.float32
               for t in flatten(ts["master"]).values())
    _close(ts, js)
    _close(tp, jp, rtol=2 ** -7, atol=1e-6)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    g = _tree(rng, 0.5)
    for max_norm in (1.0, 1e3):
        jg, jn = joptim.clip_by_global_norm(_to_jax(g), max_norm)
        tg, tn = optim.clip_by_global_norm(_to_torch(g), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        np.testing.assert_allclose(float(optim.global_norm(_to_torch(g))),
                                   float(joptim.global_norm(_to_jax(g))),
                                   rtol=1e-6)
        _close(tg, jg)


def test_cosine_with_warmup_matches_reference():
    ours = optim.cosine_with_warmup(3e-4, 10, 100, final_frac=0.1)
    theirs = joptim.cosine_with_warmup(3e-4, 10, 100, final_frac=0.1)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(ours(step)), float(theirs(step)),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(
            float(ours(torch.tensor(step, dtype=torch.int32))),
            float(theirs(jnp.asarray(step, jnp.int32))), rtol=1e-6, atol=0)


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_compression_matches_reference(codec):
    """The codecs' round trips, and int8's error feedback over three steps
    (the residual carried from one step to the next)."""
    rng = np.random.default_rng(4)
    init, apply = compression.make_compressor(codec)
    jinit, japply = jcomp.make_compressor(codec)
    g0 = _tree(rng)
    state, jstate = init(_to_torch(g0)), jinit(_to_jax(g0))
    for _ in range(3):
        g = _tree(rng)
        out, state = apply(_to_torch(g), state)
        jout, jstate = japply(_to_jax(g), jstate)
        _close(out, jout, rtol=1e-6, atol=1e-7)
        if codec == "int8":
            _close(state.error, jstate.error, rtol=1e-5, atol=1e-7)
        else:
            assert state.error is None and jstate.error is None
    with pytest.raises(ValueError, match="codec"):
        compression.make_compressor("fp4")
