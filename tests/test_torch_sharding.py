"""The port's sharding rules and spec trees against ``repro``, pure Python.

``api.param_specs`` against the reference's logical axes
(``launch.specs.state_shapes(cfg)[1]``, through ``eval_shape``, which
allocates nothing) for all ten registry configs at full size;
``Optimizer.state_specs`` for ``adamw``, ``with_master(adamw)`` and
``adafactor``; ``rules_for`` for every workload kind, ``multi_pod``,
``fsdp`` and ``seq_shard``; and, per config and rule set, the fitted
param specs, the batch spec and the cache specs on the production layouts
(16 x 16 single-pod with ``multi_pod=False``, 2 x 16 x 16 with it), as
``jax.sharding.PartitionSpec`` tuples.  The step builders' specs on those
layouts, built from axis sizes alone, are held to the reference's
composition in ``repro.launch.steps`` (which cannot itself run on jax
0.9.0, ROADMAP): the train step's state and batch, prefill's ``head_dim``
switch and serve's ``ffn_chunks``.

Test ids name a config by its module (``jamba_1_5_large_398b``): these
checks take milliseconds, and the conftest's slow tier is for the jamba
smoke model's runs.
"""
import functools
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models.base import logical_to_pspec as jl2p  # noqa: E402
from repro.parallel import sharding as js  # noqa: E402
from repro_torch import configs, optim  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import specs, steps  # noqa: E402
from repro_torch.launch.mesh import PRODUCTION_SHAPES  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.spec import PartitionSpec, logical_to_pspec  # noqa
from repro_torch.parallel import sharding as ps  # noqa: E402
from repro_torch.weights import flatten  # noqa: E402

ARCHS = configs.list_archs()
IDS = [a.replace("-", "_").replace(".", "_") for a in ARCHS]
KINDS = list(ps.WorkloadKind)
RULE_CASES = list(itertools.product(KINDS, (False, True), (True, False),
                                    (False, True)))
RULE_IDS = [f"{k.value}-{'pod' if m else 'single'}-"
            f"{'fsdp' if f else 'nofsdp'}-{'seq' if s else 'noseq'}"
            for k, m, f, s in RULE_CASES]


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _layout(multi_pod: bool):
    return PRODUCTION_SHAPES[1] if multi_pod else PRODUCTION_SHAPES[0]


def _is_p(x):
    return isinstance(x, P)


def _flat_p(tree):
    """A reference spec tree (dicts, caches) -> {path: tuple}."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_p)
    return {jax.tree_util.keystr(k): tuple(v) for k, v in leaves}


def _flat_port(tree):
    """A port spec tree (dicts, caches) -> {path: tuple}, keyed as
    :func:`_flat_p` keys the reference's."""
    out = {}

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{key}[{k!r}]")
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for f, v in zip(node._fields, node):
                walk(v, f"{key}.{f}")
        else:
            out[key] = tuple(node)
    walk(tree, "")
    return out


@functools.lru_cache(maxsize=None)
def _ref_state(arch: str):
    """The reference's (param shapes, logical axes) at full size."""
    params, specs, _ = jspecs.state_shapes(jconfigs.get_config(arch))
    return params, specs


@functools.lru_cache(maxsize=None)
def _port_state(arch: str):
    return specs.state_shapes(configs.get_config(arch))[:2]


def _cache_shape(kind):
    return SHAPES["long_500k" if kind == ps.WorkloadKind.LONG_DECODE
                  else "decode_32k"]


@functools.lru_cache(maxsize=None)
def _ref_caches(arch: str, shape_name: str):
    return jspecs.cache_specs_shapes(jconfigs.get_config(arch),
                                     SHAPES[shape_name])


@functools.lru_cache(maxsize=None)
def _port_caches(arch: str, shape_name: str):
    return specs.cache_specs_shapes(configs.get_config(arch),
                                    SHAPES[shape_name])


# ------------------------------------------------------------ spec trees
@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_param_specs_match_reference(arch):
    _, want = _ref_state(arch)
    got = api.param_specs(configs.get_config(arch))
    want = {k: tuple(v) for k, v in flatten(want).items()}
    assert flatten(got) == want
    meta = flatten(api.init(configs.get_config(arch), torch.Generator(),
                            "meta"))
    assert meta.keys() == want.keys()
    assert all(t.ndim == len(want[k]) and t.device.type == "meta"
               for k, t in meta.items())


OPTIMIZERS = {
    "adamw": (lambda s: optim.adamw(s), lambda s: joptim.adamw(s)),
    "with_master_adamw": (lambda s: optim.with_master(optim.adamw(s)),
                          lambda s: joptim.with_master(joptim.adamw(s))),
    "adafactor": (lambda s: optim.adafactor(s),
                  lambda s: joptim.adafactor(s)),
}


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_state_specs_match_reference(arch, opt):
    """Adafactor's factored leaves drop an axis: ``vr`` its last,
    ``vc`` its second to last."""
    mine, theirs = OPTIMIZERS[opt]
    jparams, jspec = _ref_state(arch)
    want = theirs(joptim.cosine_with_warmup(1e-3, 10, 100)).state_specs(
        jspec, jparams)
    pparams, pspec = _port_state(arch)
    got = mine(optim.cosine_with_warmup(1e-3, 10, 100)).state_specs(
        pspec, pparams)
    assert {k: tuple(v) for k, v in flatten(got).items()} == \
        {k: tuple(v) for k, v in flatten(want).items()}
    if opt == "adafactor":
        flat = flatten(got)
        assert any(k.endswith("/vr") for k in flat)
        assert any(k.endswith("/v") for k in flat)


# ------------------------------------------------------------------ rules
@pytest.mark.parametrize("kind,multi_pod,fsdp,seq_shard", RULE_CASES,
                         ids=RULE_IDS)
def test_rules_match_reference(kind, multi_pod, fsdp, seq_shard):
    got = ps.rules_for(kind, multi_pod, fsdp, seq_shard)
    want = js.rules_for(js.WorkloadKind(kind.value), multi_pod, fsdp,
                        seq_shard)
    assert got == want
    for axes in (("embed", "heads", "head_dim"), ("batch", "seq", "heads"),
                 ("tokens", "experts", "mlp"), ("experts", "expert_embed",
                                                "expert_mlp"),
                 ("batch", "cache_seq", "kv_heads", "head_dim")):
        assert tuple(logical_to_pspec(axes, got)) == tuple(jl2p(axes, want))
    assert tuple(ps.batch_pspec(got, 3)) == tuple(js.batch_pspec(want, 3))


@pytest.mark.parametrize("kind,multi_pod,fsdp,seq_shard", RULE_CASES,
                         ids=RULE_IDS)
@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_fitted_specs_match_reference(arch, kind, multi_pod, fsdp,
                                      seq_shard):
    """Params and decode caches, fitted on the production layout."""
    layout = _layout(multi_pod)
    rules = ps.rules_for(kind, multi_pod, fsdp, seq_shard)
    jrules = js.rules_for(js.WorkloadKind(kind.value), multi_pod, fsdp,
                          seq_shard)
    jparams, jspec = _ref_state(arch)
    pparams, pspec = _port_state(arch)
    want = js.fit_tree(js.param_pspecs(jspec, jrules), jparams,
                       FakeMesh(layout))
    got = ps.fit_tree(ps.param_pspecs(pspec, rules), pparams, layout)
    assert _flat_port(got) == _flat_p(want)

    name = _cache_shape(kind).name
    jc, pc = _ref_caches(arch, name), _port_caches(arch, name)
    cfg = configs.get_config(arch)
    want = js.fit_tree(js.cache_pspecs(jconfigs.get_config(arch), jc,
                                       jrules), jc, FakeMesh(layout))
    got = ps.fit_tree(ps.cache_pspecs(cfg, pc, rules), pc, layout)
    want, got = _flat_p(want), _flat_port(got)
    # a KV cache's length: [blocks] int32 in the reference, a Python int
    # in the port (its decode writes in place), replicated in both
    lengths = {k for k in want if k.endswith(".length")}
    assert all(got[k] == () and want[k] == (None,) for k in lengths)
    assert {k: v for k, v in got.items() if k not in lengths} == \
        {k: v for k, v in want.items() if k not in lengths}


def test_fit_pspec_drops_what_does_not_divide():
    mesh = {"pod": 2, "data": 16, "model": 16}
    assert ps.fit_pspec(PartitionSpec(None, "model", None), (28, 2, 128),
                        mesh) == (None, None, None)
    assert ps.fit_pspec(PartitionSpec(("pod", "data"), "model"), (64, 32),
                        mesh) == (("pod", "data"), "model")
    assert ps.fit_pspec(PartitionSpec(("pod", "data")), (48, 5),
                        FakeMesh(mesh)) == (None, None)


def test_partition_spec_and_placements():
    spec = PartitionSpec(("data",), None, ("pod", "data"), "model")
    assert spec == ("data", None, ("pod", "data"), "model")
    assert tuple(spec) == tuple(P(("data",), None, ("pod", "data"),
                                  "model"))
    assert ps.placements({"pod": 2, "data": 4, "model": 2},
                         PartitionSpec(("pod", "data"), None, "model")) == \
        {"pod": 0, "data": 0, "model": 2}
    assert ps.placements({"data": 4, "model": 2}, PartitionSpec(None)) == \
        {"data": None, "model": None}
    assert PRODUCTION_SHAPES == ({"data": 16, "model": 16},
                                 {"pod": 2, "data": 16, "model": 16})


# ------------------------------------------------------------ step specs
@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "pod"])
@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_train_step_specs_match_reference(arch, multi_pod):
    """``make_train_step`` on axis sizes: params, with_master(adamw)'s
    state and the batch, as ``repro.launch.steps.make_train_step``
    composes them (state axes from the logical param axes)."""
    layout = _layout(multi_pod)
    cfg = configs.get_config(arch)
    opt = optim.with_master(optim.adamw(optim.cosine_with_warmup(1e-3, 1,
                                                                 9)))
    _, (p_got, o_got, b_got), (p_out, _, scal), _ = steps.make_train_step(
        cfg, opt, layout, multi_pod=multi_pod)
    assert p_out is p_got and scal == {"loss": (), "grad_norm": ()}

    jcfg = jconfigs.get_config(arch)
    jopt = joptim.with_master(joptim.adamw(joptim.cosine_with_warmup(
        1e-3, 1, 9)))
    rules = js.rules_for(js.WorkloadKind.TRAIN, multi_pod)
    params_s, sp_, opt_s = jspecs.state_shapes(
        jcfg.replace(param_dtype=jcfg.dtype), jopt)
    mesh = FakeMesh(layout)
    p_want = js.fit_tree(js.param_pspecs(sp_, rules), params_s, mesh)
    o_want = js.fit_tree(jax.tree.map(
        lambda ax: jl2p(tuple(ax), rules), jopt.state_specs(sp_, params_s),
        is_leaf=lambda x: isinstance(x, tuple)), opt_s, mesh)
    assert _flat_port(p_got) == _flat_p(p_want)
    assert _flat_port(o_got) == _flat_p(o_want)
    b_want = {"inputs": js.batch_pspec(rules, 2),
              "targets": js.batch_pspec(rules, 2)}
    if cfg.n_img_tokens:
        b_want["img_embeds"] = js.batch_pspec(rules, 3)
    if cfg.is_encoder_decoder:
        b_want["enc_embeds"] = js.batch_pspec(rules, 3)
    assert _flat_port(b_got) == _flat_p(b_want)


def _ref_cache_specs(arch, rules, shape, layout):
    caches = jspecs.cache_specs_shapes(jconfigs.get_config(arch), shape)
    return _flat_p(js.fit_tree(js.cache_pspecs(jconfigs.get_config(arch),
                                               caches, rules), caches,
                               FakeMesh(layout)))


def _without_lengths(flat):
    return {k: v for k, v in flat.items() if not k.endswith(".length")}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "pod"])
@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_prefill_step_shards_the_cache_on_head_dim(arch, multi_pod):
    """kv_heads that do not divide ``model`` (16) move the cache's shard
    onto ``head_dim``; the logits are vocab-sharded when the vocab
    divides."""
    layout = _layout(multi_pod)
    cfg = configs.get_config(arch)
    shape = SHAPES["prefill_32k"]
    step, (p_got, b_got), (l_got, c_got), params_s = \
        steps.make_prefill_step(cfg, layout, shape, multi_pod=multi_pod)
    rules = js.rules_for(js.WorkloadKind.PREFILL, multi_pod)
    switched = cfg.n_kv_heads % 16 != 0
    if switched:
        rules["kv_heads"], rules["head_dim"] = None, "model"
    assert (step.rules["head_dim"] == "model") == switched
    assert _without_lengths(_flat_port(c_got)) == _without_lengths(
        _ref_cache_specs(arch, rules, shape, layout))
    jparams, jspec = _ref_state(arch)
    assert _flat_port(p_got) == _flat_p(js.fit_tree(
        js.param_pspecs(jspec, rules), jparams, FakeMesh(layout)))
    assert "targets" not in b_got
    vshard = "model" if cfg.vocab_size % 16 == 0 else None
    assert tuple(l_got) == tuple(P(rules["batch"], vshard))
    assert all(t.device.type == "meta" for t in flatten(params_s).values())


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_serve_step_chunks_wide_ffns_and_shards_the_cache(arch, shape_name):
    """An FFN of d_ff >= 16384 runs in 4 chunks unless the config sets
    its own; one sequence is long decode (the cache's sequence over
    ``data``)."""
    layout = PRODUCTION_SHAPES[0]
    cfg = configs.get_config(arch)
    shape = SHAPES[shape_name]
    step, (_, t_got, c_got), (_, c_out), (_, cache_s) = \
        steps.make_serve_step(cfg, layout, shape)
    assert step.cfg.ffn_chunks == (
        4 if cfg.d_ff >= 16384 and cfg.ffn_chunks == 1 else cfg.ffn_chunks)
    kind = (js.WorkloadKind.LONG_DECODE if shape.global_batch == 1
            else js.WorkloadKind.DECODE)
    rules = js.rules_for(kind)
    assert step.rules == rules and c_out is c_got
    assert tuple(t_got) == tuple(P(rules["batch"]))
    assert _without_lengths(_flat_port(c_got)) == _without_lengths(
        _ref_cache_specs(arch, rules, shape, layout))
    seen = []
    ps.tree_map(seen.append, cache_s)
    assert all(t.device.type == "meta" for t in seen
               if isinstance(t, torch.Tensor))


def test_a_step_built_from_axis_sizes_does_not_run():
    cfg = configs.get_smoke_config("granite-moe-1b-a400m")
    step = steps.make_train_step(cfg, optim.adamw(lambda c: 1e-3),
                                 {"data": 2, "model": 2})[0]
    with pytest.raises(TypeError, match="axis sizes only"):
        step({}, {}, {})


@pytest.mark.parametrize("n_chunks", [1, 4])
def test_chunked_mlp_matches_reference(n_chunks):
    """The serve step's ``ffn_chunks``: the dense FFN over ``n_chunks``
    slices of its hidden dim, summed in order, against the reference's
    (f32, 2e-5)."""
    import jax.numpy as jnp
    import numpy as np
    from repro.models import layers as jlayers
    from repro_torch.models import layers

    rng = np.random.default_rng(n_chunks)
    p = {"wi_gate": rng.standard_normal((64, 128), np.float32) / 8,
         "wi_up": rng.standard_normal((64, 128), np.float32) / 8,
         "wo": rng.standard_normal((128, 64), np.float32) / 11}
    x = rng.standard_normal((2, 5, 64), np.float32)
    want = np.asarray(jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x), n_chunks=n_chunks))
    got = layers.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), n_chunks).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
