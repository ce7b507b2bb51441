"""Tensor- and expert-parallel compute on the ``model`` axis
(``repro_torch.parallel.tp`` under ``launch.steps``) on the CPU: gloo
ranks spawned as subprocesses on a ``FileStore``
(``tests/torch_tp_helpers.py``), one spawn a mesh, every config inside it.

Meshes (data, model) = (1, 2), (2, 2) and (1, 4); f32 smoke configs:
granite (MoE, vocab 256 sharded), qwen3-1.7b (dense, qk-norm), qwen2-1.5b
(qkv bias), whisper-medium (encoder, cross-attention), jamba (SSM mixers
on their ``ssm_inner`` shard beside tensor-parallel attention, MLP and
MoE), mamba2 (SSM mixers alone, 16 heads of P 8: 8 or 4 a rank), and
granite with a vocab of 255, which no model axis here divides (the
embeddings and the loss whole).  At model 4 the 2 kv heads are
replicated over ``model`` and each rank takes the one its q head reads.

Each rank's shards are held to the port's unsharded step on the whole
batch and to the reference (``repro.models.api.loss_fn``, its AdamW and
``clip_by_global_norm`` composed by hand).  Each leaf's gradient of the
first batch, before clipping, within 1e-5 of its max |g| of the unsharded
port's and 1e-4 (``test_torch_train.py``'s) of the reference's: a
replicated leaf whose gradient a rank has only in part (``q_norm``, the
replicated ``wk``; an SSM mixer's ``b_proj``, ``c_proj``, ``dt_proj``,
B and C convs, ``dt_bias``, ``A_log`` and ``D``) must be summed over
``model`` once, and one used whole (``ln1``) must not be, or it is off by
a factor.  The loss and the grad
norm of each of three steps 1e-5 relative.  ``test_torch_fsdp.py``'s
bounds on the three steps: each element's move within 2% of the learning
rates' sum and the optimizer state within 1e-4 of each leaf's max against
the unsharded port, 5% and 1e-3 against the reference.  Two readings
against the unsharded port cross the tighter pair and are held at the
reference's (``ROUNDING``): qwen2's moves (up to 2.4% of the sum) and
qwen3's state (1.1e-4 of its max at model 4).  Tensor-parallel compute
reorders an activation sum in every sublayer, and three AdamW steps carry
a reordered sum far: ``tests/torch_tp_witness.py`` reorders one sum in
one process, with no sharding (the unembed's input gradient over two or
four vocab blocks), and that alone moves qwen2's elements by up to 1.6%
of the sum and qwen3's state by 6.5e-5.

jamba's smoke model is ill-conditioned in f32, in the port and in the
reference alike: moving every embedding up one ulp moves its first
gradient by 1.9e-4 of a leaf's max in the port and 1.0e-4 in the
reference (the witness), and its unsharded port is 6.7e-4 from the
reference, a few such ulps.  One reordered sum moves its optimizer state
after three steps by 0.68 of its max.  So jamba is held at its first
step: the loss 1e-5, the grad norm 1e-4 and each leaf's gradient 2e-3 of
its max, against both; so is mamba2, whose SSM mixers the same reordered
sums reach (its split gated norm sums each row over ``model``).

Prefill and decode logits are this rank's block of the unsharded logits
within 2e-5, and ``greedy_tokens`` gives the unsharded argmax on every
rank.  So are long decode's (global batch 1, the cache's sequence cut over
``data``) at (2, 2), jamba with a window of 16 that spans both data
ranks' blocks.

That the compute is split: every leaf a gather returns keeps its
``model``-local dim in a tensor-parallel sublayer and is whole elsewhere;
``ops.flash_attention`` sees H / m q heads, ``ops.ssd_scan`` H / m SSM
heads, ``ops.grouped_matmul`` E / m groups over the local experts' kept
rows alone (their sum over the ranks is the unsharded call's); training
gathers no leaf over ``model``; prefill issues exactly one all-reduce
over ``model`` a tensor-parallel sublayer (two an SSM mixer: its gated
norm's row sums, then its output; and one for the embedding), runs each
attention on H / m heads and each SSM scan on H / m, and gathers over
``model`` only ``wk``, ``wv``, ``bk`` and ``bv``, where the kv heads do
not split (2 kv heads over 4).  Decode computes attention on its head_dim
shard and each SSM mixer on its heads: no attention weight and no SSM
projection comes back gathered over ``model``, no cache leaf is gathered
(nothing counts under the ``"cache"`` tag, and the bytes gathered over
``model`` are exactly the attention's new K rows, queries and outputs,
each SSM mixer's new ``xs_raw`` row, ``conv_x`` and ``conv_x_b``), each
attention call issues the collectives over ``model`` that its route
predicts, and the SSM state and conv tail every ``model`` rank advances
are the same bits.

The split gated norm (``parallel.tp.ModelAxis.rmsnorm``) on each mesh,
on its plain route and through the kernels' ``autograd.Function``: y, dx
and dw of each rank's columns within 2e-5 (f32) of the whole-row norm's
and of the reference's ``rmsnorm`` under ``jax.vjp``.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models.base import set_logical_rules  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.spec import ModelConfig  # noqa: E402
from repro_torch.parallel.fsdp import (REGIONS, region_of,  # noqa: E402
                                       shard_slices)
from repro_torch.parallel.sharding import axes_of  # noqa: E402
from repro_torch.weights import flatten, from_jax_params  # noqa: E402

import torch_tp_helpers as TH  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
STEPS, B, S = 3, 8, 16
LOSS_RTOL = 1e-5
GRAD_TOL, REF_GRAD_TOL = 1e-5, 1e-4     # against the port, the reference
MOVE_TOL, STATE_TOL = 2e-2, 1e-4          # against the unsharded port
REF_MOVE_TOL, REF_STATE_TOL = 5e-2, 1e-3  # against the reference
# the readings that rounding takes past MOVE_TOL or STATE_TOL (see the
# docstring), held at the reference's bounds against the unsharded port
ROUNDING = {("qwen2", "move"), ("qwen3", "state")}
LOGIT_TOL = 2e-5
# jamba's smoke model in f32 at step 0: the grad norm and each leaf's
# gradient (of its max), against both; its later steps are not held
SSM_NORM_RTOL, SSM_GRAD_TOL = 1e-4, 2e-3
SSM = ("jamba", "mamba2")
MESHES = {"m2": (1, 2), "d2m2": (2, 2), "m4": (1, 4)}
LONG_MESH = "d2m2"
NAMES = list(TH.CONFIGS)
CASES = [(m, n) for m in MESHES for n in NAMES]
IDS = [f"{m}-{n}" for m, n in CASES]


def _cfgs(name):
    arch, over = {**TH.CONFIGS, **TH.LONG}[name]
    jcfg = jconfigs.get_smoke_config(arch).replace(dtype="float32", **over)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _inputs():
    """Whole params (the JAX init), three global batches, the serving
    prompts (and frames) of each config."""
    rng = np.random.default_rng(11)
    out, jparams = {}, {}
    _, _, prompt_len, batch = TH.SERVE_SHAPE
    for i, name in enumerate(NAMES):
        jcfg, _ = _cfgs(name)
        jp, _ = japi.init(jcfg, jax.random.PRNGKey(i))
        jparams[name] = jp
        for path, v in flatten(jax.tree.map(np.asarray, jp)).items():
            out[f"{name}|params|{path}"] = v
        for s in range(STEPS):
            toks = rng.integers(0, jcfg.vocab_size, (B, S + 1))
            out[f"{name}|batch{s}|inputs"] = toks[:, :-1].astype(np.int32)
            out[f"{name}|batch{s}|targets"] = toks[:, 1:].astype(np.int32)
            if jcfg.is_encoder_decoder:
                out[f"{name}|batch{s}|enc_embeds"] = rng.standard_normal(
                    (B, jcfg.enc_frames, jcfg.d_model), np.float32)
        out[f"{name}|prompts"] = rng.integers(
            0, jcfg.vocab_size, (batch, prompt_len)).astype(np.int32)
        if jcfg.is_encoder_decoder:
            out[f"{name}|enc_embeds"] = rng.standard_normal(
                (batch, jcfg.enc_frames, jcfg.d_model), np.float32)
    rng = np.random.default_rng(12)
    _, _, prompt_len, batch = TH.LONG_SHAPE
    for i, name in enumerate(TH.LONG):
        jcfg, _ = _cfgs(name)
        jp, _ = japi.init(jcfg, jax.random.PRNGKey(len(NAMES) + i))
        for path, v in flatten(jax.tree.map(np.asarray, jp)).items():
            out[f"{name}|params|{path}"] = v
        out[f"{name}|prompts"] = rng.integers(
            0, jcfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    return out, jparams


def _params(inputs, name):
    return from_jax_params({k.split("|", 2)[2]: v for k, v in inputs.items()
                            if k.startswith(f"{name}|params|")})


def _batch(inputs, name, s):
    return {k.split("|", 2)[2]: torch.from_numpy(v) for k, v in
            inputs.items() if k.startswith(f"{name}|batch{s}|")}


def _serve_unsharded(name, inputs, shape=TH.SERVE_SHAPE):
    """The unsharded prefill and decode logits, each decode step fed the
    argmax of the step before, and those tokens."""
    _, cfg = _cfgs(name)
    params = api.cast_for_serving(cfg, _params(inputs, name))
    _, _, prompt_len, _ = shape
    batch = {"inputs": torch.from_numpy(inputs[f"{name}|prompts"])}
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = torch.from_numpy(inputs[f"{name}|enc_embeds"])
    with torch.no_grad():
        logits, caches = api.prefill(cfg, params, batch,
                                     prompt_len + steps.sp.DECODE_MARGIN)
        out, toks = [logits.numpy()], []
        for _ in range(3):
            tok = torch.argmax(logits, dim=-1)
            toks.append(tok.numpy().astype(np.int64))
            logits, caches = api.decode_step(cfg, params, tok, caches)
            out.append(logits.numpy())
    return out, np.stack(toks)


def _train_unsharded(name, inputs):
    """The port's one-device step on the whole batches: the gradients of
    the first batch with the kernels' calls, then (losses, norms, params,
    opt state) after each step; flat numpy dicts."""
    _, cfg = _cfgs(name)
    opt = TH.optimizer()
    step = steps.make_train_step(cfg, opt)
    params = steps.as_trainable(_params(inputs, name))
    with TH.Calls() as calls:
        _, grads = steps.loss_and_grads(cfg, params, _batch(inputs, name, 0))
    state = opt.init(params)
    losses, norms = [], []
    for s in range(STEPS):
        params, state, m = step(params, state, _batch(inputs, name, s))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return dict(
        grads={k: v.numpy() for k, v in flatten(grads).items()},
        gmm=calls.gmm, losses=losses, norms=norms,
        params={k: v.detach().numpy() for k, v in flatten(params).items()},
        state={k: v.numpy() for k, v in flatten(state).items()})


def _train_reference(name, inputs, jparams):
    """The reference's gradients of the first batch, then its grad, clip
    and AdamW update on each batch."""
    jcfg, _ = _cfgs(name)
    jopt = joptim.adamw(joptim.cosine_with_warmup(*TH.LR))
    jp = jparams[name]
    js = jopt.init(jp)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss_fn(jcfg, p, b)[0]))

    def jbatch(s):
        return {k: jnp.asarray(v.numpy()) for k, v in
                _batch(inputs, name, s).items()}

    grads = flatten(jax.tree.map(np.asarray, vg(jp, jbatch(0))[1]))
    losses, norms = [], []
    for s in range(STEPS):
        lv, g = vg(jp, jbatch(s))
        g, gn = joptim.clip_by_global_norm(g, 1.0)
        jp, js = jopt.update(g, js, jp)
        losses.append(float(lv))
        norms.append(float(gn))
    return dict(grads=grads, losses=losses, norms=norms,
                params=flatten(jax.tree.map(np.asarray, jp)),
                state=flatten(jax.tree.map(np.asarray, js)))


def _spawn(argvs, env, timeout=600):
    """Start one process a command line; returns a function that waits
    for all and fails on any."""
    procs = [subprocess.Popen([sys.executable, *map(str, argv)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv in argvs]

    def wait():
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
    return wait


def _norm_inputs():
    """The split norm's rows, scales and output gradient."""
    rng = np.random.default_rng(13)
    return {"norm|x": rng.standard_normal((2, 5, TH.NORM_D), np.float32),
            "norm|w": 1 + 0.1 * rng.standard_normal(TH.NORM_D, np.float32),
            "norm|dy": rng.standard_normal((2, 5, TH.NORM_D), np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks (each mesh one world, the three at once, while
    this process computes the unsharded and reference runs): {mesh: [rank
    outputs]}, plus the inputs and the unsharded and reference results by
    config."""
    set_logical_rules(None)
    tmp = tmp_path_factory.mktemp("tp")
    inputs, jparams = _inputs()
    served = {n: _serve_unsharded(n, inputs) for n in NAMES}
    served.update({n: _serve_unsharded(n, inputs, TH.LONG_SHAPE)
                   for n in TH.LONG})
    for n, (_, toks) in served.items():
        inputs[f"{n}|tokens"] = toks
    inputs.update(_norm_inputs())
    np.savez(tmp / "in.npz", **inputs)
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          str(ROOT / "tests")]),
           "OMP_NUM_THREADS": "1"}
    helper = ROOT / "tests" / "torch_tp_helpers.py"
    waits = []
    for mesh, shape in MESHES.items():
        world = int(np.prod(shape))
        (tmp / f"{mesh}.json").write_text(json.dumps(
            {"shape": list(shape), "configs": NAMES, "steps": STEPS,
             "long": list(TH.LONG) if mesh == LONG_MESH else [],
             "norm": True}))
        waits.append(_spawn([[helper, r, world, tmp / f"{mesh}.store",
                              tmp / f"{mesh}.json", tmp / "in.npz",
                              tmp / mesh] for r in range(world)], env))
    out = {"inputs": inputs, "served": served,
           "unsharded": {n: _train_unsharded(n, inputs) for n in NAMES},
           "reference": {n: _train_reference(n, inputs, jparams)
                         for n in NAMES}}
    for wait in waits:
        wait()
    for mesh, shape in MESHES.items():
        out[mesh] = [dict(np.load(tmp / f"{mesh}.rank{r}.npz"))
                     for r in range(int(np.prod(shape)))]
    yield out
    set_logical_rules(None)


def _sizes(mesh):
    return dict(zip(("data", "model"), MESHES[mesh]))


def _rank_mesh(mesh, rank_out):
    return types.SimpleNamespace(shape=_sizes(mesh), coords=dict(
        zip(("data", "model"), rank_out["coords"].tolist())))


def _specs(mesh, name):
    """The fitted specs of params and optimizer state on ``mesh``."""
    _, cfg = _cfgs(name)
    _, (p_specs, o_specs, _), _, _ = steps.make_train_step(
        cfg, TH.optimizer(), _sizes(mesh))
    return flatten(p_specs), flatten(o_specs)


def _lr_sum():
    sched = joptim.cosine_with_warmup(*TH.LR)
    return sum(float(sched(s + 1)) for s in range(STEPS))


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _check_train(runs, mesh, name, want, grad_tol, move_tol, state_tol):
    p_specs, o_specs = _specs(mesh, name)
    start = {k.split("|", 2)[2]: v for k, v in runs["inputs"].items()
             if k.startswith(f"{name}|params|")}
    tol = move_tol * _lr_sum()
    ssm = name in SSM
    for out in runs[mesh]:
        m = _rank_mesh(mesh, out)
        np.testing.assert_allclose(out[f"{name}|loss0"], want["losses"][0],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(out[f"{name}|gnorm0"], want["norms"][0],
                                   rtol=SSM_NORM_RTOL if ssm else LOSS_RTOL)
        for path, g in want["grads"].items():
            cut = shard_slices(p_specs[path], g.shape, m)
            _close(out[f"{name}|g|{path}"], np.asarray(g)[cut],
                   SSM_GRAD_TOL if ssm else grad_tol, f"grad {path}")
        if ssm:
            continue
        for s in range(1, STEPS):
            np.testing.assert_allclose(out[f"{name}|loss{s}"],
                                       want["losses"][s], rtol=LOSS_RTOL)
            np.testing.assert_allclose(out[f"{name}|gnorm{s}"],
                                       want["norms"][s], rtol=LOSS_RTOL)
        for path, w in want["params"].items():
            cut = shard_slices(p_specs[path], w.shape, m)
            np.testing.assert_allclose(
                out[f"{name}|p|{path}"] - start[path][cut],
                np.asarray(w)[cut] - start[path][cut], rtol=0, atol=tol,
                err_msg=path)
        for path, w in want["state"].items():
            w = np.asarray(w)
            got = out[f"{name}|o|{path}"]
            if path == "count":
                assert int(got) == int(w) == STEPS
                continue
            _close(got, w[shard_slices(o_specs[path], w.shape, m)],
                   state_tol, path)


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_tensor_parallel_train_matches_unsharded(runs, mesh, name):
    _check_train(runs, mesh, name, runs["unsharded"][name], GRAD_TOL,
                 REF_MOVE_TOL if (name, "move") in ROUNDING else MOVE_TOL,
                 REF_STATE_TOL if (name, "state") in ROUNDING else STATE_TOL)


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_tensor_parallel_train_matches_reference(runs, mesh, name):
    _check_train(runs, mesh, name, runs["reference"][name], REF_GRAD_TOL,
                 REF_MOVE_TOL, REF_STATE_TOL)


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_tensor_parallel_serving_matches_unsharded(runs, mesh, name):
    """Prefill and decode logits: this rank's block of the unsharded ones;
    the greedy token of each, on every rank, the unsharded argmax."""
    _, cfg = _cfgs(name)
    spec = steps.make_prefill_step(cfg, _sizes(mesh),
                                   ShapeSpec(*TH.SERVE_SHAPE))[2][0]
    want, toks = runs["served"][name]
    for out in runs[mesh]:
        m = _rank_mesh(mesh, out)
        keys = ["prefill"] + [f"decode{i}" for i in range(len(want) - 1)]
        for i, (key, w) in enumerate(zip(keys, want)):
            np.testing.assert_allclose(
                out[f"{name}|{key}"], w[shard_slices(spec, w.shape, m)],
                rtol=LOGIT_TOL, atol=LOGIT_TOL, err_msg=key)
            rows = shard_slices(spec, w.shape, m)[0]
            assert np.array_equal(out[f"{name}|greedy{i}"],
                                  np.argmax(w, axis=-1)[rows]), key


def _ssm_inner(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model


def _tp_kinds(cfg, m: int):
    """Which kinds of sublayer compute tensor-parallel on a model axis of
    ``m``, by the rules: attention on its local q heads wherever they
    split, in training and in prefill (whose K/V head_dim carries
    ``model`` where the kv heads do not split); an SSM mixer where each
    rank holds whole heads of ``ssm_inner``."""
    d_inner = _ssm_inner(cfg)
    return {"attn": cfg.n_heads % m == 0,
            "mlp": cfg.d_ff > 0 and cfg.d_ff % m == 0,
            "moe": cfg.n_experts > 0 and cfg.n_experts % m == 0,
            "ssm": "mamba" in cfg.pattern and d_inner % m == 0 and
            (d_inner // m) % cfg.ssm_head_dim == 0,
            "vocab": cfg.vocab_size % m == 0}


def _serve_kinds(name, cfg, m: int):
    """:func:`_tp_kinds` of the serve job: ``TH.WHOLE_SSM_SERVE``'s SSM
    mixers compute whole."""
    kinds = _tp_kinds(cfg, m)
    kinds["ssm"] &= name not in TH.WHOLE_SSM_SERVE
    return kinds


def _ssm_heads(cfg, m: int, split: bool) -> int:
    """The SSM heads each rank's scan runs (``split``: over model)."""
    H = _ssm_inner(cfg) // cfg.ssm_head_dim
    return H // m if split else H


def _local_kv(cfg, m: int, r: int) -> int:
    """The kv heads a rank's attention computes."""
    if cfg.n_kv_heads % m == 0:
        return cfg.n_kv_heads // m
    per = cfg.n_heads // m
    return len({h // (cfg.n_heads // cfg.n_kv_heads)
                for h in range(r * per, (r + 1) * per)})


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_tensor_parallel_compute_is_split(runs, mesh, name):
    jcfg, cfg = _cfgs(name)
    m = MESHES[mesh][1]
    kinds = _tp_kinds(cfg, m)
    p_specs, _ = _specs(mesh, name)
    whole = {k.split("|", 2)[2]: v.shape for k, v in runs["inputs"].items()
             if k.startswith(f"{name}|params|")}
    calls_by_rank = []
    for out in runs[mesh]:
        rec = json.loads(str(out[f"{name}|train_record"]))
        r = _rank_mesh(mesh, out).coords["model"]
        # every gathered leaf: model-local in a tensor-parallel sublayer
        for path, shape in rec["shapes"].items():
            want = list(whole[path])
            spec = list(p_specs[path])
            if len(want) == len(spec) and path.split("/")[0] in steps.STACKED:
                want, spec = want[1:], spec[1:]
            region = region_of(path)
            if region is not None and kinds[REGIONS[region.split("/")[-1]]]:
                for d, part in enumerate(spec):
                    if "model" in axes_of(part):
                        want[d] //= m
            assert shape == want, (path, shape, want)
        assert bool(rec["attn"]) == ("attn" in cfg.pattern) and all(
            h == (cfg.n_heads // m, _local_kv(cfg, m, r))
            for h in map(tuple, rec["attn"])), rec["attn"]
        assert bool(rec["ssd"]) == ("mamba" in cfg.pattern) and all(
            h == _ssm_heads(cfg, m, kinds["ssm"]) for h in rec["ssd"]), \
            rec["ssd"]
        if cfg.n_experts:
            assert all(g == cfg.n_experts // m and rows == kept
                       for rows, g, kept in rec["gmm"]), rec["gmm"]
            calls_by_rank.append([rows for rows, _, _ in rec["gmm"]])
        model = rec["collectives"].get("model", {})
        assert model.get("all_reduce", 0) > 0
        # every sublayer computes on its model-local part: no leaf is
        # gathered over model, the SSM mixers' included
        assert model.get("all_gather", 0) == 0, model
    if cfg.n_experts:
        want = [kept for _, _, kept in runs["unsharded"][name]["gmm"]]
        assert [sum(c) for c in zip(*calls_by_rank)] == want


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_prefill_ends_each_sublayer_in_one_model_sum(runs, mesh, name):
    """Prefill (no grad, no remat): exactly one all-reduce over ``model`` a
    tensor-parallel sublayer (two an SSM mixer: the gated norm's row sums,
    then the output), one for a vocab-parallel embedding, and each
    attention call on H / m heads and each SSM scan on H / m heads where
    it is tensor-parallel; an SSM mixer gathers its cache's state and x
    channels, two all-gathers over ``model``."""
    _, cfg = _cfgs(name)
    m = MESHES[mesh][1]
    kinds = _serve_kinds(name, cfg, m)
    if cfg.is_encoder_decoder:
        n = cfg.n_enc_layers * (kinds["attn"] + kinds["mlp"]) + \
            cfg.n_layers * (2 * kinds["attn"] + kinds["mlp"])
    else:
        n = 0
        for i in range(cfg.n_layers):
            kind = cfg.pattern[i % len(cfg.pattern)]
            pos = i % len(cfg.pattern)
            n += kind == "attn" and kinds["attn"]
            n += 2 * (kind == "mamba" and kinds["ssm"])
            moe = cfg.n_experts > 0 and pos % cfg.moe_every == \
                cfg.moe_every - 1
            n += kinds["moe"] if moe else kinds["mlp"]
    n += kinds["vocab"]
    n_ssm = sum(k == "mamba" for k in cfg.pattern) * cfg.n_blocks
    for out in runs[mesh]:
        rec = json.loads(str(out[f"{name}|serve_record"]))
        r = _rank_mesh(mesh, out).coords["model"]
        model = rec["collectives"].get("model", {})
        assert model.get("all_reduce", 0) == n
        if n_ssm:
            # each mixer's cache gathers (state, x channels), and one a
            # block of its leaves gathered over model: the K/V weights where
            # the kv heads do not split, the mixers' where they compute whole
            whole = cfg.n_blocks * (not kinds["ssm"] or (
                "attn" in cfg.pattern and cfg.n_kv_heads % m != 0))
            assert model.get("all_gather", 0) == \
                2 * n_ssm * kinds["ssm"] + whole, model
        heads = cfg.n_heads // m if kinds["attn"] else cfg.n_heads
        kv = _local_kv(cfg, m, r) if kinds["attn"] else cfg.n_kv_heads
        assert bool(rec["attn"]) == ("attn" in cfg.pattern) and all(
            (h, k) == (heads, kv) for h, k in rec["attn"]), rec["attn"]
        assert all(h == _ssm_heads(cfg, m, kinds["ssm"])
                   for h in rec["ssd"]), rec["ssd"]


def _serve_specs(mesh, name, decode: bool):
    """The fitted param specs of the prefill or serve step on ``mesh``."""
    _, cfg = _cfgs(name)
    shape = ShapeSpec(*TH.SERVE_SHAPE)
    make = steps.make_serve_step if decode else steps.make_prefill_step
    return flatten(make(cfg, _sizes(mesh), shape)[1][0])


def _whole_block_shape(runs, name, path):
    shape = list(runs["inputs"][f"{name}|params|{path}"].shape)
    return shape[1:] if path.split("/")[0] in steps.STACKED else shape


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_prefill_gathers_only_kv_weights_over_model(runs, mesh, name):
    """Prefill's gathers: a leaf comes back whole over ``model`` only if,
    where the kv heads do not split, it is an attention's ``wk``, ``wv``,
    ``bk`` or ``bv`` (or an SSM mixer's whose heads do not split); every
    other leaf whose spec has ``model`` stays ``model``-local."""
    _, cfg = _cfgs(name)
    m = MESHES[mesh][1]
    specs = _serve_specs(mesh, name, decode=False)
    kv_whole = cfg.n_kv_heads % m != 0
    kinds = _serve_kinds(name, cfg, m)
    for out in runs[mesh]:
        rec = json.loads(str(out[f"{name}|serve_record"]))
        assert rec["shapes"]
        for path, shape in rec["shapes"].items():
            spec = specs[path]
            whole = _whole_block_shape(runs, name, path)
            if len(spec) == len(whole) + 1:
                spec = spec[1:]
            leaf = path.rsplit("/", 1)[-1]
            region = region_of(path)
            kind = None if region is None else REGIONS[region.split("/")[-1]]
            over_model = region is None or (
                kv_whole and kind == "attn"
                and leaf in ("wk", "wv", "bk", "bv")) or (
                kind == "ssm" and not kinds["ssm"])
            want = [d if over_model or "model" not in axes_of(part)
                    else d // m for d, part in zip(whole, spec)]
            assert shape == want, (path, shape, want)


def _decode_attn_calls(cfg, m: int):
    """Each decode attention call's collectives over ``model``, in call
    order, as its route predicts: the query gathered (where the q heads
    split), self-attention's new K row gathered,
    the partial logits summed, the output gathered, and the sublayer's sum
    (where the q heads split); cross-attention has no new rows."""
    heads = int(cfg.n_heads % m == 0)
    own = ("attention_decode", {"all_gather": 2 + heads,
                                "all_reduce": 1 + heads})
    cross = ("cross_attention", {"all_gather": 1 + heads,
                                 "all_reduce": 1 + heads})
    if cfg.is_encoder_decoder:
        return [own, cross] * cfg.n_layers
    return [own] * sum(k == "attn" for k in cfg.pattern) * cfg.n_blocks


def _decode_activation_bytes(cfg, m: int, b: int, split: bool) -> int:
    """The bytes a decode step gathers over ``model`` (f32) that are not
    weights: the query and the output [b, 1, H, Dh] of each attention
    call, the new K row [b, 1, KV, Dh] of each self-attention, and the new
    ``xs_raw`` row [b, 1, d_inner] of each SSM mixer on its heads
    (``split``)."""
    heads = int(cfg.n_heads % m == 0)
    q_out = (heads + 1) * b * cfg.n_heads * cfg.d_head * 4
    kv = b * cfg.n_kv_heads * cfg.d_head * 4
    n_self = (cfg.n_layers if cfg.is_encoder_decoder else
              sum(k == "attn" for k in cfg.pattern) * cfg.n_blocks)
    n_cross = cfg.n_layers if cfg.is_encoder_decoder else 0
    n_ssm = sum(k == "mamba" for k in cfg.pattern) * cfg.n_blocks
    xs = b * _ssm_inner(cfg) * 4 if split else 0
    return n_self * (q_out + kv) + n_cross * q_out + n_ssm * xs


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_decode_attention_computes_on_the_head_dim_shard(runs, mesh, name):
    """The first decode step: every attention leaf its gathers return is
    ``model``-local (its head_dim, or its heads), and every SSM mixer leaf
    but ``conv_x`` and ``conv_x_b`` (the only leaves gathered over
    ``model``); no gather is tagged as a cache's, the all-gathers over
    ``model`` move exactly the attention's new K rows, queries and
    outputs, the SSM mixers' new ``xs_raw`` rows and those two leaves, and
    each attention call issues the collectives over ``model`` of
    :func:`_decode_attn_calls`."""
    _, cfg = _cfgs(name)
    d, m = MESHES[mesh]
    specs = _serve_specs(mesh, name, decode=True)
    b = TH.SERVE_SHAPE[3] // d
    split = _serve_kinds(name, cfg, m)["ssm"]
    for out in runs[mesh]:
        rec = json.loads(str(out[f"{name}|serve_record"]))["decode"]
        assert rec["tagged"] == {}
        assert rec["attn_calls"] == [list(c) for c in
                                     _decode_attn_calls(cfg, m)]
        weights = 0
        for path, shape in rec["shapes"].items():
            spec = specs[path]
            whole = _whole_block_shape(runs, name, path)
            if len(spec) == len(whole) + 1:
                spec = spec[1:]
            region = region_of(path)
            kind = None if region is None else REGIONS[region.split("/")[-1]]
            # an SSM mixer on its heads takes conv_x, conv_x_b whole
            whole_ssm = kind == "ssm" and (not split or path.rsplit(
                "/", 1)[-1] in ("conv_x", "conv_x_b"))
            if kind == "attn" or (kind == "ssm" and not whole_ssm):
                want = [n // m if "model" in axes_of(part) else n
                        for n, part in zip(whole, spec)]
                assert shape == want, (path, shape, want)
            elif (region is None or whole_ssm) and any(
                    "model" in axes_of(part) for part in spec):
                assert shape == whole, (path, shape, whole)
                # gathered over model first (once a block): its shard
                # times m, f32
                weights += 4 * int(np.prod(whole)) // int(np.prod(
                    [_sizes(mesh)[a] for part in spec for a in axes_of(part)
                     if a != "model"])) * (cfg.n_blocks if path.startswith(
                         "blocks/") else 1)
        assert rec["model_all_gather_bytes"] == weights + \
            _decode_activation_bytes(cfg, m, b, split), (rec, weights)
        if "mamba" not in cfg.pattern:
            assert weights == 0


SSM_CASES = [(m, n) for m, n in CASES if n in SSM]


@pytest.mark.parametrize("mesh,name", SSM_CASES,
                         ids=[f"{m}-{n}" for m, n in SSM_CASES])
def test_decode_ssm_state_is_the_same_bits_on_every_model_rank(runs, mesh,
                                                               name):
    """Each SSM layer's state and conv tail after the decode steps, which
    ``model`` replicates: every ``model`` rank of a batch slice advanced
    them from the same inputs, so they are the same bits."""
    _, cfg = _cfgs(name)
    by_data = {}
    for out in runs[mesh]:
        d = _rank_mesh(mesh, out).coords["data"]
        keys = sorted(k for k in out if k.startswith(f"{name}|ssm_"))
        assert keys
        by_data.setdefault(d, []).append({k: out[k] for k in keys})
    for ranks in by_data.values():
        for other in ranks[1:]:
            assert all(np.array_equal(ranks[0][k], other[k]) for k in other)


NORM_CASES = [(m, r) for m in MESHES for r in ("plain", "function")]


@pytest.fixture(scope="module")
def norm_want():
    """The whole-row norm of the split norm's inputs: the port's plain
    version under autograd, and the reference's ``rmsnorm`` under
    ``jax.vjp``; (y, dx, dw) each."""
    from repro.models.layers import rmsnorm as jrmsnorm
    from repro_torch.kernels import ref
    inp = _norm_inputs()
    x = torch.from_numpy(inp["norm|x"]).requires_grad_()
    w = torch.from_numpy(inp["norm|w"]).requires_grad_()
    y = ref.rmsnorm_ref(x.reshape(-1, TH.NORM_D), w,
                        eps=TH.NORM_EPS).reshape(x.shape)
    dx, dw = torch.autograd.grad(y, (x, w), torch.from_numpy(inp["norm|dy"]))
    jy, vjp = jax.vjp(lambda a, b: jrmsnorm(a, b, TH.NORM_EPS),
                      jnp.asarray(inp["norm|x"]), jnp.asarray(inp["norm|w"]))
    jdx, jdw = vjp(jnp.asarray(inp["norm|dy"]))
    return {"port": (y.detach().numpy(), dx.numpy(), dw.numpy()),
            "reference": tuple(np.asarray(t) for t in (jy, jdx, jdw))}


@pytest.mark.parametrize("mesh,route", NORM_CASES,
                         ids=[f"{m}-{r}" for m, r in NORM_CASES])
def test_split_gated_norm_matches_the_whole_row(runs, norm_want, mesh,
                                                route):
    """``ModelAxis.rmsnorm`` on each rank's block of the columns: its y,
    dx and dw the whole-row norm's columns within 2e-5, the port's and the
    reference's."""
    m = MESHES[mesh][1]
    for out in runs[mesh]:
        r = _rank_mesh(mesh, out).coords["model"]
        cols = slice(r * TH.NORM_D // m, (r + 1) * TH.NORM_D // m)
        for who, want in norm_want.items():
            for k, w in zip(("y", "dx", "dw"), want):
                np.testing.assert_allclose(
                    out[f"norm|{route}|{k}"], w[..., cols], rtol=2e-5,
                    atol=2e-5, err_msg=f"{who} {k}")


def test_long_decode_matches_unsharded(runs):
    """Long decode at (2, 2): the cache's sequence cut over ``data`` (the
    window spans both blocks as decode writes slots 126 to 128, which
    data rank 0 then rank 1 holds), K/V head_dim over ``model``; each
    rank's logits its block of the unsharded ones within 2e-5, its greedy
    token the unsharded argmax; each attention layer merges its softmax
    in two all-reduces over ``data`` (the row max, then the sums)."""
    for name in TH.LONG:
        _, cfg = _cfgs(name)
        spec = steps.make_serve_step(cfg, _sizes(LONG_MESH), ShapeSpec(
            *TH.LONG_SHAPE))[2][0]
        want, _ = runs["served"][name]
        n_attn = sum(k == "attn" for k in cfg.pattern) * cfg.n_blocks
        for out in runs[LONG_MESH]:
            m = _rank_mesh(LONG_MESH, out)
            for i, w in enumerate(want[1:]):
                np.testing.assert_allclose(
                    out[f"{name}|decode{i}"],
                    w[shard_slices(spec, w.shape, m)], rtol=LOGIT_TOL,
                    atol=LOGIT_TOL, err_msg=f"decode{i}")
                assert np.array_equal(out[f"{name}|greedy{i}"],
                                      np.argmax(w, axis=-1)), i
            rec = json.loads(str(out[f"{name}|long_record"]))
            assert rec["data"].get("all_reduce") == 2 * n_attn, rec
