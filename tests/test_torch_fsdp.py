"""FSDP of the port (``repro_torch.parallel.fsdp`` under ``launch.steps``)
on the CPU: gloo ranks spawned as subprocesses on a ``FileStore``
(``tests/torch_fsdp_helpers.py``), one spawn a mesh, every job of the mesh
inside it.

Smoke granite (4 layers, MoE with its load-balance loss) and smoke mamba2
train in f32 for three steps on meshes (data, model) = (2, 1), (1, 2),
(2, 2), (4, 1) and (pod, data, model) = (2, 2, 1), with AdamW and, on
(2, 2), Adafactor, through the sharded train step as it ships: where the
fitted specs put ``model`` on granite's heads, MLP columns, experts or
vocab those sublayers compute tensor-parallel (``test_torch_tp.py`` holds
that compute on more configs).  On (1, 2) and (2, 2) mamba2's embeddings
and loss (``torch_fsdp_helpers.WHOLE_VOCAB``) and its SSM mixers
(``WHOLE_MIXER``) are computed whole: its three-step state is chaotic at
this file's bound, the vocab-parallel loss's reordered sums alone would
cross it (``tests/torch_tp_witness.py``: summing the unembed's input
gradient over two vocab blocks, in one process, moves that state by
1.11e-4 of its max), and so do the mixers' on their ``ssm_inner`` shard
(the helper's comment gives the reading).  Each rank's shards of the params and optimizer state,
the loss and the grad norm are held to the port's unsharded step on the
whole batch and to the reference (``repro.models.api.loss_fn``, its
optimizers and ``clip_by_global_norm`` composed by hand, as in
``test_torch_train.py``; ``repro.launch.steps`` is red on jax 0.9.0).
Against the unsharded step only the order of the sums differs, so: the
loss and the grad norm 1e-5 relative; each element's move over the three
steps within 2% of the sum of their learning rates (AdamW turns a gradient
near its eps into about a sign); optimizer state 1e-4 of each leaf's max.
Against the reference the port's own differences add up over the three
steps (its SSD scan's gradients agree to 1e-4 of their max a step,
``test_torch_train.py``, and AdamW's moments carry them): each move within
5% of the learning rates' sum, state 1e-3 of its max, the loss and norm
still 1e-5.  Adafactor factors leaves from 32 rows and columns
(``torch_fsdp_helpers.FACTOR_MIN``), so the smoke widths reach its
factored moments.  Each rank's shard shapes equal
``NamedSharding(...).shard_shape`` of the reference's specs.

At (2, 2) the prefill and decode steps give the unsharded logits (2e-5),
the gathers never hold more than one block plus the unstacked leaves (a
tensor-parallel sublayer's ``model``-local), and
the trained state saved sharded loads onto (4, 1) as the same bits.  The
``model`` axis as an EP group (``mesh.ep_group()``) at (1, 2) and (2, 2)
gives the bits of ``tests/torch_ep_helpers.py``'s ep-2 world, and closing
it leaves the world up.  At world size 1 the sharded step equals the
unsharded one bit for bit (in this process).
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
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models.base import logical_to_pspec as jl2p  # noqa: E402
from repro.models.base import set_logical_rules  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.spec import ModelConfig  # noqa: E402
from repro_torch.parallel.fsdp import (Sharded, region_of,  # noqa: E402
                                       shard_slices)
from repro_torch.parallel.sharding import axes_of  # noqa: E402
from repro_torch.weights import flatten, from_jax_params  # noqa: E402
from repro_torch.weights import unflatten  # noqa: E402

import torch_ep_helpers as EH  # noqa: E402
import torch_fsdp_helpers as FH  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
STEPS, B, S = 3, 8, 16
LOSS_RTOL = 1e-5
MOVE_TOL, STATE_TOL = 2e-2, 1e-4          # against the unsharded step
REF_MOVE_TOL, REF_STATE_TOL = 5e-2, 1e-3  # against the reference
LOGIT_TOL = 2e-5
GRANITE, MAMBA = FH.ARCHS


def _train(arch, opt, **kw):
    name = "-".join([arch.split("-")[0], opt] + [f"{k}{v}" for k, v in
                                                  sorted(kw.items())])
    return dict(kind="train", name=name, arch=arch, opt=opt, steps=STEPS,
                **kw)


TRAINS = {
    "d2": [_train(GRANITE, "adamw", mask=1),
           _train(MAMBA, "adamw", microbatches=2)],
    "m2": [_train(GRANITE, "adamw"), _train(MAMBA, "adamw")],
    "d2m2": [_train(GRANITE, "adamw", count_gathers=1),
             _train(GRANITE, "adafactor"), _train(MAMBA, "adamw")],
    "d4": [_train(GRANITE, "adamw"), _train(MAMBA, "adamw")],
    "pod": [_train(GRANITE, "adamw")],
}
SHAPES = {"d2": (2, 1), "m2": (1, 2), "d2m2": (2, 2), "d4": (4, 1),
          "pod": (2, 2, 1)}
CKPT = _train(GRANITE, "adamw", count_gathers=1)["name"]
TRAIN_CASES = [(m, j["name"]) for m, js in TRAINS.items() for j in js]


def _axes(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _plan(mesh, tmp):
    jobs = list(TRAINS[mesh])
    if mesh == "d2m2":
        jobs += [dict(kind="serve", name=f"serve-{a}", arch=a)
                 for a in FH.ARCHS]
        jobs += [dict(kind="ep"),
                 dict(kind="save", dir=str(tmp / "ckpt"), **{"from": CKPT})]
    if mesh == "m2":
        jobs.append(dict(kind="ep"))
    if mesh == "d4":
        jobs.append(dict(kind="load", name="load", arch=GRANITE,
                         opt="adamw", dir=str(tmp / "ckpt")))
    return {"shape": list(SHAPES[mesh]), "jobs": jobs}


def _cfgs(arch):
    jcfg = jconfigs.get_smoke_config(arch).replace(dtype="float32")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _inputs():
    """Whole params (the JAX init), three global batches (and masks), the
    serving prompts, and the EP block's inputs."""
    rng = np.random.default_rng(7)
    out, jparams = {}, {}
    for i, arch in enumerate(FH.ARCHS):
        jcfg, _ = _cfgs(arch)
        jp, _ = japi.init(jcfg, jax.random.PRNGKey(i))
        jparams[arch] = jp
        for path, v in flatten(jax.tree.map(np.asarray, jp)).items():
            out[f"{arch}|params|{path}"] = v
        for s in range(STEPS):
            toks = rng.integers(0, jcfg.vocab_size, (B, S + 1))
            out[f"{arch}|batch{s}|inputs"] = toks[:, :-1].astype(np.int32)
            out[f"{arch}|batch{s}|targets"] = toks[:, 1:].astype(np.int32)
            out[f"{arch}|mask{s}"] = (rng.random((B, S)) < 0.7).astype(
                np.float32)
        _, _, prompt_len, batch = FH.SERVE_SHAPE
        out[f"{arch}|prompts"] = rng.integers(
            0, jcfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    ep = _ep_inputs(rng)
    out.update({f"ep|{k}": v for k, v in ep.items()})
    return out, jparams, ep


def _ep_inputs(rng):
    """``test_torch_ep``'s input layout for ``torch_ep_helpers``."""
    cfg = configs.get_smoke_config(EH.ARCH)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    f32 = np.float32
    inp = {"router": rng.standard_normal((D, E), f32) / np.sqrt(D),
           "wi_gate": rng.standard_normal((E, D, F), f32) / np.sqrt(D),
           "wi_up": rng.standard_normal((E, D, F), f32) / np.sqrt(D),
           "wo": rng.standard_normal((E, F, D), f32) / np.sqrt(F),
           "x": rng.standard_normal((EH.T_LOC * 4, D), f32),
           "a": rng.standard_normal((16, 16), f32) / 4}
    inp["x_drop"] = np.abs(inp["x"]) + 0.5
    inp["router_drop"] = inp["router"].copy()
    inp["router_drop"][:, :2] = 1.0
    return inp


def _serve_unsharded(arch, inputs):
    """The unsharded prefill and decode logits, each decode step fed the
    argmax of the step before."""
    _, cfg = _cfgs(arch)
    params = api.cast_for_serving(cfg, from_jax_params(
        {k.split("|", 2)[2]: v for k, v in inputs.items()
         if k.startswith(f"{arch}|params|")}))
    _, _, prompt_len, _ = FH.SERVE_SHAPE
    prompts = torch.from_numpy(inputs[f"{arch}|prompts"])
    with torch.no_grad():
        logits, caches = api.prefill(cfg, params, {"inputs": prompts},
                                     prompt_len + steps.sp.DECODE_MARGIN)
        out, toks = [logits.numpy()], []
        for _ in range(3):
            tok = torch.argmax(logits, dim=-1)
            toks.append(tok.numpy().astype(np.int64))
            logits, caches = api.decode_step(cfg, params, tok, caches)
            out.append(logits.numpy())
    return out, np.stack(toks)


def _spawn(argvs, env, timeout=600):
    """Start one process a command line, wait for all, fail on any."""
    procs = [subprocess.Popen([sys.executable, *map(str, argv)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv in argvs]
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks, in turn ((4, 1) loads what (2, 2) saved), and
    ``torch_ep_helpers``' ep-2 world: {mesh: [rank outputs]}, "ep2":
    [rank outputs], plus the inputs, the reference's params, the
    unsharded serving logits and a cache of the unsharded train runs."""
    set_logical_rules(None)
    tmp = tmp_path_factory.mktemp("fsdp")
    inputs, jparams, ep = _inputs()
    served = {a: _serve_unsharded(a, inputs) for a in FH.ARCHS}
    for a, (_, toks) in served.items():
        inputs[f"{a}|tokens"] = toks
    np.savez(tmp / "in.npz", **inputs)
    np.savez(tmp / "ep_in.npz", **ep)
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          str(ROOT / "tests")]),
           "OMP_NUM_THREADS": "1"}
    helper = ROOT / "tests" / "torch_fsdp_helpers.py"
    out = {"inputs": inputs, "jparams": jparams, "served": served,
           "unsharded": {}, "reference": {}}
    for mesh in ("d2", "m2", "d2m2", "d4", "pod"):
        world = int(np.prod(SHAPES[mesh]))
        (tmp / f"{mesh}.json").write_text(json.dumps(_plan(mesh, tmp)))
        _spawn([[helper, r, world, tmp / f"{mesh}.store",
                 tmp / f"{mesh}.json", tmp / "in.npz", tmp / mesh]
                for r in range(world)], env)
        out[mesh] = [dict(np.load(tmp / f"{mesh}.rank{r}.npz"))
                     for r in range(world)]
    _spawn([[ROOT / "tests" / "torch_ep_helpers.py", "rank", r, 2,
             tmp / "ep2.store", tmp / "ep_in.npz", tmp / f"ep2.{r}.npz"]
            for r in range(2)], env)
    out["ep2"] = [dict(np.load(tmp / f"ep2.{r}.npz")) for r in range(2)]
    yield out
    set_logical_rules(None)


def _job(mesh, name):
    return next(j for j in TRAINS[mesh] if j["name"] == name)


def _batches(inputs, job):
    arch = job["arch"]
    for s in range(STEPS):
        b = {k: inputs[f"{arch}|batch{s}|{k}"] for k in ("inputs", "targets")}
        if job.get("mask"):
            b["mask"] = inputs[f"{arch}|mask{s}"]
        yield b


def _key(job):
    return (job["arch"], job["opt"], job.get("mask", 0),
            job.get("microbatches", 1))


def _unsharded(runs, job):
    """The port's one-device step on the whole batches: (losses, norms,
    params, opt state) as flat numpy dicts."""
    key = _key(job)
    if key not in runs["unsharded"]:
        _, cfg = _cfgs(job["arch"])
        opt = FH.optimizer(job["opt"])
        step = steps.make_train_step(cfg, opt,
                                     microbatches=job.get("microbatches", 1))
        params = steps.as_trainable(from_jax_params(
            jax.tree.map(np.asarray, runs["jparams"][job["arch"]])))
        state = opt.init(params)
        losses, norms = [], []
        for b in _batches(runs["inputs"], job):
            params, state, m = step(params, state,
                                    {k: torch.from_numpy(v)
                                     for k, v in b.items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        runs["unsharded"][key] = (
            losses, norms,
            {k: v.detach().numpy() for k, v in flatten(params).items()},
            {k: v.numpy() for k, v in flatten(state).items()})
    return runs["unsharded"][key]


def _reference(runs, job):
    """The reference's grad, clip and update on the whole batches."""
    key = _key(job)
    if key not in runs["reference"]:
        jcfg, _ = _cfgs(job["arch"])
        jopt = (joptim.adamw if job["opt"] == "adamw"
                else lambda s: joptim.adafactor(
                    s, min_dim_size_to_factor=FH.FACTOR_MIN))(
            joptim.cosine_with_warmup(*FH.LR))
        jp = runs["jparams"][job["arch"]]
        js = jopt.init(jp)
        mb = job.get("microbatches", 1)

        def loss(p, b):
            return japi.loss_fn(jcfg, p, b)[0]

        losses, norms = [], []
        for b in _batches(runs["inputs"], job):
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            n = B // mb
            gsum = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                                jp)
            lsum = 0.0
            for i in range(mb):
                part = {k: v[i * n:(i + 1) * n] for k, v in jb.items()}
                lv, g = jax.value_and_grad(loss)(jp, part)
                gsum = jax.tree.map(lambda a, x: a + x, gsum, g)
                lsum = lsum + lv
            grads = jax.tree.map(lambda g: g / mb, gsum)
            grads, gn = joptim.clip_by_global_norm(grads, 1.0)
            jp, js = jopt.update(grads, js, jp)
            losses.append(float(lsum / mb))
            norms.append(float(gn))
        runs["reference"][key] = (
            losses, norms, flatten(jax.tree.map(np.asarray, jp)),
            flatten(jax.tree.map(np.asarray, js)))
    return runs["reference"][key]


def _port_specs(mesh, job):
    """The port's fitted specs of params and optimizer state on ``mesh``'s
    axis sizes."""
    _, cfg = _cfgs(job["arch"])
    shape = dict(zip(_axes(SHAPES[mesh]), SHAPES[mesh]))
    _, (p_specs, o_specs, _), _, (p_s, o_s) = steps.make_train_step(
        cfg, FH.optimizer(job["opt"]), shape, multi_pod="pod" in shape)
    return (flatten(p_specs), flatten(o_specs),
            {k: tuple(v.shape) for k, v in flatten(p_s).items()},
            {k: tuple(v.shape) for k, v in flatten(o_s).items()})


def _rank_mesh(mesh, rank_out):
    shape = dict(zip(_axes(SHAPES[mesh]), SHAPES[mesh]))
    return types.SimpleNamespace(
        shape=shape, coords=dict(zip(shape, rank_out["coords"].tolist())))


def _lr_sum():
    sched = joptim.cosine_with_warmup(*FH.LR)
    return sum(float(sched(s + 1)) for s in range(STEPS))


def _check_run(runs, mesh, name, want, move_tol, state_tol):
    job = _job(mesh, name)
    losses, norms, params, state = want
    p_specs, o_specs, _, _ = _port_specs(mesh, job)
    start = {k.split("|", 2)[2]: v for k, v in runs["inputs"].items()
             if k.startswith(f"{job['arch']}|params|")}
    tol = move_tol * _lr_sum()
    for out in runs[mesh]:
        m = _rank_mesh(mesh, out)
        for s in range(STEPS):
            np.testing.assert_allclose(out[f"{name}|loss{s}"], losses[s],
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(out[f"{name}|gnorm{s}"], norms[s],
                                       rtol=LOSS_RTOL)
        for path, w in params.items():
            cut = shard_slices(p_specs[path], w.shape, m)
            np.testing.assert_allclose(
                out[f"{name}|p|{path}"] - start[path][cut],
                np.asarray(w)[cut] - start[path][cut], rtol=0, atol=tol,
                err_msg=path)
        for path, w in state.items():
            w = np.asarray(w)
            got = out[f"{name}|o|{path}"]
            cut = shard_slices(o_specs[path], w.shape, m)
            if path == "count":
                assert int(got) == int(w) == STEPS
                continue
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(got - w[cut]).max()) <= state_tol * scale, \
                path


@pytest.mark.parametrize("mesh,name", TRAIN_CASES,
                         ids=[f"{m}-{n}" for m, n in TRAIN_CASES])
def test_sharded_train_matches_unsharded(runs, mesh, name):
    _check_run(runs, mesh, name, _unsharded(runs, _job(mesh, name)),
               MOVE_TOL, STATE_TOL)


@pytest.mark.parametrize("mesh,name", TRAIN_CASES,
                         ids=[f"{m}-{n}" for m, n in TRAIN_CASES])
def test_sharded_train_matches_reference(runs, mesh, name):
    _check_run(runs, mesh, name, _reference(runs, _job(mesh, name)),
               REF_MOVE_TOL, REF_STATE_TOL)


def _reference_specs(mesh, job):
    """The reference's fitted specs of params and optimizer state, as
    ``repro.launch.steps.make_train_step`` composes them."""
    jcfg, _ = _cfgs(job["arch"])
    shape = dict(zip(_axes(SHAPES[mesh]), SHAPES[mesh]))
    fake = types.SimpleNamespace(shape=shape)
    rules = jsharding.rules_for(jsharding.WorkloadKind.TRAIN,
                                multi_pod="pod" in shape)
    sched = joptim.cosine_with_warmup(*FH.LR)
    jopt = (joptim.adamw(sched) if job["opt"] == "adamw"
            else joptim.adafactor(sched,
                                  min_dim_size_to_factor=FH.FACTOR_MIN))
    params_s, specs, opt_s = jspecs.state_shapes(
        jcfg.replace(param_dtype=jcfg.dtype), jopt)
    p = jsharding.fit_tree(jsharding.param_pspecs(specs, rules), params_s,
                           fake)
    o_logical = jopt.state_specs(specs, params_s)
    o = jsharding.fit_tree(jax.tree.map(
        lambda ax: jl2p(tuple(ax), rules), o_logical,
        is_leaf=lambda x: isinstance(x, tuple)), opt_s, fake)
    am = AbstractMesh(tuple(shape.values()), tuple(shape))
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    shard = lambda sp, x: NamedSharding(am, sp).shard_shape(x.shape)  # noqa
    return (flatten(jax.tree.map(shard, p, params_s, is_leaf=is_p)),
            flatten(jax.tree.map(shard, o, opt_s, is_leaf=is_p)))


@pytest.mark.parametrize("mesh,name", TRAIN_CASES,
                         ids=[f"{m}-{n}" for m, n in TRAIN_CASES])
def test_shard_shapes_match_reference(runs, mesh, name):
    p_shapes, o_shapes = _reference_specs(mesh, _job(mesh, name))
    for out in runs[mesh]:
        for path, want in p_shapes.items():
            assert out[f"{name}|p|{path}"].shape == tuple(want), path
        for path, want in o_shapes.items():
            assert out[f"{name}|o|{path}"].shape == tuple(want), path


def test_gathers_hold_one_block_at_a_time(runs):
    """The largest count of gathered elements alive at once on any rank:
    at least the unstacked leaves and one block (the counting works), and
    no more (the blocks are gathered one at a time, forward and under
    remat).  A leaf of a tensor-parallel sublayer is gathered
    ``model``-local, a ``1 / model`` part of it."""
    job = _job("d2m2", CKPT)
    p_specs, _, shapes, _ = _port_specs("d2m2", job)
    sharded = Sharded(_rank_mesh("d2m2", runs["d2m2"][0]),
                      unflatten(p_specs))

    def gathered(path):
        n = int(np.prod(shapes[path]))
        region = region_of(path)
        if region is not None and sharded.tp(region) is not None and any(
                "model" in axes_of(part) for part in p_specs[path]):
            return n // SHAPES["d2m2"][-1]
        return n

    blocks = [k for k in shapes if k.startswith("blocks/")]
    top = sum(gathered(k) for k in shapes if k not in blocks)
    n_blocks = _cfgs(job["arch"])[1].n_blocks
    one_block = sum(gathered(k) for k in blocks) // n_blocks
    for out in runs["d2m2"]:
        peak = int(out[f"{CKPT}|peak_gathered"])
        assert peak == top + one_block, (peak, top, one_block)


@pytest.mark.parametrize("arch", FH.ARCHS)
def test_sharded_prefill_and_serve_match_unsharded(runs, arch):
    _, cfg = _cfgs(arch)
    shape = dict(zip(_axes(SHAPES["d2m2"]), SHAPES["d2m2"]))
    spec = steps.make_prefill_step(cfg, shape,
                                   ShapeSpec(*FH.SERVE_SHAPE))[2][0]
    want, _ = runs["served"][arch]
    for out in runs["d2m2"]:
        m = _rank_mesh("d2m2", out)
        keys = ["prefill"] + [f"decode{i}" for i in range(len(want) - 1)]
        for key, w in zip(keys, want):
            np.testing.assert_allclose(
                out[f"serve-{arch}|{key}"],
                w[shard_slices(spec, w.shape, m)], rtol=LOGIT_TOL,
                atol=LOGIT_TOL, err_msg=key)


def test_checkpoint_saved_sharded_loads_onto_another_mesh(runs):
    """(2, 2)'s trained granite state, saved sharded, loads onto (4, 1) as
    its shards of the same bits."""
    job = _job("d2m2", CKPT)
    p_src, o_src, p_shapes, o_shapes = _port_specs("d2m2", job)
    p_dst, o_dst, _, _ = _port_specs("d4", _job("d4", TRAINS["d4"][0][
        "name"]))
    for kind, src, dst, shapes in (("p", p_src, p_dst, p_shapes),
                                   ("o", o_src, o_dst, o_shapes)):
        for path, shp in shapes.items():
            whole = None
            for out in runs["d2m2"]:
                piece = out[f"{CKPT}|{kind}|{path}"]
                if whole is None:
                    whole = np.zeros(shp, piece.dtype)
                whole[shard_slices(src[path], shp,
                                   _rank_mesh("d2m2", out))] = piece
            for out in runs["d4"]:
                got = out[f"load|{kind}|{path}"]
                want = whole[shard_slices(dst[path], shp,
                                          _rank_mesh("d4", out))]
                assert (got.dtype, got.shape, got.tobytes()) == (
                    want.dtype, want.shape, want.tobytes()), path


@pytest.mark.parametrize("mesh", ["m2", "d2m2"])
def test_ep_group_of_the_mesh_matches_the_ep_world(runs, mesh):
    for out in runs[mesh]:
        r = _rank_mesh(mesh, out).coords["model"]
        for name, *_ in EH.CASES:
            got, want = out[f"ep|{name}_y"], runs["ep2"][r][f"{name}_y"]
            assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
            assert float(out[f"ep|{name}_aux"]) == float(
                runs["ep2"][r][f"{name}_aux"])
        assert out["ep|world_sum_after_close"] == np.prod(SHAPES[mesh])
