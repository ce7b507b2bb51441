"""Port training path against ``repro``: loss and gradients, the train step,
the Trainer, the data pipeline and the CLI, on smoke configs, on the CPU.

Weights come from the JAX init, exported with ``np.asarray`` and loaded
with ``repro_torch.weights.from_jax_params``; batches are numpy arrays made
from a seed and given to both.  The references are
``jax.value_and_grad(repro.models.api.loss_fn)``, the optimizers composed
by hand after it, and ``repro.runtime.Trainer(...)._step`` (not
``launch/steps.make_train_step``, which is red on jax 0.9.0), called with
no logical rules installed.  On the CPU the port's kernels are their plain
versions, which autograd follows.  Tolerances: the loss 1e-5 relative;
each gradient leaf 1e-4 relative to its max |g| (f32 sums in other orders
through a few layers and their backward).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models.base import set_logical_rules  # noqa: E402
from repro.runtime import Trainer as JTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import configs, data, optim  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.spec import ModelConfig  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402
from repro_torch.weights import (flatten, from_jax_opt_state,  # noqa: E402
                                 from_jax_params, to_numpy, tree_map)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
# MoE with aux; dense with qk-norm; encoder-decoder; VLM (image embeds,
# sliced logits); SSM through the plain SSD scan
ARCHS = ["granite-moe-1b-a400m", "qwen3-1.7b", "whisper-medium",
         "phi-3-vision-4.2b", "mamba2-780m"]


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
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _batch(cfg, B=2, S=16, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    if mask:
        batch["mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    if cfg.n_img_tokens:
        batch["img_embeds"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_loss_and_grads(cfg, tp, batch):
    params = steps.as_trainable(tp)
    loss, metrics = api.loss_fn(cfg, params, _torch_batch(batch))
    flat = flatten(params)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss, metrics, dict(zip(flat, grads))


def _close_leaves(got, want, tol=GRAD_TOL):
    """Every leaf of ``want`` (path -> array) against ``got``, relative to
    the leaf's max |want|."""
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        g = g.detach().float().numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, (path, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """``api.loss_fn`` and the gradient of every parameter leaf against
    ``jax.value_and_grad(repro.models.api.loss_fn)`` on the same weights
    and batch (a loss mask on the dense and VLM models)."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    batch = _batch(cfg, mask=arch in ("qwen3-1.7b", "phi-3-vision-4.2b"))
    (jl, jm), jg = jax.value_and_grad(
        lambda p: japi.loss_fn(jcfg, p, _jax_batch(batch)), has_aux=True)(jp)
    loss, metrics, grads = _port_loss_and_grads(cfg, tp, batch)
    assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    for name in ("nll", "aux", "tokens"):
        np.testing.assert_allclose(float(metrics[name]), float(jm[name]),
                                   rtol=LOSS_RTOL, atol=1e-6)
    jflat = flatten(jax.tree.map(np.asarray, jg))
    _close_leaves(grads, jflat)
    # every leaf the reference trains gets a gradient here too
    for path, w in jflat.items():
        if np.abs(w).max() > 0:
            assert float(grads[path].abs().max()) > 0, path


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "whisper-medium"])
def test_remat_on_and_off_give_the_same_gradients(arch):
    """``cfg.remat`` (torch.utils.checkpoint around each layer or block)
    recomputes the same forward, so the loss and gradients are the same
    as without it."""
    jcfg, cfg = _cfgs(arch)
    _, tp = _params(jcfg)
    batch = _batch(cfg, seed=3)
    assert cfg.remat
    l1, _, g1 = _port_loss_and_grads(cfg, tp, batch)
    l0, _, g0 = _port_loss_and_grads(cfg.replace(remat=False), tp, batch)
    assert float(l1) == float(l0)
    for path in g0:
        torch.testing.assert_close(g1[path], g0[path], rtol=1e-6, atol=0)


def _jax_step(jcfg, joptimizer, jp, jstate, batch, microbatches):
    """The reference train step composed by hand: value_and_grad (with f32
    accumulation over microbatches), clip_by_global_norm, update."""
    def loss(p, b):
        return japi.loss_fn(jcfg, p, b)[0]

    jb = _jax_batch(batch)
    if microbatches == 1:
        lval, grads = jax.value_and_grad(loss)(jp, jb)
    else:
        n = next(iter(batch.values())).shape[0] // microbatches
        gsum = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jp)
        lsum = 0.0
        for i in range(microbatches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in jb.items()}
            l, g = jax.value_and_grad(loss)(jp, mb)
            gsum = jax.tree.map(lambda a, x: a + x.astype(jnp.float32), gsum,
                                g)
            lsum = lsum + l
        grads = jax.tree.map(lambda g: g / microbatches, gsum)
        lval = lsum / microbatches
    grads, gnorm = joptim.clip_by_global_norm(grads, 1.0)
    new_p, new_s = joptimizer.update(grads, jstate, jp)
    return lval, gnorm, new_p, new_s


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """``launch.steps.make_train_step`` (AdamW, clip 1.0) against the
    reference's grad, clip and update composed by hand: the loss, the
    gradient norm, the new params and the optimizer state."""
    jcfg, cfg = _cfgs("granite-moe-1b-a400m")
    jp, tp = _params(jcfg, seed=1)
    batch = _batch(cfg, B=4, seed=2)
    jsched = joptim.cosine_with_warmup(1e-2, 2, 10)
    joptimizer = joptim.adamw(jsched)
    jl, jn, jp2, js2 = _jax_step(jcfg, joptimizer, jp, joptimizer.init(jp),
                                 batch, microbatches)
    optimizer = optim.adamw(optim.cosine_with_warmup(1e-2, 2, 10))
    step = steps.make_train_step(cfg, optimizer, microbatches=microbatches)
    p2, s2, metrics = step(tp, optimizer.init(tp), _torch_batch(batch))
    assert abs(float(metrics["loss"]) - float(jl)) <= LOSS_RTOL * abs(
        float(jl))
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jn),
                               rtol=1e-5)
    assert all(t.requires_grad and t.is_leaf for t in flatten(p2).values())
    # The first AdamW update is about lr * g / (|g| + eps) per element: for
    # a gradient near eps it turns the 1e-6 relative differences of the
    # gradients into up to a percent of the step.  So each element's update
    # is held to 2% of the step's learning rate.
    lr = float(jsched(1))
    jflat = flatten(jax.tree.map(np.asarray, jp2))
    flat0, flat2 = flatten(tp), flatten(p2)
    for path, w in jflat.items():
        got = flat2[path].detach().numpy()
        assert got.dtype == np.float32
        old = flat0[path].numpy()
        np.testing.assert_allclose(got - old, w - old, rtol=0,
                                   atol=2e-2 * lr, err_msg=path)
    sflat = flatten(jax.tree.map(np.asarray, js2))
    _close_leaves({k: v for k, v in flatten(s2).items() if k != "count"},
                  {k: v for k, v in sflat.items() if k != "count"}, tol=1e-4)
    assert int(s2["count"]) == int(js2["count"]) == 1


# bf16 working params: each side rounds its matmuls, norms and updates to
# bf16 in its own order, and at a learning rate of 1e-2 AdamW's first steps
# move an element by about lr * sign(g), so a near-zero gradient that rounds
# to the other sign moves it the other way.  After three steps the losses
# agree to a few bf16 ulps of the loss (2**-8 relative each), not to f32's
# 1e-5; each side's bf16 loss is 10-37% from its own f32 loss here.
BF16_LOSS_RTOL = 2 ** -6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_matches_reference_trainer_steps(dtype):
    """Three steps of the port's ``Trainer`` against three calls of
    ``repro.runtime.Trainer(...)._step`` (its jitted step: grad, clip,
    ``with_master(adamw(cosine_with_warmup))``) from the same carried
    weights, on the same batches: the losses agree within 1e-5 in f32, and
    within ``BF16_LOSS_RTOL`` with bf16 working params and the f32 master,
    the setup the card trains with."""
    jcfg, cfg = _cfgs("granite-moe-1b-a400m")
    jcfg, cfg = jcfg.replace(dtype=dtype), cfg.replace(dtype=dtype)
    tkw = dict(steps=3, batch_size=2, seq_len=16, peak_lr=1e-2, warmup=1,
               seed=4, log_every=1)
    jt = JTrainer(jcfg, JTrainerConfig(**tkw))
    jstate = jt.init_state()
    # in f32, with_master's master is the params' own buffer, which the
    # jitted step would be given (and donate) twice: give it a copy
    jstate["opt"] = jax.tree.map(lambda x: jnp.array(x, copy=True),
                                 jstate["opt"])
    tp = from_jax_params(jax.tree.map(np.asarray, jstate["params"]),
                         keep_bf16=True)
    assert {t.dtype for t in flatten(tp).values()} == {
        getattr(torch, dtype)}
    it = jdata.make_batch_iterator(jcfg, 2, 16, seed=4)
    jlosses = []
    params, opt, comp = jstate["params"], jstate["opt"], jstate["comp"]
    for _ in range(3):
        batch = {k: jnp.asarray(v) for k, v in next(it).items()}
        params, opt, comp, m = jt._step(params, opt, comp, batch)
        jlosses.append(float(m["loss"]))
    out = Trainer(cfg, TrainerConfig(**tkw), device="cpu").run(params=tp)
    losses = [h["loss"] for h in out["history"]]
    assert [h["step"] for h in out["history"]] == [0, 1, 2]
    assert {t.dtype for t in flatten(out["state"]["params"]).values()} == {
        getattr(torch, dtype)}
    np.testing.assert_allclose(
        losses, jlosses,
        rtol=LOSS_RTOL if dtype == "float32" else BF16_LOSS_RTOL)
    assert out["data_step"] == 3 and out["final_loss"] == losses[-1]
    mine = flatten(out["state"]["opt"])
    theirs = flatten(jax.tree.map(np.asarray, opt))
    assert set(mine) == set(theirs)
    if dtype != "float32":
        return
    # the master and moments after three steps, too: the moments within
    # 1e-4 of their max, the master within 2% of a step's size (see
    # test_train_step_matches_reference)
    _close_leaves({p: t for p, t in mine.items() if "/m/" in p or "/v/" in p},
                  {p: t for p, t in theirs.items()
                   if "/m/" in p or "/v/" in p})
    for path in (p for p in theirs if p.startswith("master/")):
        np.testing.assert_allclose(mine[path].numpy(), theirs[path], rtol=0,
                                   atol=2e-2 * tkw["peak_lr"], err_msg=path)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "whisper-medium",
                                  "phi-3-vision-4.2b"])
def test_data_pipeline_matches_reference(arch):
    """The port's copy of the data pipeline gives the reference's batches
    bit for bit, stub modality inputs and shards included."""
    cfg = configs.get_smoke_config(arch)
    jcfg = jconfigs.get_smoke_config(arch)
    for shard, num_shards in ((0, 1), (1, 2)):
        ours = data.make_batch_iterator(cfg, 4, 24, seed=7, shard=shard,
                                        num_shards=num_shards)
        theirs = jdata.make_batch_iterator(jcfg, 4, 24, seed=7, shard=shard,
                                           num_shards=num_shards)
        for _ in range(3):
            a, b = next(ours), next(theirs)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        assert ours.state_dict() == theirs.state_dict()


def test_trainer_checkpoint_dir_raises(tmp_path):
    """Checkpointing is the next slice: a ``checkpoint_dir`` raises rather
    than train without saving, and so does the CLI's ``--ckpt``."""
    cfg = configs.get_smoke_config("granite-moe-1b-a400m")
    with pytest.raises(NotImplementedError, match="queue 1, item 2"):
        Trainer(cfg, TrainerConfig(checkpoint_dir=str(tmp_path)),
                device="cpu")
    from repro_torch.launch import train
    with pytest.raises(NotImplementedError, match="checkpoint"):
        train.main(["--arch", "granite-moe-1b-a400m", "--device", "cpu",
                    "--steps", "1", "--ckpt", str(tmp_path)])


def test_train_cli_cpu_prints_losses(capsys):
    """``python -m repro_torch.launch.train --device cpu`` trains the smoke
    model and prints a finite loss for each step."""
    from repro_torch.launch import train
    rc = train.main(["--arch", "granite-moe-1b-a400m", "--device", "cpu",
                     "--steps", "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert rc == 0
    lines = [ln for ln in out.splitlines() if ln.startswith("step")]
    assert len(lines) == 2
    losses = [float(ln.split("loss")[1].split()[0]) for ln in lines]
    assert all(np.isfinite(losses))
    assert "final loss" in out


def test_entry_points_default_to_the_card():
    """Without ``device="cpu"`` the Trainer and the CLI ask for CUDA, and
    raise here, where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = configs.get_smoke_config("granite-moe-1b-a400m")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, TrainerConfig(steps=1))
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "granite-moe-1b-a400m", "--steps", "1"])


# -------------------------------------------------------- weights carry
def test_weights_carry_params_and_opt_state_round_trip():
    """bf16 working params load as bf16 bit for bit (``keep_bf16``) or
    widened to f32; ``with_master(adamw)`` and ``adafactor`` state trees
    load with their paths and dtypes, and ``to_numpy`` gives them back."""
    jcfg = jconfigs.get_smoke_config("granite-moe-1b-a400m")
    jp, _ = japi.init(jcfg.replace(param_dtype=jcfg.dtype),
                      jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)
    bf = from_jax_params(np_params, keep_bf16=True)
    wide = from_jax_params(np_params)
    for path, leaf in flatten(np_params).items():
        assert flatten(bf)[path].dtype == torch.bfloat16
        assert flatten(wide)[path].dtype == torch.float32
        np.testing.assert_array_equal(flatten(to_numpy(bf))[path],
                                      leaf.astype(np.float32))
        np.testing.assert_array_equal(flatten(wide)[path].numpy(),
                                      leaf.astype(np.float32))
    sched = joptim.cosine_with_warmup(1e-3, 1, 10)
    for jopt in (joptim.with_master(joptim.adamw(sched)),
                 joptim.adafactor(sched, min_dim_size_to_factor=32)):
        state = jopt.init(jp)
        grads = jax.tree.map(lambda p: jnp.ones_like(p), jp)
        _, state = jopt.update(grads, state, jp)
        np_state = jax.tree.map(np.asarray, state)
        ours = from_jax_opt_state(np_state)
        back = flatten(to_numpy(ours))
        flat = flatten(np_state)
        assert set(back) == set(flat)
        for path, leaf in flat.items():
            assert flatten(ours)[path].shape == leaf.shape
            np.testing.assert_array_equal(back[path], leaf)
            assert back[path].dtype == leaf.dtype
        count = [t for p, t in flatten(ours).items() if p.endswith("count")]
        assert len(count) == 1 and count[0].dtype == torch.int32
        assert int(count[0]) == 1


# ------------------------------------------------------ on the card only
@pytest.mark.cuda
def test_cuda_loss_and_grads_match_cpu():
    """The training path through the CUDA kernels and their backward
    kernels (f32) against the same path on the CPU (the plain versions):
    the loss and every gradient leaf within 1e-4 of its max |g|, each
    finite and not all zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: "
                    "python3 chip_smoke.py covers the same checks)")
    from repro_torch.kernels import ops
    # the smoke width with a head dim the attention kernel is built for
    cfg = configs.get_smoke_config("granite-moe-1b-a400m").replace(
        dtype="float32", d_head=64)
    tp = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg, B=2, S=32, seed=5)
    lc, _, gc = _port_loss_and_grads(cfg, tp, batch)
    gpu = tree_map(lambda t: t.cuda(), tp)
    ops.reset_launches()
    params = steps.as_trainable(gpu)
    loss, _ = api.loss_fn(cfg, params, {k: v.cuda() for k, v in
                                        _torch_batch(batch).items()})
    flat = flatten(params)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    assert all(ops.LAUNCHES[n] > 0 for n in (
        "rmsnorm_bwd", "flash_attention_bwd", "grouped_matmul_dx",
        "grouped_matmul_dw"))
    assert abs(float(loss) - float(lc)) <= 1e-4 * abs(float(lc))
    _close_leaves({k: v.cpu() for k, v in grads.items()},
                  {k: v.numpy() for k, v in gc.items()})
    for path, g in grads.items():
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, \
            path
