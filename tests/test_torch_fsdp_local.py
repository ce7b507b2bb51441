"""The sharded steps on a mesh of one rank, in this process (gloo on a
``HashStore``; no jax): the mesh itself, the sharded train, prefill and
serve steps against the unsharded ones bit for bit (every collective runs
on a group of one, which copies), the Trainer and the CLI with a mesh, and
the same train step on the card (``cuda``).  Several ranks:
``test_torch_fsdp.py``."""
import weakref

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch.distributed as dist  # noqa: E402

from repro_torch import configs, optim  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.launch.mesh import (init_mesh, make_local_mesh,  # noqa: E402
                                     PRODUCTION_SHAPES)
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.parallel.fsdp import (Sharded, pspecs_at,  # noqa: E402
                                       reshard, shard_leaf, shard_tree)
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402
from repro_torch.weights import flatten  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "mamba2-780m", "whisper-medium",
         "phi-3-vision-4.2b"]


def _batch(cfg, gen, B=4, S=16):
    b = {"inputs": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                 dtype=torch.int32),
         "targets": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                  dtype=torch.int32)}
    if cfg.n_img_tokens:
        b["img_embeds"] = torch.randn(B, cfg.n_img_tokens, cfg.d_model,
                                      generator=gen)
    if cfg.is_encoder_decoder:
        b["enc_embeds"] = torch.randn(B, cfg.enc_frames, cfg.d_model,
                                      generator=gen)
    return b


def _same(a, b) -> bool:
    fa, fb = flatten(a), flatten(b)
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k], fb[k]) for k in fa)


def _train_both(cfg, device, n_steps=2):
    """Two steps of with_master(adamw), unsharded and sharded at (1, 1),
    from the same params; returns both (params, opt, metrics) and the
    mesh's collective counts."""
    opt = optim.with_master(optim.adamw(optim.cosine_with_warmup(1e-2, 2,
                                                                 10)))
    params = steps.as_trainable(api.init(
        cfg.replace(param_dtype=cfg.dtype),
        torch.Generator(device=device).manual_seed(1), device))
    gen = torch.Generator().manual_seed(2)
    batches = [{k: v.to(device) for k, v in _batch(cfg, gen).items()}
               for _ in range(n_steps)]
    step = steps.make_train_step(cfg, opt)
    p1, s1 = params, opt.init(params)
    for b in batches:
        p1, s1, m1 = step(p1, s1, b)
    with init_mesh(device) as mesh:
        fn, (p_specs, o_specs, b_specs), _, _ = steps.make_train_step(
            cfg, opt, mesh)
        p2 = steps.as_trainable(shard_tree(params, p_specs, mesh))
        s2 = shard_tree(opt.init(params), o_specs, mesh)
        for b in batches:
            p2, s2, m2 = fn(p2, s2, shard_tree(b, b_specs, mesh))
        counts = dict(mesh.collectives)
    return (p1, s1, m1), (p2, s2, m2), counts


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_at_one_rank_equals_unsharded(arch):
    """bf16 working params, f32 master: the same bits, losses and norms
    included; every gather and reduction ran."""
    cfg = configs.get_smoke_config(arch)
    (p1, s1, m1), (p2, s2, m2), counts = _train_both(cfg, "cpu")
    assert _same(p1, p2) and _same(s1, s2)
    assert torch.equal(m1["loss"], m2["loss"])
    assert torch.equal(m1["grad_norm"], m2["grad_norm"])
    assert counts["all_gather"] > 0 and counts["reduce_scatter"] > 0
    assert counts["all_reduce"] > 0


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "whisper-medium"])
def test_sharded_prefill_and_serve_at_one_rank_equal_unsharded(arch):
    cfg = configs.get_smoke_config(arch)
    params = api.cast_for_serving(cfg, api.init(
        cfg, torch.Generator().manual_seed(3), "cpu"))
    gen = torch.Generator().manual_seed(4)
    batch = _batch(cfg, gen, B=2, S=8)
    batch.pop("targets")
    shape = ShapeSpec("t", "decode", 8, 2)
    s_max = 8 + steps.sp.DECODE_MARGIN
    with torch.no_grad():
        want, caches = api.prefill(cfg, params, batch, s_max)
        wants = [want]
        for _ in range(3):
            want, caches = api.decode_step(
                cfg, params, torch.argmax(want, -1), caches)
            wants.append(want)
    with init_mesh("cpu") as mesh:
        pre, (p_specs, b_specs), (_, c_pre), _ = steps.make_prefill_step(
            cfg, mesh, shape)
        dec, (p_dec, _, c_dec), _, _ = steps.make_serve_step(cfg, mesh,
                                                             shape)
        got, caches = pre(shard_tree(params, p_specs, mesh),
                          shard_tree(batch, b_specs, mesh))
        gots = [got]
        caches = reshard(caches, c_pre, c_dec, mesh)
        local = shard_tree(params, p_dec, mesh)
        for _ in range(3):
            got, caches = dec(local, torch.argmax(got, -1), caches)
            gots.append(got)
    assert all(torch.equal(g, w) for g, w in zip(gots, wants))


def test_mesh_owns_the_world_and_its_ep_group_does_not():
    with init_mesh("cpu", shape=(1, 1, 1), multi_pod=True) as mesh:
        assert mesh.shape == {"pod": 1, "data": 1, "model": 1}
        assert mesh.coords == {"pod": 0, "data": 0, "model": 0}
        assert dist.get_world_size(mesh.group("pod")) == 1
        ep = mesh.ep_group()
        assert (ep.rank, ep.size, ep.owns_world) == (0, 1, False)
        ep.close()
        assert dist.is_initialized()
        one = torch.ones(1)
        dist.all_reduce(one, group=ep.group)
    assert not dist.is_initialized()
    with make_local_mesh(1, "cpu") as mesh:
        assert mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="needs a store"):
        init_mesh("cpu", shape=(2, 1))
    with pytest.raises(ValueError, match="does not name the axes"):
        init_mesh("cpu", shape=(1, 1, 1))
    assert not dist.is_initialized()
    assert PRODUCTION_SHAPES[0] == {"data": 16, "model": 16}


def test_trainer_with_a_mesh_resumes_where_it_stopped(tmp_path):
    """The Trainer's sharded step at (1, 1) gives the unsharded Trainer's
    losses bit for bit; killed after step 2 (its checkpoint saved through
    the shardings) and resumed, it ends on the same bits as a run that
    was not stopped."""
    cfg = configs.get_smoke_config("granite-moe-1b-a400m")

    def tcfg(d=None):
        return TrainerConfig(steps=4, batch_size=2, seq_len=16, log_every=1,
                             checkpoint_dir=d, checkpoint_every=2)

    plain = Trainer(cfg, tcfg(), device="cpu").run()
    with init_mesh("cpu") as mesh:
        whole = Trainer(cfg, tcfg(), mesh=mesh).run()
        d = str(tmp_path / "ckpt")
        with pytest.raises(RuntimeError, match="injected failure"):
            Trainer(cfg, tcfg(d), mesh=mesh).run(fail_at_step=2)
        resumed = Trainer(cfg, tcfg(d), mesh=mesh).run()
    assert [h["loss"] for h in whole["history"]] == \
        [h["loss"] for h in plain["history"]]
    assert [h["step"] for h in resumed["history"]] == [2, 3]
    assert _same(resumed["state"]["params"], whole["state"]["params"])
    assert _same(resumed["state"]["opt"], whole["state"]["opt"])
    with pytest.raises(ValueError, match="compression"):
        Trainer(cfg, TrainerConfig(grad_compression="int8"), mesh=mesh)


def test_train_cli_with_a_mesh_of_one(capsys):
    args = ["--arch", "granite-moe-1b-a400m", "--device", "cpu", "--steps",
            "2", "--batch", "2", "--seq", "16"]
    assert train.main(args) == 0
    plain = capsys.readouterr().out
    assert train.main(args + ["--mesh", "1,1"]) == 0
    meshed = capsys.readouterr().out
    assert "mesh {'data': 1, 'model': 1}, gloo" in meshed

    def losses(out):
        return [line.split()[3] for line in out.splitlines()
                if line.startswith("step")]
    assert losses(meshed) == losses(plain) and len(losses(plain)) == 2


@pytest.mark.cuda
def test_cuda_sharded_train_step_equals_unsharded():
    """On the card (NCCL on a HashStore, mesh (1, 1), the CUDA kernels):
    granite's smoke model at a head dim the attention kernel is built for,
    bf16, two steps; the same bits as the unsharded step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: "
                    "python3 chip_smoke.py runs the same at full size)")
    cfg = configs.get_smoke_config("granite-moe-1b-a400m").replace(
        d_head=64)
    (p1, s1, m1), (p2, s2, m2), _ = _train_both(cfg, "cuda")
    assert _same(p1, p2) and _same(s1, s2)
    assert torch.equal(m1["loss"], m2["loss"])


# ------------------------------------------------ what a rank holds at once
class _Coords:
    """The rank at ``coords`` of a mesh of ``shape``, without a world:
    cutting a shard needs no collective."""
    device = torch.device("cpu")

    def __init__(self, shape, coords):
        self.shape, self.coords = shape, coords


def _ranks(shape):
    """A :class:`_Coords` for every rank of a (data, model) mesh."""
    return [_Coords(shape, {"data": d, "model": m})
            for d in range(shape["data"]) for m in range(shape["model"])]


class _Live:
    """The largest number of elements of the tensors it was shown that
    were alive at once."""

    def __init__(self):
        self.live, self.peak, self.total = {}, 0, 0

    def see(self, t):
        self.live[id(t)] = t.numel()
        self.total += t.numel()
        self.peak = max(self.peak, sum(self.live.values()))
        weakref.finalize(t, self.live.pop, id(t), None)


MESH_2X2 = {"data": 2, "model": 2}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cuts_each_leaf_as_it_is_made(arch):
    """``api.init(..., place=)`` gives each rank its shards of the same
    draws, and no two whole leaves are alive at once."""
    cfg = configs.get_smoke_config(arch)
    opt = optim.with_master(optim.adamw(optim.cosine_with_warmup(1e-2, 2,
                                                                 10)))
    _, (p_specs, _, _), _, _ = steps.make_train_step(cfg, opt, MESH_2X2)
    train_cfg = cfg.replace(param_dtype=cfg.dtype)
    whole = api.init(train_cfg, torch.Generator().manual_seed(1), "cpu")
    largest = max(t.numel() for t in flatten(whole).values())
    for rank in _ranks(MESH_2X2):
        live = _Live()

        def place(path, t):
            live.see(t)
            return shard_leaf(t, pspecs_at(p_specs, path), rank)

        got = api.init(train_cfg, torch.Generator().manual_seed(1), "cpu",
                       place)
        assert _same(got, shard_tree(whole, p_specs, rank))
        assert live.peak == largest


@pytest.mark.parametrize("name", ["adamw", "with_master", "adafactor"])
def test_trainer_state_on_a_mesh_is_cut_from_the_start(name):
    """A Trainer on each rank of a (2, 2) mesh starts from its shards of
    the unsharded Trainer's params and optimizer state, built from the
    shards (Adafactor factoring by the whole shapes, at a threshold the
    smoke widths cross only whole)."""
    cfg = configs.get_smoke_config("granite-moe-1b-a400m")
    sched = optim.cosine_with_warmup(1e-2, 2, 10)
    opt = {"adamw": optim.adamw(sched),
           "with_master": optim.with_master(optim.adamw(sched)),
           "adafactor": optim.adafactor(sched,
                                        min_dim_size_to_factor=64)}[name]
    tcfg = TrainerConfig(steps=1, batch_size=2, seq_len=16)
    plain = Trainer(cfg, tcfg, opt, device="cpu").init_state()
    for rank in _ranks(MESH_2X2):
        tr = Trainer(cfg, tcfg, opt, mesh=rank)
        got = tr.init_state()
        assert _same(got["params"], shard_tree(
            plain["params"], tr.shardings["params"], rank))
        assert _same(got["opt"], shard_tree(plain["opt"],
                                            tr.shardings["opt"], rank))
    if name == "adafactor":
        factored = [k for k in flatten(got["opt"]) if k.endswith("/vr")]
        # some leaf factored whole is, as this rank's shard, under 64
        assert any(min(t.shape[-2:]) < 64 for k, t in flatten(
            got["params"]).items() if f"v/{k}/vr" in factored)


def test_sharded_save_gathers_one_leaf_at_a_time(tmp_path, monkeypatch):
    """A sharded save holds one gathered leaf at a time, and writes the
    files of an unsharded save."""
    cfg = configs.get_smoke_config("granite-moe-1b-a400m")
    opt = optim.with_master(optim.adamw(optim.cosine_with_warmup(1e-2, 2,
                                                                 10)))
    params = api.init(cfg.replace(param_dtype=cfg.dtype),
                      torch.Generator().manual_seed(1), "cpu")
    tree = {"params": params, "opt": opt.init(params)}
    live, gather = _Live(), ckpt.gather_leaf

    def counted(*args):
        t = gather(*args)
        live.see(t)
        return t

    monkeypatch.setattr(ckpt, "gather_leaf", counted)
    with init_mesh("cpu") as mesh:
        _, (p_specs, o_specs, _), _, _ = steps.make_train_step(cfg, opt,
                                                               mesh)
        specs = {"params": p_specs, "opt": o_specs}
        ckpt.save_checkpoint(tmp_path / "sharded", 1,
                             shard_tree(tree, specs, mesh), shardings=specs,
                             mesh=mesh)
    ckpt.save_checkpoint(tmp_path / "plain", 1, tree)
    assert live.peak == max(t.numel() for t in flatten(tree).values())
    assert live.total == sum(t.numel() for t in flatten(tree).values())
    names = sorted(p.name for p in (tmp_path / "plain" /
                                    "step_000000001").iterdir())
    for n in names:
        assert (tmp_path / "plain" / "step_000000001" / n).read_bytes() == \
            (tmp_path / "sharded" / "step_000000001" / n).read_bytes(), n


class _WholeWeights(Sharded):
    """A ``Sharded`` whose weights are whole already (no gather, and no
    sublayer tensor-parallel), so that its cache cuts run on a mesh
    without a world."""

    def gather(self, tree, path):
        return tree

    def tp(self, path):
        return None


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "phi-3-vision-4.2b", "whisper-medium"])
def test_prefill_cuts_each_block_cache_as_it_is_made(arch):
    """On a (1, 2) mesh that shards the caches on ``model``, prefill
    returns this rank's shards of the unsharded caches and holds no more
    than one block's whole caches at once."""
    cfg = configs.get_smoke_config(arch)
    params = api.cast_for_serving(cfg, api.init(
        cfg, torch.Generator().manual_seed(3), "cpu"))
    batch = _batch(cfg, torch.Generator().manual_seed(4), B=2, S=8)
    batch.pop("targets")
    s_max = 8 + steps.sp.DECODE_MARGIN
    shape = {"data": 1, "model": 2}
    _, _, (_, c_specs), _ = steps.make_prefill_step(
        cfg, shape, ShapeSpec("t", "decode", 8, 2))
    with torch.no_grad():
        want_logits, want = api.prefill(cfg, params, batch, s_max)
    n_blocks = cfg.n_layers if cfg.is_encoder_decoder else cfg.n_blocks
    cut_somewhere = False
    for rank in _ranks(shape):
        live = _Live()
        sharded = _WholeWeights(rank, None, cache_pspecs=c_specs)
        cut = sharded.cache_cut

        def counted(cache, name, *local):
            for t in ([cache] if isinstance(cache, torch.Tensor)
                      else cache):
                if isinstance(t, torch.Tensor):
                    live.see(t)
            return cut(cache, name, *local)

        sharded.cache_cut = counted
        with torch.no_grad():
            logits, got = api.prefill(cfg, params, batch, s_max, sharded)
        assert torch.equal(logits, want_logits)
        cut_want = shard_tree(want, c_specs, rank)
        assert all(torch.equal(a, b) for a, b in zip(
            _cache_leaves(got), _cache_leaves(cut_want)))
        cut_somewhere |= any(a.shape != b.shape for a, b in zip(
            _cache_leaves(got), _cache_leaves(want)))
        assert live.total > 0 and live.peak <= live.total // n_blocks
    assert cut_somewhere


def _cache_leaves(caches):
    out = []
    for c in (caches.values() if isinstance(caches, dict) else caches):
        for t in ([c] if isinstance(c, torch.Tensor) else c):
            if isinstance(t, torch.Tensor):
                out.append(t)
    return out
