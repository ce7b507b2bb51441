"""The port's expert-parallel MoE against ``repro``, on the CPU.

``moe_block_ep`` at ep 1 runs in this process on a gloo group of one rank,
against the reference under ``shard_map`` on one device.  At ep 2 and 4
the port runs in spawned gloo ranks (one spawn a world size, every case
inside it) and the reference in a subprocess with 4 forced CPU devices
(``tests/torch_ep_helpers.py``); both read the same numpy inputs and
write ``.npz`` files that this module compares.  Tolerances: f32 2e-5,
bf16 2e-2.  Every scheduled route must give the bits of one all-to-all.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import overlap as joverlap  # noqa: E402
from repro.core import scheduler as jscheduler  # noqa: E402
from repro.core.scheduler import CollectivePlan as JPlan  # noqa: E402
from repro.kernels.compat import shard_map  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.workloads import derive as jderive  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import (CollectivePlan,  # noqa: E402
                              TranslationAwareScheduler)
from repro_torch.core.overlap import scheduled_all_to_all  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.mesh import init_ep_group  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.weights import ep_slice  # noqa: E402
from repro_torch.workloads import derive  # noqa: E402

import torch_ep_helpers as H  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
HELPERS = pathlib.Path(H.__file__)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
ARCH = H.ARCH


def _inputs(rng, T):
    """Full MoE params (f32), tokens, and the dropping case: tokens with a
    large positive sum and router columns 0 and 1 set to 1, so every token
    picks experts 0 and 1, which shard 0 holds at ep 2 and 4."""
    cfg = configs.get_smoke_config(ARCH)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    f32 = np.float32
    inp = {
        "router": rng.standard_normal((D, E), f32) / np.sqrt(D),
        "wi_gate": rng.standard_normal((E, D, F), f32) / np.sqrt(D),
        "wi_up": rng.standard_normal((E, D, F), f32) / np.sqrt(D),
        "wo": rng.standard_normal((E, F, D), f32) / np.sqrt(F),
        "x": rng.standard_normal((T, D), f32),
        "a": rng.standard_normal((16, 16), f32) / 4,
    }
    inp["x_drop"] = np.abs(inp["x"]) + 0.5
    inp["router_drop"] = inp["router"].copy()
    inp["router_drop"][:, :2] = 1.0
    return inp


def _pt(inp):
    return {k: torch.from_numpy(v) for k, v in inp.items()}


@pytest.fixture(scope="module")
def ep1():
    with init_ep_group("cpu") as g:
        yield g


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    """The reference at ep 2 and 4 in one subprocess, beside one spawn of
    port ranks per world size; returns (inputs, ref, {world: [rank
    outputs]})."""
    tmp = tmp_path_factory.mktemp("ep")
    inp = _inputs(np.random.default_rng(7), H.T_LOC * max(H.WORLDS))
    np.savez(tmp / "in.npz", **inp)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    started = []

    def start(*args):
        started.append(subprocess.Popen(
            [sys.executable, str(HELPERS), *map(str, args)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        return started[-1]

    def finish(proc, timeout):
        log = proc.communicate(timeout=timeout)[0]
        assert proc.returncode == 0, log[-3000:]

    try:
        ref = start("jax", tmp / "in.npz", tmp / "ref.npz")
        ranks = {}
        for world in H.WORLDS:
            procs = [start("rank", r, world, tmp / f"store{world}",
                           tmp / "in.npz", tmp / f"w{world}_r{r}.npz")
                     for r in range(world)]
            for p in procs:
                finish(p, 120)
            ranks[world] = [dict(np.load(tmp / f"w{world}_r{r}.npz"))
                            for r in range(world)]
        finish(ref, 180)
    finally:
        for p in started:
            if p.poll() is None:
                p.kill()
                p.wait()
    return inp, dict(np.load(tmp / "ref.npz")), ranks


# ------------------------------------------------------------------- plan
@pytest.mark.parametrize("nbytes", [4096, 1 << 20, 64 << 20])
def test_collective_plan_matches_reference(nbytes):
    """The port's scheduler makes the reference's plans (fields and
    ``est_speedup``), and a JSON round trip (the reference's asdict JSON
    reads back too)."""
    jp = jscheduler.TranslationAwareScheduler(8, overlap_compute_ns=5e3) \
        .plan_all_to_all(nbytes)
    plan = TranslationAwareScheduler(8, overlap_compute_ns=5e3) \
        .plan_all_to_all(nbytes)
    assert [f.name for f in dataclasses.fields(CollectivePlan)] == \
        [f.name for f in dataclasses.fields(JPlan)]
    assert dataclasses.asdict(plan) == dataclasses.asdict(jp)
    assert plan.est_speedup == jp.est_speedup
    assert CollectivePlan.from_json(json.dumps(dataclasses.asdict(jp))) \
        == plan
    assert CollectivePlan.from_json(plan.to_json()) == plan
    assert plan.warmup_chunk_bytes > 0 and plan.n_chunks >= 1


def test_collective_plan_json_names_bad_fields():
    d = dataclasses.asdict(CollectivePlan(1, 2, 0, 1, 0, 1.0, 1.0))
    with pytest.raises(ValueError, match="n_chunks"):
        CollectivePlan.from_json(json.dumps(
            {k: v for k, v in d.items() if k != "n_chunks"}))
    with pytest.raises(ValueError, match="bogus"):
        CollectivePlan.from_json(json.dumps(dict(d, bogus=1)))


# ------------------------------------------------------------------ route
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_reference(dtype):
    jcfg = jconfigs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    inp = _inputs(np.random.default_rng(3), 48)
    x_j = jnp.asarray(inp["x"]).astype(jnp.dtype(dtype))
    idx_j, w_j, aux_j = jmoe.route({"router": jnp.asarray(inp["router"])},
                                   jcfg, x_j)
    x_t = torch.from_numpy(inp["x"]).to(getattr(torch, dtype))
    idx_t, w_t, aux_t = moe.route({"router": torch.from_numpy(
        inp["router"])}, cfg, x_t)
    assert w_t.dtype == x_t.dtype
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(w_t.float().numpy(),
                               np.asarray(w_j.astype(jnp.float32)),
                               **TOL[dtype])
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=2e-5)


# ------------------------------------------------------------ ep 1, here
def _jax_ep1(inp, dtype, plan=None, overlap=None):
    """The reference's block under ``shard_map`` on one CPU device, also
    where jax could take a GPU (whose f32 matmuls run in TF32)."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    cpu = jax.devices("cpu")[0]
    mesh = Mesh(np.array([cpu]), ("model",))

    def f(x, wg, wu, wo, r):
        p = {"wi_gate": wg, "wi_up": wu, "wo": wo, "router": r}
        return jmoe.moe_block_ep(p, jcfg, x, "model", plan=plan,
                                 overlap_compute=overlap)

    with jax.default_device(cpu):
        y, aux = jax.jit(shard_map(f, mesh=mesh, in_specs=(P(),) * 5,
                                   out_specs=(P(), P()), check_vma=False))(
            jnp.asarray(inp["x"]).astype(jnp.dtype(dtype)), inp["wi_gate"],
            inp["wi_up"], inp["wo"], inp["router"])
    return np.asarray(y.astype(jnp.float32)), float(aux)


@pytest.mark.parametrize("scheduled", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_ep_ep1_matches_reference(ep1, dtype, scheduled):
    """At ep 1 the reference is right on every route: the port's block,
    unscheduled and under a warm-up plan with a compute beside it, equals
    it, and the scheduled output equals the unscheduled one bit for bit."""
    cfg = configs.get_smoke_config(ARCH)
    inp = _inputs(np.random.default_rng(4), 40)
    t = _pt(inp)
    x = t["x"].to(getattr(torch, dtype))
    plan = overlap = jplan = joverlap_ = None
    nbytes = derive.moe_a2a_bytes(cfg, 40, 1, x.element_size())
    if scheduled:
        fields = dict(total_bytes=nbytes, n_peers=1,
                      warmup_chunk_bytes=nbytes // 8, n_chunks=2,
                      per_peer_buffer_bytes=nbytes, est_time_ns=1.0,
                      est_time_unscheduled_ns=1.0)
        plan, jplan = CollectivePlan(**fields), JPlan(**fields)
        overlap = (lambda a: torch.tanh(a @ a), t["a"])
        joverlap_ = (lambda a: jnp.tanh(a @ a), jnp.asarray(inp["a"]))
    y, aux = moe.moe_block_ep(t, cfg, x, ep1.group, plan=plan,
                              overlap_compute=overlap)
    y_j, aux_j = _jax_ep1(inp, dtype, jplan, joverlap_)
    np.testing.assert_allclose(y.float().numpy(), y_j, **TOL[dtype])
    np.testing.assert_allclose(float(aux), aux_j, rtol=2e-5)
    if scheduled:
        y0, _ = moe.moe_block_ep(t, cfg, x, ep1.group)
        assert torch.equal(y, y0)


def test_scheduled_routes_at_ep1_return_the_buffer(ep1):
    """Every route at ep 1 is the identity, with the compute's result
    returned unchanged; the reference's overlap functions agree."""
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).view(1, 16, 3)
    a = torch.eye(3)
    for warm, chunks in ((0, 1), (0, 5), (40, 1), (40, 4), (10 ** 6, 3)):
        plan = CollectivePlan(0, 1, warm, chunks, 0, 1.0, 1.0)
        out, y = scheduled_all_to_all(x, ep1.group, plan,
                                      compute_fn=lambda m: m * 3,
                                      compute_arg=a)
        assert torch.equal(out, x) and torch.equal(y, a * 3)
    mesh = jax.make_mesh((1,), ("model",))
    ref = jax.jit(shard_map(
        lambda v: joverlap.pipelined_all_to_all(v, "model", n_chunks=4),
        mesh=mesh, in_specs=P(), out_specs=P(), check_vma=False))(
            jnp.asarray(x.numpy()[0]))
    np.testing.assert_array_equal(np.asarray(ref), x.numpy()[0])


# ------------------------------------------------------- ep 2 and 4 spawned
@pytest.mark.parametrize("case", [c[0] for c in H.CASES])
@pytest.mark.parametrize("world", H.WORLDS)
def test_moe_block_ep_matches_reference(multi, world, case):
    """Each rank's ``y`` and ``aux`` against the reference's shard."""
    _, ref, ranks = multi
    tol = TOL["bfloat16" if case == "bf16" else "float32"]
    y_ref = ref[f"ep{world}_{case}_y"].reshape(world, H.T_LOC, -1)
    for r, out in enumerate(ranks[world]):
        np.testing.assert_allclose(out[f"{case}_y"], y_ref[r], **tol)
        np.testing.assert_allclose(out[f"{case}_aux"],
                                   ref[f"ep{world}_{case}_aux"][r],
                                   rtol=2e-5)
        assert np.isfinite(out[f"{case}_y"]).all()


@pytest.mark.parametrize("world", H.WORLDS)
def test_dropping_case_fills_the_last_slot(multi, world):
    """The rigged router overflows shard 0: assignments drop while slot
    ``(0, C-1)`` holds a kept one, on every rank (the reference adds the
    dropped ones as zeros there; a plain write would overwrite it)."""
    _, _, ranks = multi
    cfg = configs.get_smoke_config(ARCH)
    for out in ranks[world]:
        assert int(out["drop_kept"]) < H.T_LOC * cfg.top_k
        assert int(out["drop_last_slot_meta"]) > 0


@pytest.mark.parametrize("plan", [p[0] for p in H.PLANS])
@pytest.mark.parametrize("world", H.WORLDS)
def test_scheduled_dispatch_equals_one_all_to_all(multi, world, plan):
    """Under every plan the block gives the unscheduled bits, and the
    overlap compute gives what it gives alone."""
    _, _, ranks = multi
    for out in ranks[world]:
        np.testing.assert_array_equal(out[f"sched_{plan}_y"], out["f32_y"])
        np.testing.assert_array_equal(out[f"sched_{plan}_z"],
                                      out["z_alone"])


@pytest.mark.parametrize("world", H.WORLDS)
def test_overlap_routes_equal_one_all_to_all(multi, world):
    """``core.overlap`` on ``[ep, 11, 5]``: each rank receives row ``r`` of
    every peer's buffer; every chunk count (past C too) and every warm-up
    head (clamped to [1, C]) gives those bits."""
    _, _, ranks = multi
    for r, out in enumerate(ranks[world]):
        want = np.stack([np.arange(world * 55, dtype=np.float32)
                         .reshape(world, 11, 5)[r] + 1000 * q
                         for q in range(world)])
        np.testing.assert_array_equal(out["raw_a2a"], want)
        for n in H.PIPE_CHUNKS:
            np.testing.assert_array_equal(out[f"raw_pipe{n}"], want)
        for slots, tail in H.WARMUPS:
            np.testing.assert_array_equal(out[f"raw_warm{slots}_{tail}"],
                                          want)
            np.testing.assert_array_equal(out[f"raw_warm{slots}_{tail}_z"],
                                          out["z_alone"])


@pytest.mark.cuda
def test_cuda_moe_block_ep_matches_reference(ep1):
    """On the card, an NCCL group of one rank beside the gloo one: f32
    against the reference, bf16 scheduled equal to unscheduled bit for
    bit, three grouped_matmul launches a block call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    nccl = dist.new_group([0], backend="nccl")
    cfg = configs.get_smoke_config(ARCH)
    inp = _inputs(np.random.default_rng(8), 40)
    t = {k: v.to(dev) for k, v in _pt(inp).items()}
    ops.reset_launches()
    y, aux = moe.moe_block_ep(t, cfg, t["x"], nccl)
    assert ops.LAUNCHES["grouped_matmul"] == 3
    y_j, aux_j = _jax_ep1(inp, "float32")
    np.testing.assert_allclose(y.cpu().numpy(), y_j, **TOL["float32"])
    np.testing.assert_allclose(float(aux), aux_j, rtol=2e-5)
    x = t["x"].to(torch.bfloat16)
    y0, _ = moe.moe_block_ep(t, cfg, x, nccl)
    for warm, chunks in ((1 << 10, 1), (0, 3), (1 << 10, 3)):
        plan = CollectivePlan(0, 1, warm, chunks, 0, 1.0, 1.0)
        y1, _ = moe.moe_block_ep(t, cfg, x, nccl, plan=plan,
                                 overlap_compute=(torch.sin, t["a"]))
        assert torch.equal(y0, y1)
    dist.destroy_process_group(nccl)


# ------------------------------------------------------------ pieces here
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_kernel_route_matches_plain(dtype):
    """The sorted grouped-matmul route (``ops.grouped_matmul``'s plain
    version here) against the reference's masked einsum, with empty slots
    in every shard's rows and an expert that receives nothing."""
    cfg = configs.get_smoke_config(ARCH)
    rng = np.random.default_rng(5)
    full = _pt(_inputs(rng, 8))
    p = ep_slice(full, 1, 2)                          # experts 4..7
    ep, C, D = 2, 13, cfg.d_model
    dt = getattr(torch, dtype)
    meta = torch.from_numpy(rng.integers(0, 4, (ep, C)).astype(np.int32))
    meta[meta == 3] = 0                               # expert 2 gets none
    meta[:, -3:] = 0                                  # a tail of empties
    recv = torch.from_numpy(rng.standard_normal((ep, C, D), np.float32))
    recv = (recv * (meta > 0)[..., None]).to(dt)
    got = moe.ep_expert_ffn(p, recv, meta)
    want = ref.expert_ffn_ref(p, recv, meta)
    assert got.shape == (ep, C, D) and got.dtype == dt
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **TOL[dtype])
    assert not got[meta == 0].any()


@pytest.mark.parametrize("ep", [1, 2, 4])
def test_a2a_bytes_is_the_send_buffer(ep):
    """The simulator's all-to-all size (the port's copy of
    ``moe_a2a_bytes`` and the reference's) is the ``nbytes`` of the send
    buffer ``ep_dispatch`` builds, at smoke and full width."""
    for arch, T, dt in ((ARCH, 36, torch.float32), (ARCH, 5, torch.bfloat16),
                        ("qwen3-moe-235b-a22b", 24, torch.bfloat16)):
        cfg = configs.get_smoke_config(arch)
        full = moe.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
        x = torch.randn(T, cfg.d_model, generator=torch.Generator()
                        .manual_seed(1)).to(dt)
        d = moe.ep_dispatch(ep_slice(full, 0, ep), cfg, x, ep)
        n = derive.moe_a2a_bytes(cfg, T, ep, dt.itemsize)
        assert d.send.nbytes == n
        assert d.send.shape == (ep, n // (ep * cfg.d_model * dt.itemsize),
                                cfg.d_model)
        assert n == jderive.moe_a2a_bytes(jconfigs.get_smoke_config(arch),
                                          T, ep, dt.itemsize)
    full_cfg = configs.get_config(ARCH)
    assert derive.moe_a2a_bytes(full_cfg, 4096, ep, 2) == \
        jderive.moe_a2a_bytes(jconfigs.get_config(ARCH), 4096, ep, 2)


def test_ep_slice_and_group_errors():
    full = _pt(_inputs(np.random.default_rng(6), 8))
    s = ep_slice(full, 3, 4)
    assert torch.equal(s["wi_gate"], full["wi_gate"][6:8])
    assert torch.equal(s["wo"], full["wo"][6:8])
    assert s["router"] is full["router"]
    with pytest.raises(ValueError, match="rank 4 of 4"):
        ep_slice(full, 4, 4)
    with pytest.raises(ValueError, match="do not split"):
        moe.ep_dispatch(full, configs.get_smoke_config(ARCH),
                        full["x"][:4], 3)
    with pytest.raises(ValueError, match="needs a store"):
        init_ep_group("cpu", world_size=2)


def test_example_runs_on_cpu_with_a_reference_plan(tmp_path):
    """``examples/moe_scheduled_a2a_torch.py --device cpu`` at world size 1
    with a plan the port's scheduler wrote, which is the reference's."""
    plan = TranslationAwareScheduler(8, overlap_compute_ns=5e3) \
        .plan_all_to_all(64 * 64 * 4)
    jplan = jscheduler.TranslationAwareScheduler(8, overlap_compute_ns=5e3) \
        .plan_all_to_all(64 * 64 * 4)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    path = tmp_path / "plan.json"
    path.write_text(plan.to_json())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "moe_scheduled_a2a_torch.py"),
         "--device", "cpu", "--plan", str(path)], capture_output=True,
        text=True, timeout=120, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "scheduled == unscheduled bit for bit" in out.stdout
    assert f"{plan.n_chunks} chunks" in out.stdout
