"""Processes that ``test_torch_ep.py`` starts: the reference at ep > 1
and the port's ranks.  Not a test module (pytest does not collect it).

    python tests/torch_ep_helpers.py jax INPUTS.npz OUT.npz
    python tests/torch_ep_helpers.py rank RANK WORLD STORE INPUTS.npz OUT.npz

``jax`` runs ``repro.models.moe.moe_block_ep`` under ``shard_map`` on 2
and 4 forced CPU devices (the flag must be set before jax is imported,
so it cannot run inside a pytest worker).  ``rank`` is one gloo rank of
``repro_torch``'s ``moe_block_ep`` and ``core.overlap``; it imports no jax.
Inputs are the numpy arrays the test writes: the full MoE params
(``router``, ``wi_gate``, ``wi_up``, ``wo``), a rigged router for the
dropping case (``router_drop``), the tokens of every rank (``x``,
``x_drop``) and the overlap compute's operand (``a``).
"""
import os
import sys

import numpy as np

ARCH = "granite-moe-1b-a400m"
T_LOC = 36          # tokens a rank: C = 44 at ep 2, 22 at ep 4 (not
                    # divisible by 3 or 8)
WORLDS = (2, 4)
# (name, x, router, dtype) of each unscheduled case
CASES = (("f32", "x", "router", "float32"),
         ("bf16", "x", "router", "bfloat16"),
         ("drop", "x_drop", "router_drop", "float32"))
# the dispatch's schedules: (name, warm-up slots per peer, n_chunks)
PLANS = (("warmup", 3, 1), ("chunks1", 0, 1), ("chunks2", 0, 2),
         ("chunks3", 0, 3), ("chunks8", 0, 8), ("both", 5, 3))
# core.overlap directly on a [ep, 11, 5] buffer: pipelined chunk counts,
# warm-up (slots, tail chunks); 0 and 99 slots clamp to 1 and C
PIPE_CHUNKS = (1, 2, 3, 8, 11, 20)
WARMUPS = ((0, 1), (1, 1), (4, 3), (10, 2), (99, 2))


def jax_block(ep, inputs, xname, rname, dtype, plan=None, overlap=None):
    """The reference's EP block on ``ep`` devices: ``(y [T, D], aux
    [ep])`` as f32 numpy, with x sharded over ``model``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro import configs
    from repro.kernels.compat import shard_map
    from repro.models.moe import moe_block_ep

    cfg = configs.get_smoke_config(ARCH)
    mesh = Mesh(np.array(jax.devices()[:ep]), ("model",))

    def inner(x, wg, wu, wo, r):
        p = {"wi_gate": wg, "wi_up": wu, "wo": wo, "router": r}
        y, aux = moe_block_ep(p, cfg, x, "model", plan=plan,
                              overlap_compute=overlap)
        return y, aux[None]

    espec = P("model", None, None)
    f = shard_map(inner, mesh=mesh,
                  in_specs=(P("model", None), espec, espec, espec, P()),
                  out_specs=(P("model", None), P("model")), check_vma=False)
    x = jnp.asarray(inputs[xname][:T_LOC * ep]).astype(jnp.dtype(dtype))
    y, aux = jax.jit(f)(x, inputs["wi_gate"], inputs["wi_up"],
                        inputs["wo"], inputs[rname])
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(aux, np.float32))


def jax_main(inputs_path, out_path):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=4")
    inputs = dict(np.load(inputs_path))
    out = {}
    for ep in WORLDS:
        for name, xname, rname, dtype in CASES:
            y, aux = jax_block(ep, inputs, xname, rname, dtype)
            out[f"ep{ep}_{name}_y"], out[f"ep{ep}_{name}_aux"] = y, aux
    np.savez(out_path, **out)


def rank_main(rank, world, store_path, inputs_path, out_path):
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core import CollectivePlan
    from repro_torch.core.overlap import (_a2a, pipelined_all_to_all,
                                          warmup_all_to_all)
    from repro_torch.launch.mesh import init_ep_group
    from repro_torch.models.moe import ep_dispatch, moe_block_ep
    from repro_torch.weights import ep_slice

    torch.set_num_threads(1)
    cfg = configs.get_smoke_config(ARCH)
    inputs = {k: torch.from_numpy(v) for k, v in np.load(inputs_path).items()}
    lo, hi = rank * T_LOC, (rank + 1) * T_LOC
    out = {}
    store = dist.FileStore(store_path, world)
    with init_ep_group("cpu", store=store, rank=rank,
                       world_size=world) as g:
        def params(rname):
            full = {k: inputs[k] for k in ("wi_gate", "wi_up", "wo")}
            return ep_slice(dict(full, router=inputs[rname]), rank, world)

        for name, xname, rname, dtype in CASES:
            x = inputs[xname][lo:hi].to(getattr(torch, dtype))
            y, aux = moe_block_ep(params(rname), cfg, x, g.group)
            out[f"{name}_y"], out[f"{name}_aux"] = y.float().numpy(), aux
        d = ep_dispatch(params("router_drop"), cfg, inputs["x_drop"][lo:hi],
                        world)
        out["drop_kept"] = d.keep.sum()
        out["drop_last_slot_meta"] = d.meta[0, -1]

        # every schedule of the dispatch, with a compute beside it
        p, x = params("router"), inputs["x"][lo:hi]
        slot_bytes = world * cfg.d_model * x.element_size()
        out["z_alone"] = torch.tanh(inputs["a"] @ inputs["a"])
        for name, slots, chunks in PLANS:
            plan = CollectivePlan(
                total_bytes=0, n_peers=world,
                warmup_chunk_bytes=slots * slot_bytes, n_chunks=chunks,
                per_peer_buffer_bytes=0, est_time_ns=0.0,
                est_time_unscheduled_ns=0.0)
            got = []

            def compute(a):
                got.append(torch.tanh(a @ a))
                return got[-1]

            y, _ = moe_block_ep(p, cfg, x, g.group, plan=plan,
                                overlap_compute=(compute, inputs["a"]))
            out[f"sched_{name}_y"], out[f"sched_{name}_z"] = y, got[0]

        # core.overlap on a buffer whose slot count no chunk count divides
        buf = (torch.arange(world * 11 * 5, dtype=torch.float32)
               .view(world, 11, 5) + 1000 * rank)
        out["raw_a2a"] = _a2a(buf, g.group)
        for n in PIPE_CHUNKS:
            out[f"raw_pipe{n}"] = pipelined_all_to_all(buf, g.group,
                                                       n_chunks=n)
        for slots, tail in WARMUPS:
            o, z = warmup_all_to_all(
                buf, g.group, warmup_slots=slots, tail_chunks=tail,
                compute_fn=lambda a: torch.tanh(a @ a),
                compute_arg=inputs["a"])
            out[f"raw_warm{slots}_{tail}"], out[f"raw_warm{slots}_{tail}_z"] \
                = o, z
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        jax_main(*sys.argv[2:4])
    else:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
