"""The ranks that ``test_torch_fsdp.py`` spawns.  Not a test module (pytest
does not collect it).

    python tests/torch_fsdp_helpers.py RANK WORLD STORE PLAN.json IN.npz OUT

Each rank builds ``repro_torch.launch.mesh.init_mesh("cpu", shape=...)``
on a gloo ``FileStore`` and runs the plan's jobs in order, writing what
it holds to ``OUT.rank{RANK}.npz``:

- ``train``: the sharded ``make_train_step`` (AdamW or Adafactor) from the
  whole params in the inputs, cut to this rank's shards, for every batch
  of the inputs (this rank's rows of each); its loss, grad norm, and its
  shards of the params and optimizer state after the last step.  On a
  ``model`` axis of more than one rank mamba2's embeddings and loss
  (``WHOLE_VOCAB``) and its SSM mixers (``WHOLE_MIXER``) are computed
  whole (``test_torch_fsdp.py`` says why).  With
  ``count_gathers`` the gathers report every leaf they return, and the
  largest number of elements alive at once is written.
- ``serve``: the sharded prefill of the inputs' prompts, the caches
  resharded into the serve step's layout, then a decode step for each of
  the inputs' tokens; the logits of each (this rank's shard).
- ``save`` / ``load``: the state of a ``train`` job saved sharded into a
  directory, or loaded from it onto this mesh, as this rank's shards.
- ``ep``: ``moe_block_ep`` on ``mesh.ep_group()`` (the ``model`` axis) at
  the tokens and experts of its ``model`` coordinate, the unscheduled
  cases of ``torch_ep_helpers``; then the group is closed and the world
  must still sum a tensor.

Imports no jax.
"""
import json
import sys
import weakref

import numpy as np

ARCHS = ("granite-moe-1b-a400m", "mamba2-780m")
LR = (1e-2, 2, 10)          # cosine_with_warmup(peak, warmup, steps)
SERVE_SHAPE = ("fsdp_serve", "decode", 12, 8)   # name, kind, S, B
# Adafactor factors leaves whose last two dims reach this: the smoke
# models' widths (64) would factor none at the default 128
FACTOR_MIN = 32
# the architectures whose vocab-parallel sublayers the train job computes
# whole on a model axis of more than one rank
WHOLE_VOCAB = ("mamba2-780m",)
# ... and whose SSM mixers it computes whole there: on their ssm_inner
# shard (the gated norm's row sums and out_proj summed over model) the
# three-step Adam moment of mamba2's D moves 2.2e-6 at (1, 2) and 2.0e-6 at
# (2, 2) from the unsharded step's, past this file's 1e-4 of its max
# (1.35e-6); test_torch_tp.py holds that route at its first step
WHOLE_MIXER = ("mamba2-780m",)


def smoke_cfg(arch):
    from repro_torch import configs
    return configs.get_smoke_config(arch).replace(dtype="float32")


def optimizer(name):
    from repro_torch import optim
    sched = optim.cosine_with_warmup(*LR)
    return (optim.adamw(sched) if name == "adamw"
            else optim.adafactor(sched, min_dim_size_to_factor=FACTOR_MIN))


def _torch(inputs, prefix):
    import torch
    from repro_torch.weights import unflatten
    return unflatten({k[len(prefix):]: torch.from_numpy(v)
                      for k, v in inputs.items() if k.startswith(prefix)})


def _put(out, prefix, tree):
    from repro_torch.weights import flatten
    for path, t in flatten(tree).items():
        if hasattr(t, "detach"):
            out[f"{prefix}{path}"] = t.detach().numpy()


def train(job, mesh, inputs, out, states):
    import torch
    from repro_torch.launch import steps
    from repro_torch.parallel.fsdp import shard_leaf, shard_tree

    cfg, opt = smoke_cfg(job["arch"]), optimizer(job["opt"])
    fn, (p_specs, o_specs, b_specs), _, _ = steps.make_train_step(
        cfg, opt, mesh, multi_pod="pod" in mesh.shape,
        microbatches=job.get("microbatches", 1))
    if mesh.shape["model"] > 1:
        tp, arch = fn.sharded.tp, job["arch"]
        fn.sharded.tp = lambda path: (
            None if (arch in WHOLE_VOCAB and path in ("tok_embed", "unembed"))
            or (arch in WHOLE_MIXER and path.endswith("/ssm")) else tp(path))
    full = _torch(inputs, f"{job['arch']}|params|")
    params = steps.as_trainable(shard_tree(full, p_specs, mesh))
    state = shard_tree(opt.init(full), o_specs, mesh)
    live, peak = {}, [0]
    if job.get("count_gathers"):
        def seen(t):
            live[id(t)] = t.numel()
            peak[0] = max(peak[0], sum(live.values()))
            weakref.finalize(t, live.pop, id(t), None)
        fn.sharded.on_gather = seen
    name = job["name"]
    for i in range(job["steps"]):
        batch = shard_tree(_torch(inputs, f"{job['arch']}|batch{i}|"),
                           b_specs, mesh)
        if job.get("mask"):
            # a mask is cut as the tokens are (the reference's batch specs
            # name none)
            batch["mask"] = shard_leaf(torch.from_numpy(
                inputs[f"{job['arch']}|mask{i}"]), b_specs["inputs"], mesh)
        params, state, m = fn(params, state, batch)
        out[f"{name}|loss{i}"] = m["loss"].numpy()
        out[f"{name}|gnorm{i}"] = m["grad_norm"].numpy()
    fn.sharded.on_gather = None
    out[f"{name}|peak_gathered"] = np.asarray(peak[0])
    _put(out, f"{name}|p|", params)
    _put(out, f"{name}|o|", state)
    states[name] = (job, {"params": params, "opt": state},
                    {"params": p_specs, "opt": o_specs})


def serve(job, mesh, inputs, out):
    import torch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import steps
    from repro_torch.parallel.fsdp import reshard, shard_leaf, shard_tree

    cfg = smoke_cfg(job["arch"])
    name, kind, S, B = SERVE_SHAPE
    shape = ShapeSpec(name, kind, S, B)
    pre, (p_specs, b_specs), (_, c_pre), _ = steps.make_prefill_step(
        cfg, mesh, shape)
    dec, (p_dec, t_spec, c_dec), _, _ = steps.make_serve_step(cfg, mesh,
                                                              shape)
    full = _torch(inputs, f"{job['arch']}|params|")
    prompts = torch.from_numpy(inputs[f"{job['arch']}|prompts"])
    logits, caches = pre(shard_tree(full, p_specs, mesh),
                         shard_tree({"inputs": prompts}, b_specs, mesh))
    out[f"{job['name']}|prefill"] = logits.numpy()
    # decode's rules shard the K/V weights and caches on head_dim
    params = shard_tree(full, p_dec, mesh)
    caches = reshard(caches, c_pre, c_dec, mesh)
    for i, tok in enumerate(inputs[f"{job['arch']}|tokens"]):
        tok = shard_leaf(torch.from_numpy(tok), t_spec, mesh)
        logits, caches = dec(params, tok, caches)
        out[f"{job['name']}|decode{i}"] = logits.numpy()


def save(job, mesh, states):
    from repro_torch.checkpoint import save_checkpoint

    _, tree, specs = states[job["from"]]
    save_checkpoint(job["dir"], 3, tree, shardings=specs, mesh=mesh)


def load(job, mesh, out):
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch import steps

    cfg, opt = smoke_cfg(job["arch"]), optimizer(job["opt"])
    _, (p_specs, o_specs, _), _, (p_s, o_s) = steps.make_train_step(
        cfg, opt, mesh)
    tree = load_checkpoint(job["dir"], 3, {"params": p_s, "opt": o_s},
                           device="cpu",
                           shardings={"params": p_specs, "opt": o_specs},
                           mesh=mesh)
    _put(out, f"{job['name']}|p|", tree["params"])
    _put(out, f"{job['name']}|o|", tree["opt"])


def ep(job, mesh, inputs, out):
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.models.moe import moe_block_ep
    from repro_torch.weights import ep_slice

    import torch_ep_helpers as H

    cfg = configs.get_smoke_config(H.ARCH)
    g = mesh.ep_group()
    r = g.rank
    x_all = {k: torch.from_numpy(inputs[f"ep|{k}"])
             for k in ("x", "x_drop")}
    for name, xname, rname, dtype in H.CASES:
        full = {k: torch.from_numpy(inputs[f"ep|{k}"])
                for k in ("wi_gate", "wi_up", "wo")}
        p = ep_slice(dict(full, router=torch.from_numpy(
            inputs[f"ep|{rname}"])), r, g.size)
        x = x_all[xname][r * H.T_LOC:(r + 1) * H.T_LOC].to(
            getattr(torch, dtype))
        y, aux = moe_block_ep(p, cfg, x, g.group)
        out[f"ep|{name}_y"], out[f"ep|{name}_aux"] = y.float().numpy(), aux
    g.close()
    one = torch.ones(1)
    dist.all_reduce(one)
    out["ep|world_sum_after_close"] = one.numpy()


def main(rank, world, store_path, plan_path, inputs_path, out_path):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_mesh

    torch.set_num_threads(1)
    plan = json.loads(open(plan_path).read())
    inputs = dict(np.load(inputs_path))
    out, states = {}, {}
    store = dist.FileStore(store_path, world)
    with init_mesh("cpu", shape=tuple(plan["shape"]),
                   multi_pod=len(plan["shape"]) == 3, store=store,
                   rank=rank) as mesh:
        out["coords"] = np.asarray([mesh.coords[a] for a in mesh.shape])
        for job in plan["jobs"]:
            if job["kind"] == "train":
                train(job, mesh, inputs, out, states)
            elif job["kind"] == "serve":
                serve(job, mesh, inputs, out)
            elif job["kind"] == "save":
                save(job, mesh, states)
            elif job["kind"] == "load":
                load(job, mesh, out)
            else:
                ep(job, mesh, inputs, out)
    np.savez(f"{out_path}.rank{rank}.npz", **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:7])
