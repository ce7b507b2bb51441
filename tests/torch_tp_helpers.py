"""The ranks that ``test_torch_tp.py`` spawns.  Not a test module (pytest
does not collect it).

    python tests/torch_tp_helpers.py RANK WORLD STORE PLAN.json IN.npz OUT

Each rank builds ``repro_torch.launch.mesh.init_mesh("cpu", shape=...)``
on a gloo ``FileStore`` and runs every config of the plan, writing what it
holds to ``OUT.rank{RANK}.npz``:

- ``train``: the sharded ``make_train_step`` (AdamW) from the whole params
  in the inputs, cut to this rank's shards.  First its
  ``loss_and_grads`` on the first batch (this rank's shards of every
  leaf's gradient), recording what the sublayers compute: the shape of
  every leaf a gather returns, the heads of each ``ops.flash_attention``
  and ``ops.ssd_scan`` call, the rows, groups and kept rows of each
  ``ops.grouped_matmul`` call, and the collectives by axis.  Then a step on each batch: the loss,
  the grad norm, and the shards of the params and optimizer state after
  the last.
- ``serve``: the sharded prefill of the inputs' prompts (its logits,
  collectives by axis, kernel calls and the shape of every leaf its
  gathers return), the caches resharded into the serve step's layout,
  then a decode step for each of the inputs' tokens: the logits of each,
  and ``parallel.tp.greedy_tokens`` of each.  Of the first decode step:
  the shape of every leaf its gathers return, its collectives by axis,
  each attention call's collectives over ``model``, and its bytes under a
  ``launch.roofline.Counter`` (all-gathers over ``model``, and those
  tagged as a cache's).  After the last decode step, each SSM layer's
  state and conv tail (this rank's rows).
- ``norm``: the split gated norm (``parallel.tp.ModelAxis.rmsnorm``) of
  the inputs' rows on this rank's block of their columns, forward and
  backward, on both of its routes: the plain one that CPU tensors take,
  and the kernels' ``autograd.Function`` (whose wrappers give their plain
  versions on the CPU).
- ``long``: long decode (global batch 1, the cache's sequence cut over
  the batch axes) of a config with a window: the unsharded prefill's
  caches cut into the serve step's layout, then a decode step for each of
  the inputs' tokens, its logits and greedy token.

Imports no jax.
"""
import json
import sys

import numpy as np

LR = (1e-2, 2, 10)          # cosine_with_warmup(peak, warmup, steps)
SERVE_SHAPE = ("tp_serve", "decode", 12, 8)   # name, kind, S, B
# long decode: one sequence whose window (16) spans the two data ranks'
# blocks of the 126 + 128 cache slots as decode writes slots 126 to 128
LONG_SHAPE = ("tp_long", "decode", 126, 1)
# config name -> (architecture, overrides of its f32 smoke config)
CONFIGS = {
    "granite": ("granite-moe-1b-a400m", {}),
    "qwen3": ("qwen3-1.7b", {}),
    "qwen2": ("qwen2-1.5b", {}),
    "whisper": ("whisper-medium", {}),
    "jamba": ("jamba-1.5-large-398b", {}),
    # a vocab that no model axis of 2 or 4 divides: the embeddings and the
    # loss stay whole beside tensor-parallel attention and MoE
    "granite-v255": ("granite-moe-1b-a400m", {"vocab_size": 255}),
    # last, so that the configs before it keep their inputs
    "mamba2": ("mamba2-780m", {}),
}
# the configs whose serve job computes its SSM mixers whole (``Sharded``
# without ``ssm_dims``): in jamba's ill-conditioned f32 smoke model the two
# sums a mixer on its ssm_inner shard reorders (its gated norm's row sums,
# its out_proj over model) move the logits by up to 2.25e-5 in one process
# with no sharding, past the serving test's 2e-5, and mamba2's by under
# 4e-6 (``torch_tp_witness.py`` part 3).  So mamba2 holds that route's
# serving at 2e-5, and jamba's training runs it (held at its first step)
WHOLE_SSM_SERVE = ("jamba",)
# the split gated norm's rows: [2, 5, NORM_D], columns over model
NORM_D, NORM_EPS = 96, 1e-6
# long decode only: jamba's attention layers with a window
LONG = {"jamba-w16": ("jamba-1.5-large-398b", {"sliding_window": 16})}


def smoke_cfg(name):
    from repro_torch import configs
    arch, over = {**CONFIGS, **LONG}[name]
    return configs.get_smoke_config(arch).replace(dtype="float32", **over)


def optimizer():
    from repro_torch import optim
    return optim.adamw(optim.cosine_with_warmup(*LR))


def _torch(inputs, prefix):
    import torch
    from repro_torch.weights import unflatten
    return unflatten({k[len(prefix):]: torch.from_numpy(v)
                      for k, v in inputs.items() if k.startswith(prefix)})


def _put(out, prefix, tree):
    from repro_torch.weights import flatten
    for path, t in flatten(tree).items():
        out[f"{prefix}{path}"] = t.detach().numpy()


class Calls:
    """Records the kernels' calls: ``attn`` (q heads, kv heads), ``gmm``
    (rows, groups, rows the groups cover) and ``ssd`` (the heads of each
    ``ops.ssd_scan``)."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.attn, self.gmm, self.ssd = ops, [], [], []
        self._fns = {n: getattr(ops, n) for n in (
            "flash_attention", "grouped_matmul", "ssd_scan")}

    def __enter__(self):
        def fa(q, k, v, **kw):
            self.attn.append((q.shape[2], k.shape[2]))
            return self._fns["flash_attention"](q, k, v, **kw)

        def gmm(lhs, rhs, offsets):
            self.gmm.append((lhs.shape[0], rhs.shape[0], int(offsets[-1])))
            return self._fns["grouped_matmul"](lhs, rhs, offsets)

        def ssd(x, *args, **kw):
            self.ssd.append(x.shape[2])
            return self._fns["ssd_scan"](x, *args, **kw)

        self.ops.flash_attention, self.ops.grouped_matmul = fa, gmm
        self.ops.ssd_scan = ssd
        return self

    def __exit__(self, *exc):
        for n, fn in self._fns.items():
            setattr(self.ops, n, fn)


class AttnCalls:
    """Records the collectives over ``model`` of each decode attention
    call (``layers.attention_decode``, ``layers.cross_attention``), by
    kind, as ``(name, {kind: count})``."""

    def __init__(self, mesh):
        from repro_torch.models import layers
        self.layers, self.mesh, self.calls = layers, mesh, []
        self._fns = {n: getattr(layers, n)
                     for n in ("attention_decode", "cross_attention")}

    def _wrap(self, name, fn):
        def call(*a, **kw):
            before = dict(self.mesh.axis_collectives.get("model", {}))
            out = fn(*a, **kw)
            after = self.mesh.axis_collectives.get("model", {})
            self.calls.append((name, {k: after[k] - before.get(k, 0)
                                      for k in after
                                      if after[k] != before.get(k, 0)}))
            return out
        return call

    def __enter__(self):
        for n, fn in self._fns.items():
            setattr(self.layers, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self._fns.items():
            setattr(self.layers, n, fn)


def _seen(sharded, shapes):
    """Wrap ``sharded.gather`` to record the shape of every leaf it
    returns in ``shapes``; returns the unwrapped one."""
    from repro_torch.weights import flatten
    gather = sharded.gather

    def seen(tree, path):
        got = gather(tree, path)
        for k, t in flatten(got).items():
            shapes[f"{path}/{k}" if path else k] = list(t.shape)
        return got

    sharded.gather = seen
    return gather


def _batch(inputs, name, i, b_specs, mesh):
    from repro_torch.parallel.fsdp import shard_tree
    return shard_tree(_torch(inputs, f"{name}|batch{i}|"), b_specs, mesh)


def train(name, mesh, inputs, out, steps_n):
    from repro_torch.launch import steps
    from repro_torch.parallel.fsdp import shard_tree

    cfg, opt = smoke_cfg(name), optimizer()
    fn, (p_specs, o_specs, b_specs), _, _ = steps.make_train_step(
        cfg, opt, mesh)
    full = _torch(inputs, f"{name}|params|")
    params = steps.as_trainable(shard_tree(full, p_specs, mesh))
    state = shard_tree(opt.init(full), o_specs, mesh)

    shapes, gather = {}, fn.sharded.gather

    def seen(tree, path):
        got = gather(tree, path)
        from repro_torch.weights import flatten
        for k, t in flatten(got).items():
            shapes[f"{path}/{k}" if path else k] = list(t.shape)
        return got

    fn.sharded.gather = seen
    mesh.reset_collectives()
    with Calls() as calls:
        _, grads = fn.loss_and_grads(params,
                                     _batch(inputs, name, 0, b_specs, mesh))
    fn.sharded.gather = gather
    out[f"{name}|train_record"] = np.asarray(json.dumps({
        "shapes": shapes, "attn": calls.attn, "gmm": calls.gmm,
        "ssd": calls.ssd, "collectives": mesh.axis_collectives}))
    _put(out, f"{name}|g|", grads)
    for i in range(steps_n):
        params, state, m = fn(params, state,
                              _batch(inputs, name, i, b_specs, mesh))
        out[f"{name}|loss{i}"] = m["loss"].numpy()
        out[f"{name}|gnorm{i}"] = m["grad_norm"].numpy()
    _put(out, f"{name}|p|", params)
    _put(out, f"{name}|o|", state)


def serve(name, mesh, inputs, out):
    import torch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import roofline, steps
    from repro_torch.parallel.fsdp import reshard, shard_leaf, shard_tree
    from repro_torch.parallel.tp import greedy_tokens

    cfg = smoke_cfg(name)
    shape = ShapeSpec(*SERVE_SHAPE)
    pre, (p_specs, b_specs), (l_spec, c_pre), _ = steps.make_prefill_step(
        cfg, mesh, shape)
    dec, (p_dec, t_spec, c_dec), _, _ = steps.make_serve_step(cfg, mesh,
                                                              shape)
    if name in WHOLE_SSM_SERVE:
        pre.sharded.ssm_dims = dec.sharded.ssm_dims = None
    full = _torch(inputs, f"{name}|params|")
    batch = {"inputs": torch.from_numpy(inputs[f"{name}|prompts"])}
    if f"{name}|enc_embeds" in inputs:
        batch["enc_embeds"] = torch.from_numpy(inputs[f"{name}|enc_embeds"])
    pre_shapes, dec_shapes = {}, {}
    gather = _seen(pre.sharded, pre_shapes)
    mesh.reset_collectives()
    with Calls() as calls:
        logits, caches = pre(shard_tree(full, p_specs, mesh),
                             shard_tree(batch, b_specs, mesh))
    pre.sharded.gather = gather
    record = {"attn": calls.attn, "ssd": calls.ssd, "shapes": pre_shapes,
              "collectives": json.loads(json.dumps(mesh.axis_collectives))}
    out[f"{name}|prefill"] = logits.numpy()
    out[f"{name}|greedy0"] = greedy_tokens(logits, l_spec, mesh).numpy()
    params = shard_tree(full, p_dec, mesh)
    caches = reshard(caches, c_pre, c_dec, mesh)
    for i, tok in enumerate(inputs[f"{name}|tokens"]):
        tok = shard_leaf(torch.from_numpy(tok), t_spec, mesh)
        if i:
            logits, caches = dec(params, tok, caches)
        else:
            gather = _seen(dec.sharded, dec_shapes)
            mesh.reset_collectives()
            with AttnCalls(mesh) as acalls, roofline.Counter() as counter:
                logits, caches = dec(params, tok, caches)
            dec.sharded.gather = gather
            counted = counter.as_dict()
            record["decode"] = {
                "shapes": dec_shapes,
                "collectives": json.loads(json.dumps(mesh.axis_collectives)),
                "attn_calls": acalls.calls,
                "model_all_gather_bytes": counted["axis_collectives"].get(
                    "model", {}).get("all-gather", {}).get("bytes", 0),
                "tagged": counted["tagged"]}
        out[f"{name}|decode{i}"] = logits.numpy()
        out[f"{name}|greedy{i + 1}"] = greedy_tokens(logits, l_spec,
                                                     mesh).numpy()
    for cname, c in (caches.items() if isinstance(caches, dict) else ()):
        if hasattr(c, "state"):
            out[f"{name}|ssm_state|{cname}"] = c.state.numpy()
            out[f"{name}|ssm_conv|{cname}"] = c.conv.numpy()
    out[f"{name}|serve_record"] = np.asarray(json.dumps(record))


def split_norm(mesh, inputs, out):
    """The split gated norm of ``norm|x`` (weights ``norm|w``, output
    gradient ``norm|dy``) on this rank's block of the columns: y, dx, dw
    of the plain route and of the kernels' ``autograd.Function``."""
    import torch
    from repro_torch.parallel.tp import ModelAxis, _SplitRmsNorm

    axis = ModelAxis(mesh)
    lo, hi = axis.local_range(NORM_D)
    x, w, dy = (torch.from_numpy(inputs[f"norm|{k}"])[..., lo:hi]
                for k in ("x", "w", "dy"))
    routes = {
        "plain": lambda a, b: axis.rmsnorm(a, b, NORM_EPS),
        "function": lambda a, b: _SplitRmsNorm.apply(
            axis, a.reshape(-1, hi - lo), b, NORM_D, NORM_EPS).reshape(
                a.shape)}
    for route, fn in routes.items():
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(xr, wr)
        dx, dw = torch.autograd.grad(y, (xr, wr), dy)
        for k, t in (("y", y), ("dx", dx), ("dw", dw)):
            out[f"norm|{route}|{k}"] = t.detach().numpy()


def long_decode(name, mesh, inputs, out):
    """Long decode of ``name``: every rank runs the unsharded prefill of
    the one prompt, cuts its caches into the serve step's layout, then
    decodes the inputs' tokens."""
    import torch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.parallel.fsdp import shard_leaf, shard_tree
    from repro_torch.parallel.tp import greedy_tokens

    cfg = smoke_cfg(name)
    shape = ShapeSpec(*LONG_SHAPE)
    dec, (p_dec, t_spec, c_dec), (l_spec, _), _ = steps.make_serve_step(
        cfg, mesh, shape)
    full = api.cast_for_serving(cfg, _torch(inputs, f"{name}|params|"))
    with torch.no_grad():
        _, caches = api.prefill(cfg, full, {"inputs": torch.from_numpy(
            inputs[f"{name}|prompts"])}, shape.seq_len + steps.sp.DECODE_MARGIN)
    params, caches = shard_tree(full, p_dec, mesh), shard_tree(caches, c_dec,
                                                               mesh)
    mesh.reset_collectives()
    for i, tok in enumerate(inputs[f"{name}|tokens"]):
        tok = shard_leaf(torch.from_numpy(tok), t_spec, mesh)
        logits, caches = dec(params, tok, caches)
        if not i:
            out[f"{name}|long_record"] = np.asarray(json.dumps(
                mesh.axis_collectives))
        out[f"{name}|decode{i}"] = logits.numpy()
        out[f"{name}|greedy{i}"] = greedy_tokens(logits, l_spec,
                                                 mesh).numpy()


def main(rank, world, store_path, plan_path, inputs_path, out_path):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_mesh

    torch.set_num_threads(1)
    plan = json.loads(open(plan_path).read())
    inputs = dict(np.load(inputs_path))
    out = {}
    store = dist.FileStore(store_path, world)
    with init_mesh("cpu", shape=tuple(plan["shape"]), store=store,
                   rank=rank) as mesh:
        out["coords"] = np.asarray([mesh.coords[a] for a in mesh.shape])
        for name in plan["configs"]:
            train(name, mesh, inputs, out, plan["steps"])
            serve(name, mesh, inputs, out)
        if plan.get("norm"):
            split_norm(mesh, inputs, out)
        for name in plan.get("long", ()):
            long_decode(name, mesh, inputs, out)
    np.savez(f"{out_path}.rank{rank}.npz", **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:7])
