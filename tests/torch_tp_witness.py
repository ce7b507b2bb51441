"""How far rounding alone moves the smoke models' training, in one process,
with no sharding: the witness behind the bounds of ``test_torch_tp.py``
and the whole-vocab mamba2 of ``test_torch_fsdp.py``.  Not a test module
(pytest does not collect it).

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_tp_witness.py

1. **One sum reordered.**  For each config of those two tests, the port's
   unsharded step runs three AdamW steps on the tests' inputs twice: as it
   is, and with the unembed's input gradient summed over ``m`` vocab
   blocks (``m`` = 2, 4), the order in which a vocab-parallel unembed sums
   it over ``model``.  Nothing else changes: the forward pass and every
   other gradient keep their bits.  Printed: the first gradient's largest
   change (of each leaf's max), and after three steps the largest move
   change (of the learning rates' sum) and state change (of each leaf's
   max), each beside the bound of the tests (2% and 1e-4).
2. **One ulp of input.**  jamba's first gradients, in the port and in the
   reference (``repro.models.api.loss_fn``), with every element of the
   embedding table moved up one ulp: the largest change of each side (of
   each leaf's max), beside the port's distance from the reference.
3. **The SSM mixers' sums reordered in serving.**  jamba's and mamba2's
   unsharded prefill and decode steps on ``test_torch_tp.py``'s prompts
   and tokens, as they are and with each SSM mixer's gated norm summing
   its rows' squares over ``m`` column blocks and its ``out_proj`` summing
   over ``m`` row blocks, the two sums a mixer on its ``ssm_inner`` shard
   takes over ``model``: each step's largest logit change beside the
   serving test's 2e-5 (``torch_tp_helpers.WHOLE_SSM_SERVE``).
"""
import sys

import numpy as np
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_fsdp as FT  # noqa: E402
import test_torch_tp as TT  # noqa: E402
from repro.models import api as japi  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssd  # noqa: E402
from repro_torch.weights import flatten, from_jax_params  # noqa: E402

MOVE_BOUND, STATE_BOUND = 2e-2, 1e-4


class _BlockedDx(torch.autograd.Function):
    """``x @ w``, whose backward sums ``x``'s gradient over ``blocks``
    vocab blocks in order."""

    @staticmethod
    def forward(ctx, x, w, blocks):
        ctx.save_for_backward(x, w)
        ctx.blocks = blocks
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        V, n = w.shape[-1], ctx.blocks
        dx = sum(g[..., i * V // n:(i + 1) * V // n]
                 @ w[:, i * V // n:(i + 1) * V // n].T for i in range(n))
        dw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, V)
        return dx, dw, None


def _blocked_unembed(blocks):
    def unembed(params, cfg, x, tp=None):
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return _BlockedDx.apply(x, params["unembed"].to(x.dtype), blocks)
    return unembed


def _three_steps(cfg, opt, params, batches, blocks):
    plain = L.unembed
    if blocks > 1:
        L.unembed = _blocked_unembed(blocks)
    try:
        step = steps.make_train_step(cfg, opt)
        params = steps.as_trainable(params)
        _, g0 = steps.loss_and_grads(cfg, params, batches[0])
        state = opt.init(params)
        for b in batches:
            params, state, _ = step(params, state, b)
    finally:
        L.unembed = plain
    return ({k: v.numpy() for k, v in flatten(g0).items()},
            {k: v.detach().numpy() for k, v in flatten(params).items()},
            {k: v.numpy() for k, v in flatten(state).items() if k != "count"})


def _worst(got, want, scale_of):
    return max(float(np.abs(got[k] - want[k]).max()) / scale_of(want[k])
               for k in want)


def _leaf_max(w):
    return max(float(np.abs(w).max()), 1e-30)


def reorder_witness():
    tp_inputs, _ = TT._inputs()
    fsdp_inputs, _, _ = FT._inputs()
    cases = [(f"tp:{n}", TT._cfgs(n)[1], TT.TH.optimizer(),
              TT._params(tp_inputs, n),
              [TT._batch(tp_inputs, n, s) for s in range(TT.STEPS)])
             for n in TT.NAMES]
    cases.append((f"fsdp:{FT.MAMBA}", FT._cfgs(FT.MAMBA)[1],
                  FT.FH.optimizer("adamw"), from_jax_params(
                      {k.split("|", 2)[2]: v for k, v in fsdp_inputs.items()
                       if k.startswith(f"{FT.MAMBA}|params|")}),
                  [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in FT._batches(fsdp_inputs, {"arch": FT.MAMBA})]))
    lr_sum = TT._lr_sum()
    for name, cfg, opt, params, batches in cases:
        base = _three_steps(cfg, opt, params, batches, 1)
        for m in (2, 4):
            g0, p, s = _three_steps(cfg, opt, params, batches, m)
            grad = _worst(g0, base[0], _leaf_max)
            move = _worst(p, base[1], lambda w: lr_sum)
            state = _worst(s, base[2], _leaf_max)
            print(f"reorder {name:18s} m {m}: first gradient {grad:.2e}; "
                  f"after three steps move {move:.2e} "
                  f"({move / MOVE_BOUND:.2f} of 2%), state {state:.2e} "
                  f"({state / STATE_BOUND:.2f} of 1e-4)", flush=True)


def ulp_witness(name="jamba"):
    inputs, jparams = TT._inputs()
    jcfg, cfg = TT._cfgs(name)
    batch = TT._batch(inputs, name, 0)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    vg = jax.jit(jax.grad(lambda p, b: japi.loss_fn(jcfg, p, b)[0]))

    def nudged(jp):
        table = np.asarray(jp["tok_embed"])
        return {**jp, "tok_embed": jnp.asarray(
            np.nextafter(table, np.float32(np.inf)))}

    def port(jp):
        params = steps.as_trainable(from_jax_params(
            jax.tree.map(np.asarray, jp)))
        _, g = steps.loss_and_grads(cfg, params, batch)
        return {k: v.numpy() for k, v in flatten(g).items()}

    def ref(jp):
        return flatten(jax.tree.map(np.asarray, vg(jp, jbatch)))

    jp = jparams[name]
    p0, p1, r0, r1 = port(jp), port(nudged(jp)), ref(jp), ref(nudged(jp))
    print(f"ulp {name}: first gradient moved by one ulp of the embeddings: "
          f"port {_worst(p1, p0, _leaf_max):.2e}, reference "
          f"{_worst(r1, r0, _leaf_max):.2e}; port from reference "
          f"{_worst(p0, r0, _leaf_max):.2e}", flush=True)


def _blocked_gated_norm(blocks):
    """``ssd._gated_norm`` whose row sums of squares and ``out_proj`` sum
    run over ``blocks`` column (row) blocks, in order."""
    def gated_norm(p, cfg, y, z, tp=None):
        g = (y * F.silu(z)).reshape(-1, y.shape[-1])
        K = g.shape[-1]
        cut = [slice(i * K // blocks, (i + 1) * K // blocks)
               for i in range(blocks)]
        xf = g.float()
        ss = sum(kref.rmsnorm_part_ref(xf[:, c]) for c in cut)
        n = kref.rmsnorm_scale_ref(xf, p["norm"], ss, K, cfg.norm_eps).to(
            y.dtype).reshape(y.shape)
        w = p["out_proj"].to(n.dtype)
        return sum(n[..., c] @ w[c] for c in cut)
    return gated_norm


def serve_witness():
    inputs, _ = TT._inputs()
    for name in TT.SSM:
        _, cfg = TT._cfgs(name)
        params = api.cast_for_serving(cfg, TT._params(inputs, name))
        prompts = torch.from_numpy(inputs[f"{name}|prompts"])
        base, toks = TT._serve_unsharded(name, inputs)
        s_max = prompts.shape[1] + steps.sp.DECODE_MARGIN
        for m in (2, 4):
            plain, ssd._gated_norm = ssd._gated_norm, _blocked_gated_norm(m)
            try:
                with torch.no_grad():
                    logits, caches = api.prefill(cfg, params,
                                                 {"inputs": prompts}, s_max)
                    got = [logits.numpy()]
                    for tok in toks:
                        logits, caches = api.decode_step(
                            cfg, params, torch.from_numpy(tok), caches)
                        got.append(logits.numpy())
            finally:
                ssd._gated_norm = plain
            errs = [float(np.abs(g - w).max()) for g, w in zip(got, base)]
            print(f"serve {name:8s} m {m}: largest logit change, prefill "
                  f"then each decode step: " + ", ".join(
                      f"{e:.2e}" for e in errs) + " (bound 2e-5)", flush=True)


if __name__ == "__main__":
    which = sys.argv[1:] or ["reorder", "ulp", "serve"]
    if "reorder" in which:
        reorder_witness()
    if "ulp" in which:
        ulp_witness()
    if "serve" in which:
        serve_witness()
