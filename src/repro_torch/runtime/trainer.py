"""End-to-end training driver of the port (counterpart of
``repro.runtime.trainer``), on one device.

The same defaults as the reference: ``with_master(adamw(cosine_with_warmup
(peak_lr, warmup, steps)))``, clipping at global norm 1.0, the optional
gradient compression, the deterministic data stream of
:mod:`..data.pipeline`, and the same history.  The same fault-tolerance
substrate too: with ``checkpoint_dir`` the params, optimizer state and data
step are saved every ``checkpoint_every`` steps (async by default, in the
reference's on-disk layout), and ``run`` resumes from the latest committed
step.  Like the reference, a checkpoint holds no compression state: after a
resume, ``int8``'s error feedback starts again from zero.

With a ``mesh`` (``launch.mesh.Mesh``) the Trainer runs the sharded step
(``launch.steps.make_train_step(cfg, optimizer, mesh)``): each rank holds
its shards of the params and optimizer state, reads its batch rows (the
data stream's shard is its rank over the batch axes), and saves and
resumes through the checkpoint's ``shardings``.  Gradient compression is
not sharded (the reference's trainer has no mesh).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from ..checkpoint import CheckpointManager
from ..data import make_batch_iterator
from ..device import resolve_device
from ..launch.steps import as_trainable, make_train_step
from ..models import api
from ..models.spec import ModelConfig, torch_dtype
from ..optim import Optimizer, adamw, cosine_with_warmup, with_master
from ..parallel.fsdp import pspecs_at, shard_leaf
from ..parallel.sharding import axes_of
from ..weights import flatten, unflatten
from .compression import make_compressor


@dataclass
class TrainerConfig:
    steps: int = 100
    batch_size: int = 8
    seq_len: int = 128
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 25
    async_checkpoint: bool = True
    grad_compression: str = "none"     # none | bf16 | int8
    peak_lr: float = 1e-3
    warmup: int = 10
    seed: int = 0
    log_every: int = 10


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 optimizer: Optional[Optimizer] = None, device=None,
                 mesh=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
        sched = cosine_with_warmup(tcfg.peak_lr, tcfg.warmup, tcfg.steps)
        self.optimizer = optimizer or with_master(adamw(sched))
        self.ckpt = (CheckpointManager(tcfg.checkpoint_dir)
                     if tcfg.checkpoint_dir else None)
        self.comp_init, self.comp_apply = make_compressor(
            tcfg.grad_compression)
        self.train_cfg = cfg.replace(param_dtype=cfg.dtype)
        self.shardings = None
        if mesh is None:
            # one step: (params, opt_state, comp_state, batch) ->
            # (params, opt_state, comp_state, metrics)
            self.step = make_train_step(cfg, self.optimizer, clip_norm=1.0,
                                        grad_transform=self.comp_apply)
            return
        if tcfg.grad_compression != "none":
            raise ValueError("Trainer: gradient compression does not run "
                             "with a mesh")
        step, (p_specs, o_specs, _), _, self.shapes = make_train_step(
            cfg, self.optimizer, mesh, multi_pod="pod" in mesh.shape,
            clip_norm=1.0)
        self.shardings = {"params": p_specs, "opt": o_specs}
        self.batch_axes = axes_of(step.rules["batch"])

        def sharded_step(params, opt_state, comp, batch):
            new_params, new_opt, metrics = step(params, opt_state, batch)
            return new_params, new_opt, comp, metrics

        self.step = sharded_step

    # ------------------------------------------------------------------
    def init_state(self, params=None):
        """Fresh state: random params from ``seed`` (``torch.Generator``;
        not ``jax.random``'s numbers), or ``params`` (a tree, e.g. carried
        from JAX by ``weights.from_jax_params``) cast to the working
        dtype.  With a mesh, this rank's shards of both: each param leaf is
        cut as soon as it is made, and the optimizer state is built from
        the shards, so no rank holds the whole params or state."""
        dt = torch_dtype(self.train_cfg.param_dtype)
        place = None
        if self.mesh is not None:
            def place(path, t):
                return shard_leaf(t, pspecs_at(self.shardings["params"],
                                               path), self.mesh)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.tcfg.seed)
            params = api.init(self.train_cfg, gen, self.device, place)
        else:
            flat = {}
            for path, p in flatten(params).items():
                p = p.to(device=self.device, dtype=dt)
                flat[path] = p if place is None else place(path, p)
            params = unflatten(flat)
        params = as_trainable(params)
        opt = self.optimizer.init(
            params, None if self.mesh is None else self.shapes[0])
        return {"params": params, "opt": opt,
                "comp": self.comp_init(params)}

    def data_shard(self):
        """(this rank's shard of the data stream, the number of shards):
        with a mesh, its rank over the batch axes and their size."""
        if self.mesh is None:
            return 0, 1
        shard, n = 0, 1
        for a in self.batch_axes:
            shard = shard * self.mesh.shape[a] + self.mesh.coords[a]
            n *= self.mesh.shape[a]
        return shard, n

    def batches(self, shard: int = 0, num_shards: int = 1):
        """The deterministic data stream of ``seed`` (``shard`` of
        ``num_shards``)."""
        return make_batch_iterator(self.cfg, self.tcfg.batch_size,
                                   self.tcfg.seq_len, seed=self.tcfg.seed,
                                   shard=shard, num_shards=num_shards)

    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def run(self, *, resume: bool = True, fail_at_step: Optional[int] = None,
            num_shards: int = 1, shard: int = 0, params=None) -> Dict:
        """Train from :meth:`init_state` (``params``), or, with ``resume``
        and a committed step in ``checkpoint_dir``, from that step: its
        params, optimizer state and data step replace the fresh state,
        ``params`` included.  Returns the history (``step``, ``loss``,
        ``sec`` every ``log_every`` steps and at the last), the final loss,
        the state and the data step.  ``fail_at_step`` raises
        ``RuntimeError`` after that step, once its checkpoint is written
        (the failure-injection tests).  With a mesh, ``shard`` and
        ``num_shards`` are the mesh's (:meth:`data_shard`)."""
        tcfg = self.tcfg
        state = self.init_state(params)
        if self.mesh is not None:
            shard, num_shards = self.data_shard()
        it = self.batches(shard, num_shards)
        start = 0
        if resume and self.ckpt is not None:
            like = {"params": state["params"], "opt": state["opt"],
                    "data": it.state_dict()}
            if self.mesh is not None:
                like.update(params=self.shapes[0], opt=self.shapes[1])
            restored_step, restored = self.ckpt.restore_latest(
                like, device=self.device, shardings=self.shardings,
                mesh=self.mesh)
            if restored_step is not None:
                state["params"] = as_trainable(restored["params"])
                state["opt"] = restored["opt"]
                it.load_state_dict(restored["data"])
                start = restored_step
        history: List[Dict] = []
        for step in range(start, tcfg.steps):
            t0 = time.time()
            batch = self.to_device(next(it))
            (state["params"], state["opt"], state["comp"],
             metrics) = self.step(state["params"], state["opt"],
                                  state["comp"], batch)
            if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
                history.append({"step": step,
                                "loss": float(metrics["loss"]),
                                "sec": time.time() - t0})
            if (self.ckpt is not None
                    and (step + 1) % tcfg.checkpoint_every == 0):
                tree = {"params": state["params"], "opt": state["opt"],
                        "data": it.state_dict()}
                if tcfg.async_checkpoint:
                    self.ckpt.async_save(step + 1, tree, self.shardings,
                                         self.mesh)
                else:
                    self.ckpt.save(step + 1, tree, self.shardings, self.mesh)
            if fail_at_step is not None and step + 1 == fail_at_step:
                if self.ckpt is not None:
                    self.ckpt.wait()
                raise RuntimeError(f"injected failure at step {step + 1}")
        if self.ckpt is not None:
            self.ckpt.wait()
        return {"history": history,
                "final_loss": history[-1]["loss"] if history else None,
                "state": state, "data_step": it.step}
