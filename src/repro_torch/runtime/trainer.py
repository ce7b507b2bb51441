"""End-to-end training driver of the port (counterpart of
``repro.runtime.trainer``), on one device.

The same defaults as the reference: ``with_master(adamw(cosine_with_warmup
(peak_lr, warmup, steps)))``, clipping at global norm 1.0, the optional
gradient compression, the deterministic data stream of
:mod:`..data.pipeline`, and the same history.  Checkpointing (the
reference's async save and auto-resume) is the next slice (ROADMAP queue 1,
item 2): until then ``checkpoint_dir`` raises rather than train without
saving.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from ..data import make_batch_iterator
from ..device import resolve_device
from ..launch.steps import as_trainable, make_train_step
from ..models import api
from ..models.spec import ModelConfig, torch_dtype
from ..optim import Optimizer, adamw, cosine_with_warmup, with_master
from ..weights import tree_map
from .compression import make_compressor


@dataclass
class TrainerConfig:
    steps: int = 100
    batch_size: int = 8
    seq_len: int = 128
    checkpoint_dir: Optional[str] = None
    grad_compression: str = "none"     # none | bf16 | int8
    peak_lr: float = 1e-3
    warmup: int = 10
    seed: int = 0
    log_every: int = 10


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 optimizer: Optional[Optimizer] = None, device=None):
        if tcfg.checkpoint_dir:
            raise NotImplementedError(
                "repro_torch Trainer: checkpointing (checkpoint_dir) is not "
                "ported yet (ROADMAP queue 1, item 2); it does not train "
                "without saving")
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        sched = cosine_with_warmup(tcfg.peak_lr, tcfg.warmup, tcfg.steps)
        self.optimizer = optimizer or with_master(adamw(sched))
        self.comp_init, self.comp_apply = make_compressor(
            tcfg.grad_compression)
        self.train_cfg = cfg.replace(param_dtype=cfg.dtype)
        # one step: (params, opt_state, comp_state, batch) ->
        # (params, opt_state, comp_state, metrics)
        self.step = make_train_step(cfg, self.optimizer, clip_norm=1.0,
                                    grad_transform=self.comp_apply)

    # ------------------------------------------------------------------
    def init_state(self, params=None):
        """Fresh state: random params from ``seed`` (``torch.Generator``;
        not ``jax.random``'s numbers), or ``params`` (a tree, e.g. carried
        from JAX by ``weights.from_jax_params``) cast to the working
        dtype."""
        dt = torch_dtype(self.train_cfg.param_dtype)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.tcfg.seed)
            params = api.init(self.train_cfg, gen, self.device)
        else:
            params = tree_map(lambda p: p.to(device=self.device, dtype=dt),
                              params)
        params = as_trainable(params)
        return {"params": params, "opt": self.optimizer.init(params),
                "comp": self.comp_init(params)}

    def batches(self):
        """The deterministic data stream of ``seed`` (one shard)."""
        return make_batch_iterator(self.cfg, self.tcfg.batch_size,
                                   self.tcfg.seq_len, seed=self.tcfg.seed)

    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def run(self, *, params=None) -> Dict:
        """Train from :meth:`init_state` (``params``); returns the history
        (``step``, ``loss``, ``sec`` every ``log_every`` steps and at the
        last), the final loss, the state and the data step."""
        tcfg = self.tcfg
        state = self.init_state(params)
        it = self.batches()
        history: List[Dict] = []
        for step in range(tcfg.steps):
            t0 = time.time()
            batch = self.to_device(next(it))
            (state["params"], state["opt"], state["comp"],
             metrics) = self.step(state["params"], state["opt"],
                                  state["comp"], batch)
            if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
                history.append({"step": step,
                                "loss": float(metrics["loss"]),
                                "sec": time.time() - t0})
        return {"history": history,
                "final_loss": history[-1]["loss"] if history else None,
                "state": state, "data_step": it.step}
