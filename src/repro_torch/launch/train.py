"""Training launcher of the port (counterpart of ``repro.launch.train``).

Local runs use the reduced smoke config unless ``--full``.  On the card
(the default device):

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch granite-moe-1b-a400m --full --steps 6 --batch 8 --seq 512

``--device cpu`` runs the plain versions of the kernels (the tests).
``--ckpt DIR`` saves every 25 steps (async) into DIR, and ``--resume``
goes on from its latest committed step, which may have been written by
``repro.launch.train`` as well:

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch granite-moe-1b-a400m --full --steps 50 --ckpt DIR --resume

``--mesh DATA,MODEL`` (or ``POD,DATA,MODEL``) runs the sharded step
(``launch.steps.make_train_step`` with a ``launch.mesh`` mesh): at ``1,1``
in one process, or under ``torchrun`` with as many ranks as the mesh has
(one GPU a rank on the card, gloo with ``--device cpu``); rank 0 prints:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --mesh 2,2 --device cpu --steps 2 --batch 4 --seq 16
"""
from __future__ import annotations

import argparse
import os

from .. import configs
from ..runtime import Trainer, TrainerConfig
from .mesh import init_mesh, init_mesh_from_env


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b",
                    choices=configs.list_archs())
    ap.add_argument("--full", action="store_true",
                    help="use the full-size config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--mesh", default=None,
                    help="DATA,MODEL or POD,DATA,MODEL: the sharded step")
    args = ap.parse_args(argv)

    cfg = (configs.get_config(args.arch) if args.full
           else configs.get_smoke_config(args.arch))
    tcfg = TrainerConfig(steps=args.steps, batch_size=args.batch,
                         seq_len=args.seq, checkpoint_dir=args.ckpt,
                         grad_compression=args.compress, peak_lr=args.lr,
                         log_every=max(1, args.steps // 20))
    if args.mesh is None:
        out = Trainer(cfg, tcfg, device=args.device).run(resume=args.resume)
        _report(out)
        return 0
    shape = tuple(int(n) for n in args.mesh.split(","))
    if len(shape) not in (2, 3):
        ap.error("--mesh takes DATA,MODEL or POD,DATA,MODEL")
    init = (init_mesh_from_env if "WORLD_SIZE" in os.environ else init_mesh)
    with init(args.device, shape=shape, multi_pod=len(shape) == 3) as mesh:
        out = Trainer(cfg, tcfg, mesh=mesh).run(resume=args.resume)
        if mesh.rank == 0:
            print(f"mesh {mesh.shape}, {mesh.backend}")
            _report(out)
    return 0


def _report(out) -> None:
    for h in out["history"]:
        print(f"step {h['step']:>5}  loss {h['loss']:.4f}  {h['sec']:.2f}s")
    print(f"final loss: {out['final_loss']}")


if __name__ == "__main__":
    raise SystemExit(main())
