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
"""
from __future__ import annotations

import argparse

from .. import configs
from ..runtime import Trainer, TrainerConfig


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
    args = ap.parse_args(argv)

    cfg = (configs.get_config(args.arch) if args.full
           else configs.get_smoke_config(args.arch))
    tcfg = TrainerConfig(steps=args.steps, batch_size=args.batch,
                         seq_len=args.seq, checkpoint_dir=args.ckpt,
                         grad_compression=args.compress, peak_lr=args.lr,
                         log_every=max(1, args.steps // 20))
    out = Trainer(cfg, tcfg, device=args.device).run(resume=args.resume)
    for h in out["history"]:
        print(f"step {h['step']:>5}  loss {h['loss']:.4f}  {h['sec']:.2f}s")
    print(f"final loss: {out['final_loss']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
