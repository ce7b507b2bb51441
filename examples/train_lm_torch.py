"""End-to-end training example of the PyTorch port: a ~100M-parameter LM
for a few hundred steps on one GPU (``examples/train_lm.py`` on
``repro_torch``).

Exercises the port's substrate: the deterministic data pipeline,
mixed-precision AdamW (bf16 params + f32 master) through the CUDA kernels
and their backward kernels, async checkpointing with auto-resume, and
optional gradient compression.  It runs on the card; ``--device cpu`` runs
the plain versions of the kernels instead.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--resume]
"""
import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.models.spec import ModelConfig  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402


def model_100m() -> ModelConfig:
    # ~100M params: 12L x d512 x ffn2048, 32k vocab
    return ModelConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=512,
        n_heads=8, n_kv_heads=4, d_head=64, d_ff=2048, vocab_size=32768,
        rope_theta=10_000.0, remat=False, scan_layers=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=str(ROOT / "build" / "train_lm_torch"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    cfg = model_100m()
    tcfg = TrainerConfig(steps=args.steps, batch_size=args.batch,
                         seq_len=args.seq, checkpoint_dir=args.ckpt,
                         checkpoint_every=100, grad_compression=args.compress,
                         peak_lr=3e-4, warmup=20, log_every=20)
    t0 = time.time()
    out = Trainer(cfg, tcfg, device=args.device).run(resume=args.resume)
    for h in out["history"]:
        print(f"step {h['step']:>4}  loss {h['loss']:.4f}  {h['sec']:.2f}s/step")
    print(f"\nfinal loss {out['final_loss']:.4f} "
          f"({time.time()-t0:.0f}s total); checkpoints in {args.ckpt}")
    first = out["history"][0]["loss"] if out["history"] else None
    if first and out["final_loss"] < first * 0.7:
        print("loss decreased >30% — learning works")


if __name__ == "__main__":
    main()
