"""Serving example of the PyTorch port: prefill + batched greedy decode
with KV/SSM caches on one GPU (``examples/serve_decode.py`` on
``repro_torch``).

Runs a reduced config of any architecture (--arch) with seeded random
weights: the smoke config with 64-wide heads, a head dim the attention
kernel is built for.  It prefills a prompt batch, then decodes tokens
autoregressively.  It runs on the card; ``--device cpu`` runs the plain
versions of the kernels instead.

    PYTHONPATH=src python examples/serve_decode_torch.py --arch qwen2-1.5b --tokens 32
"""
import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.serve import (generate, make_embeds,  # noqa: E402
                                      make_prompts)
from repro_torch.models.api import CausalLM  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b",
                    choices=configs.list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get_smoke_config(args.arch).replace(d_head=64)
    model = CausalLM.random(cfg, seed=0, device=dev)
    prompts = make_prompts(cfg, args.batch, args.prompt_len, 1, dev)
    res = generate(model, prompts, args.tokens,
                   **make_embeds(cfg, args.batch, 2, dev))
    print(f"prefill[{args.batch}x{args.prompt_len}] in {res.prefill_s:.2f}s")
    rate = args.batch * (args.tokens - 1) / max(res.decode_s, 1e-9)
    print(f"decoded {args.tokens} tokens/seq in {res.decode_s:.2f}s "
          f"({rate:.1f} tok/s on {dev})")
    print("first sequence token ids:", res.tokens[0][:16].tolist(), "...")
    if not (0 <= int(res.tokens.min()) and
            int(res.tokens.max()) < cfg.vocab_size):
        raise AssertionError("a decoded id is outside the vocab")


if __name__ == "__main__":
    main()
