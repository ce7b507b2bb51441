"""Serving launcher: prefill + batched greedy decode on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-1b-a400m --batch 8 --prompt-len 512 --tokens 32

runs the full-width model with seeded random weights on the card;
``--smoke --device cpu`` runs the reduced config on the CPU (the plain
versions of the kernels).  whisper-medium gets seeded frame embeddings
``enc_embeds`` [B, enc_frames, d_model] and phi-3-vision-4.2b seeded image
embeddings ``img_embeds`` [B, n_img_tokens, d_model], as the frontends the
JAX package stubs would give them.  Counterpart of ``repro.launch.serve``.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict

import torch

from .. import configs
from ..device import resolve_device
from ..models.api import CausalLM


@dataclass
class ServeResult:
    tokens: torch.Tensor          # [B, n] generated ids (on the host)
    prefill_s: float              # wall seconds of the prefill call
    decode_s: float               # wall seconds of the n-1 decode steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_prompts(cfg, batch: int, prompt_len: int, seed: int,
                 device) -> torch.Tensor:
    """Seeded prompt ids, drawn on the host so every device sees the same."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen).to(device)


def make_embeds(cfg, batch: int, seed: int,
                device) -> Dict[str, torch.Tensor]:
    """The stub frontends' outputs the model needs besides its prompts,
    standard normal from a seeded generator, drawn on the host:
    ``img_embeds`` for a VLM, ``enc_embeds`` for an encoder-decoder."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    if cfg.n_img_tokens > 0:
        out["img_embeds"] = torch.randn(batch, cfg.n_img_tokens, cfg.d_model,
                                        generator=gen)
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = torch.randn(batch, cfg.enc_frames, cfg.d_model,
                                        generator=gen)
    return {name: t.to(device) for name, t in out.items()}


def generate(model: CausalLM, prompts: torch.Tensor, n_tokens: int,
             **embeds: torch.Tensor) -> ServeResult:
    """Prefill ``prompts`` [B, S] (with ``embeds``: ``img_embeds`` or
    ``enc_embeds``), then greedy-decode to ``n_tokens`` ids.

    The cache holds the image tokens too: ``s_max`` is n_img_tokens +
    prompt + n_tokens + 8.  (``repro.launch.serve`` leaves the image tokens
    out, which only its smoke configs' 8 image tokens fit.)"""
    dev = model.device
    s_max = model.cfg.n_img_tokens + prompts.shape[1] + n_tokens + 8
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = model.prefill(prompts, s_max, **embeds)
    tok = torch.argmax(logits, dim=-1)
    _sync(dev)
    t1 = time.perf_counter()
    toks = [tok]
    for _ in range(n_tokens - 1):
        logits, caches = model.decode_step(tok, caches)
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
    out = torch.stack(toks, dim=1).cpu()
    t2 = time.perf_counter()
    return ServeResult(tokens=out, prefill_s=t1 - t0, decode_s=t2 - t1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-moe-1b-a400m",
                    choices=configs.list_archs())
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU tests)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.tokens < 1:
        ap.error("--tokens must be at least 1")

    dev = resolve_device(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    model = CausalLM.random(cfg, seed=args.seed, device=dev)
    prompts = make_prompts(cfg, args.batch, args.prompt_len, args.seed + 1,
                           dev)
    embeds = make_embeds(cfg, args.batch, args.seed + 2, dev)
    res = generate(model, prompts, args.tokens, **embeds)
    rate = args.batch * (args.tokens - 1) / max(res.decode_s, 1e-9)
    extra = "".join(f", {name} {list(t.shape)}"
                    for name, t in embeds.items())
    print(f"{cfg.name} on {dev}: prefill [{args.batch}x{args.prompt_len}"
          f"{extra}] {res.prefill_s * 1e3:.3f} ms; decoded {args.tokens} "
          f"tok x{args.batch} ({rate:.1f} tok/s)")
    print("sequence 0:", res.tokens[0].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
