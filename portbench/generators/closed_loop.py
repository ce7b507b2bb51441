"""The closed-loop generator: one client that issues each call when the
previous call's first tokens are on the host.

A mix (``traffic/<mix>.json`` with ``"generator": "closed_loop"``) gives:

- ``batch``: prompts a call;
- ``prompt_len``: tokens a prompt;
- ``decode_budget``: cache slots reserved past the prompt for the decode
  that follows elsewhere (a prefill pool's cache is sized for it).

Call ``i`` of a run draws its ids from a generator on the device seeded
by ``(seed, i)``, so the reference can draw them again; every seed's
calls have the same sizes.

A generator module gives a ``Traffic(mix, seed, vocab, device)`` with
``batch``, ``prompt_len(i)``, ``ids(i)``, ``warmup_calls(n)``,
``arrivals(i)`` (None: each request arrives when its call is issued;
else one time a request, in seconds after the window opens, before
which the call is not issued) and ``serve(program, i)``, the timed call:
``(logits [batch, V] of the last position, tokens on the host, caches)``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench.weights import seed_for


class Traffic:
    def __init__(self, mix: Dict, seed: int, vocab: int, device):
        self.batch = int(mix["batch"])
        self.length = int(mix["prompt_len"])
        self.budget = int(mix.get("decode_budget", 0))
        self.seed, self.vocab, self.device = seed, vocab, device

    def prompt_len(self, i: int) -> int:
        return self.length

    def ids(self, i: int) -> torch.Tensor:
        """Call ``i``'s prompts [batch, prompt_len] (i < 0: warm-up)."""
        gen = torch.Generator(device=self.device).manual_seed(
            seed_for(self.seed, i + 1))
        return torch.randint(0, self.vocab, (self.batch, self.length),
                             generator=gen, device=self.device)

    def warmup_calls(self, n: int) -> List[int]:
        return [-(1 + j) for j in range(n)]

    def arrivals(self, i: int) -> Optional[List[float]]:
        return None

    def serve(self, program, i: int):
        logits, caches = program.prefill(self.ids(i),
                                         self.length + self.budget)
        return logits, program.first_tokens(logits), caches
