"""Deterministic, checkpointable data pipeline: the port's own copy of
``repro.data.pipeline`` (the port imports nothing of ``repro``).

It is numpy only, and gives the same batches as the reference, bit for
bit (``tests/test_torch_train.py`` holds them equal).  A token sequence is
a function of (seed, global example index): a splitmix-style hash with a
Zipf-ish marginal over the vocab and a copy motif every ``copy_period``
positions; the iterator's state is one integer, its step.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclass(frozen=True)
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    seed: int = 0
    copy_period: int = 8   # learnable motif: token repeats every k positions

    def example(self, index: int) -> np.ndarray:
        """Token sequence (seq_len + 1,) for a global example index."""
        base = np.uint64(self.seed) * np.uint64(0x100000001B3) + np.uint64(index)
        pos = np.arange(self.seq_len + 1, dtype=np.uint64)
        h = _splitmix64(base + pos // np.uint64(self.copy_period))
        # Zipf-ish marginal: square the uniform to bias small ids.
        u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        toks = (u * u * (self.vocab_size - 1)).astype(np.int64)
        return toks

    def batch(self, step: int, batch_size: int,
              shard: int = 0, num_shards: int = 1) -> Dict[str, np.ndarray]:
        """Global batch for ``step``, restricted to ``shard`` of the hosts."""
        per_shard = batch_size // num_shards
        start = step * batch_size + shard * per_shard
        toks = np.stack([self.example(start + i) for i in range(per_shard)])
        return {"inputs": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}


@dataclass
class DataIterator:
    """Stateful, checkpointable iterator over a SyntheticLMDataset."""

    dataset: SyntheticLMDataset
    batch_size: int
    shard: int = 0
    num_shards: int = 1
    step: int = 0
    transform: Optional[object] = None   # callable(batch, step) -> batch

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.dataset.batch(self.step, self.batch_size, self.shard,
                               self.num_shards)
        if self.transform is not None:
            b = self.transform(b, self.step)
        self.step += 1
        return b

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    # -- checkpointing ------------------------------------------------------
    def state_dict(self) -> Dict:
        return {"step": self.step, "seed": self.dataset.seed,
                "batch_size": self.batch_size}

    def load_state_dict(self, state: Dict) -> None:
        assert state["seed"] == self.dataset.seed, "dataset seed mismatch"
        self.step = int(state["step"])

    def reshard(self, shard: int, num_shards: int) -> "DataIterator":
        """Elastic re-sharding: same stream, new topology, same step."""
        assert self.batch_size % num_shards == 0
        return dataclasses.replace(self, shard=shard, num_shards=num_shards)


def make_batch_iterator(cfg, batch_size: int, seq_len: int, seed: int = 0,
                        shard: int = 0, num_shards: int = 1,
                        extra_fields: Optional[Dict] = None) -> DataIterator:
    """Iterator producing model-ready batches (adds stub modality inputs)."""
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=seq_len,
                            seed=seed)
    transform = None
    if cfg.n_img_tokens > 0 or cfg.is_encoder_decoder:
        def transform(b, step):
            n = b["inputs"].shape[0]
            rng = np.random.default_rng(step)
            if cfg.n_img_tokens > 0:
                b["img_embeds"] = rng.standard_normal(
                    (n, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
            if cfg.is_encoder_decoder:
                b["enc_embeds"] = rng.standard_normal(
                    (n, cfg.enc_frames, cfg.d_model)).astype(np.float32)
            return b

    return DataIterator(ds, batch_size, shard, num_shards,
                        transform=transform)
