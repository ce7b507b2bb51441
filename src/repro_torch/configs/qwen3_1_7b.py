"""qwen3-1.7b: dense GQA with per-head qk-norm.

[hf:Qwen/Qwen3-1.7B; hf]  28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, qk_norm.
"""
from ..models.spec import ModelConfig
from ._smoke import reduce_config

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return reduce_config(CONFIG)
