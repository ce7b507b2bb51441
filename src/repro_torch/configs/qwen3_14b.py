"""qwen3-14b: dense GQA with per-head qk-norm.

[hf:Qwen/Qwen3-14B; hf]  40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936, qk_norm.
"""
from ..models.spec import ModelConfig
from ._smoke import reduce_config

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return reduce_config(CONFIG)
