"""qwen2-1.5b: dense GQA with QKV bias.

[arXiv:2407.10671; hf]  28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, QKV bias.
"""
from ..models.spec import ModelConfig
from ._smoke import reduce_config

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_head=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return reduce_config(CONFIG)
