"""qwen3-moe-235b-a22b: 128-expert top-8 MoE with qk-norm.

[hf:Qwen/Qwen3-30B-A3B family; hf]  94L d_model=4096 64H (GQA kv=4)
expert d_ff=1536 vocab=151936, MoE 128e top-8, per-head qk RMSNorm.
"""
from ..models.spec import ModelConfig
from ._smoke import reduce_config

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_head=128,
    d_ff=0,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128,
    top_k=8,
    d_ff_expert=1536,
)


def smoke() -> ModelConfig:
    return reduce_config(CONFIG, n_kv_heads=2)
