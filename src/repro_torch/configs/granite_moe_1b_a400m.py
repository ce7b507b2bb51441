"""granite-moe-1b-a400m: 32-expert top-8 MoE.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]  24L d_model=1024 16H
(GQA kv=8) expert d_ff=512 vocab=49155, MoE 32e top-8 on every layer.
"""
from ..models.spec import ModelConfig
from ._smoke import reduce_config

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=64,
    d_ff=0,                      # every FFN is MoE
    vocab_size=49155,
    rope_theta=10_000.0,
    n_experts=32,
    top_k=8,
    d_ff_expert=512,
)


def smoke() -> ModelConfig:
    return reduce_config(CONFIG)
