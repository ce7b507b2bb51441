"""mamba2-780m: attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified]  48L d_model=1536, d_state=128, expand=2,
head_dim=64, vocab=50280.  No attention, no FFN (the SSD mixer is the
whole block).
"""
from ..models.spec import ModelConfig
from ._smoke import reduce_config

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=("mamba",),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
)


def smoke() -> ModelConfig:
    return reduce_config(CONFIG, n_heads=0, n_kv_heads=0, d_head=0)
