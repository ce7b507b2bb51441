"""whisper-medium: encoder-decoder; conv/mel frontend stubbed.

[arXiv:2212.04356; unverified]  24 encoder + 24 decoder layers,
d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.  ``input_specs`` provides
precomputed frame embeddings [B, 1500, d_model].
"""
from ..models.spec import ModelConfig
from ._smoke import reduce_config

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,                 # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab_size=51865,
    rope_theta=10_000.0,
    is_encoder_decoder=True,
    n_enc_layers=24,
    enc_frames=1500,
)


def smoke() -> ModelConfig:
    return reduce_config(CONFIG)
