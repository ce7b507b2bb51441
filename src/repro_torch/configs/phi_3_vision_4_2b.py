"""phi-3-vision-4.2b: phi3-mini backbone + CLIP frontend (stub).

[hf:microsoft/Phi-3-vision-128k-instruct; hf]  32L d_model=3072 32H
(GQA kv=32 => MHA) d_ff=8192 vocab=32064.  The vision frontend is a stub:
``input_specs`` provides precomputed patch embeddings [B, 256, d_model].
"""
from ..models.spec import ModelConfig
from ._smoke import reduce_config

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_head=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10_000.0,
    n_img_tokens=256,
)


def smoke() -> ModelConfig:
    return reduce_config(CONFIG)
