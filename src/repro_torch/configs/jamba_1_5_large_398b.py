"""jamba-1.5-large-398b: hybrid Mamba+attention (1:7) with 16e top-2 MoE.

[arXiv:2403.19887; hf]  72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2 on alternating layers; attention every 8th
layer.  SSM layers use the unified SSD formulation (d_state=16 per the
Jamba paper).  At 398B it does not fit one card: the port runs it only at
smoke size, where it holds the hybrid layer pattern.  The long_500k
variant's 4096 sliding window runs through the windowed flash_attention.
"""
from ..models.spec import ModelConfig
from ._smoke import reduce_config

PATTERN = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba",
           "mamba")

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab_size=65536,
    rope_theta=1_000_000.0,
    n_experts=16,
    top_k=2,
    d_ff_expert=24576,
    moe_every=2,
    layer_pattern=PATTERN,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=128,
    sliding_window=0,            # long_500k variant sets 4096
    ffn_chunks=8,
    ssm_scan_groups=8,
)


def smoke() -> ModelConfig:
    return reduce_config(CONFIG, n_layers=len(PATTERN))
