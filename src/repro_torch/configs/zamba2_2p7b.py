"""Zamba2-2.7B [arXiv:2411.15242] — Mamba2 backbone + shared attention blocks.

54 Mamba2 layers (d_model 2560, ssm_state 64, expand 2) with one *shared*
full transformer block (32 heads MHA kv=32, d_ff 10240) applied every 6
layers (9 application sites).  Sub-quadratic: runs long_500k natively.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    source="arXiv:2411.15242",
)
