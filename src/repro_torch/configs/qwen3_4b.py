"""Qwen3-4B [hf:Qwen/Qwen3-8B family] — dense GQA with per-head q/k RMSNorm.

36 layers, d_model 2560, 32 heads (GQA kv=8), head_dim 128 (decoupled from
d_model, Qwen3 convention), d_ff 9728, vocab 151936, qk_norm.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
)
