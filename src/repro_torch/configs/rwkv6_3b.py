"""RWKV6-3B "Finch" [arXiv:2404.05892] — attention-free, data-dependent decay.

32 layers, d_model 2560 (40 heads of width 64), channel-mix d_ff 8960,
vocab 65536.  O(1)-state decode ⇒ long_500k runs natively.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    ssm_chunk=64,
    source="arXiv:2404.05892",
)
