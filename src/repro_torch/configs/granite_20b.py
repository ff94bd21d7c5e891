"""Granite-20B-Code [arXiv:2405.04324] — llama-arch dense with MQA (kv=1).

52 layers, d_model 6144, 48 heads (MQA kv=1), d_ff 24576, vocab 49152.
The kv=1 head is the interesting sharding case: KV replicated across the
model axis (see DESIGN.md §5).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp_gated=False,
    source="arXiv:2405.04324",
)
