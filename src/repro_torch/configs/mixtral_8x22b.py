"""Mixtral 8x22B [arXiv:2401.04088] — 56L MoE, 8 experts top-2, GQA kv=8, SWA.

Numbers from the assignment (Mixtral family model card): 56 layers,
d_model 6144, 48 heads (GQA kv=8), d_ff 16384 per expert, vocab 32768,
8 experts top-2, sliding-window attention (window 4096 per Mistral/Mixtral
convention).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    num_experts_per_tok=2,
    sliding_window=4096,
    rope_theta=1e6,
    source="arXiv:2401.04088",
)
