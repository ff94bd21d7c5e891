"""OLMoE-1B-7B [arXiv:2409.02060] — fine-grained MoE: 64 experts top-8.

16 layers, d_model 2048, 16 heads (MHA kv=16), d_ff 1024 *per expert*,
vocab 50304.  The 64-expert all-to-all dominates the collective roofline —
a first-class §Perf target.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    num_experts=64,
    num_experts_per_tok=8,
    source="arXiv:2409.02060",
)
