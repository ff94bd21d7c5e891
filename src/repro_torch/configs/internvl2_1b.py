"""InternVL2-1B [arXiv:2404.16821] — InternViT vision frontend (STUB, per the
modality carve-out) + Qwen2-0.5B language backbone.

LM backbone: 24 layers, d_model 896, 14 heads (GQA kv=2), d_ff 4864,
vocab 151655, QKV bias (Qwen2 convention).  The ViT is a stub:
``input_specs`` provides precomputed patch embeddings (256 patches of
width 1024 — InternViT-300M hidden size).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    rope_theta=1e6,
    frontend="vision",
    frontend_dim=1024,
    frontend_tokens=256,
    source="arXiv:2404.16821",
)
