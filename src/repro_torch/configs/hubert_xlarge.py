"""HuBERT X-Large [arXiv:2106.07447] — encoder-only audio transformer
(w2v2 architecture).  Conv feature extractor is a STUB per the modality
carve-out: ``input_specs`` provides 512-wide frame embeddings.

48 layers, d_model 1280, 16 heads (MHA), d_ff 5120, vocab 504 (k-means
units for masked prediction).  Encoder-only ⇒ no decode shapes
(DESIGN.md §4).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    mlp_gated=False,
    encoder_only=True,
    frontend="audio",
    frontend_dim=512,
    long_context_window=None,
    source="arXiv:2106.07447",
)
