"""Model configuration schema.

One ``ModelConfig`` instance fully determines a model: family, dimensions,
attention flavor (GQA / SWA / qk-norm / bias), MoE routing, SSM state, and
the modality frontend stub.  A field-for-field copy of the reference
``ModelConfig`` so the two packages' configs compare equal as dicts; the
ported archs in ``src/repro_torch/configs/<id>.py`` instantiate it with the
reference's numbers.

Fields that only the reference's JAX execution reads (``attn_impl``,
``scan_unroll``, ``causal_chunk_skip``, ``attn_chunk_*``) are kept for
that parity and read by nothing here: the port's attention always goes
through ``repro_torch.kernels`` (the hand-written kernel on a CUDA tensor,
its plain version on a CPU tensor).  ``remat`` and ``loss_chunk`` are read
by ``Model.loss`` (per-layer checkpointing under grad, the cross-entropy's
sequence chunks).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig", "reduced_for_smoke"]

FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # attention flavor
    qk_norm: bool = False            # Qwen3: RMSNorm on per-head q/k
    qkv_bias: bool = False           # Qwen2: bias on qkv projections
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None   # architecture's own SWA (Mixtral)
    # for full-attention archs, the window used *only* for the long_500k
    # shape (sub-quadratic variant; see DESIGN.md §Arch-applicability)
    long_context_window: Optional[int] = 8192

    mlp_gated: bool = True           # SwiGLU (True) vs plain GELU MLP (False)
    # embedding/lm-head tables are padded to this multiple so the vocab dim
    # shards over the model axis (replicated lm-heads redundantly compute
    # the full logits on every TP rank — the roofline catches this)
    vocab_pad_to: int = 128

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_group_size: int = 512        # tokens per dispatch group (§Perf knob)
    capacity_factor: float = 1.25

    # SSM (Mamba2 / RWKV6)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4                # Mamba2 depthwise conv width

    # hybrid (Zamba2): one *shared* attention block applied every k layers
    attn_every: int = 0

    # modality frontend stub (audio conv extractor / ViT): the backbone
    # consumes precomputed embeddings of this width
    frontend: Optional[str] = None   # None | "vision" | "audio"
    frontend_dim: int = 0
    frontend_tokens: int = 0         # e.g. image patch budget for VLM

    encoder_only: bool = False

    # numerics / execution
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    attn_impl: str = "xla"           # reference-only (see module docstring)
    loss_chunk: int = 1024           # CE computed in seq chunks (0 = off):
                                     # never materialize (B, S, V) f32 logits
    causal_chunk_skip: bool = False  # triangular chunk schedule (§Perf opt;
                                     # False = masked scan-over-scan baseline)
    remat: bool = True               # activation checkpointing across layers
    scan_unroll: bool = False        # unroll every lax.scan (analysis mode:
                                     # XLA cost_analysis counts loop bodies
                                     # once, so roofline extraction compiles
                                     # reduced-depth unrolled variants)
    tie_embeddings: bool = False
    source: str = ""                 # citation

    def __post_init__(self) -> None:
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.family in ("dense", "moe", "vlm", "audio", "hybrid"):
            if self.num_heads % max(self.num_kv_heads, 1):
                raise ValueError(
                    f"{self.name}: num_heads={self.num_heads} not divisible by "
                    f"num_kv_heads={self.num_kv_heads}"
                )
        if self.family == "moe" and self.num_experts <= 0:
            raise ValueError(f"{self.name}: moe family needs num_experts > 0")

    # ---- derived ----
    @property
    def padded_vocab(self) -> int:
        p = max(self.vocab_pad_to, 1)
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_decode(self) -> bool:
        return not self.encoder_only

    def supports_long_context(self) -> bool:
        """Whether long_500k decode is sub-quadratic for this arch (natively
        or via the sliding-window variant)."""
        if self.encoder_only:
            return False
        if self.family in ("ssm", "hybrid"):
            return True
        if self.sliding_window is not None or self.long_context_window is not None:
            return True
        return False

    def effective_window(self, seq_len: int) -> Optional[int]:
        """KV window to use at a given context length: the arch's own SWA if
        any, else the long-context variant window when the context exceeds
        32k (full attention is kept — faithfully — up to 32k)."""
        if self.sliding_window is not None:
            return self.sliding_window
        if seq_len > 32768 and self.long_context_window is not None:
            return self.long_context_window
        return None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """The CPU-runnable reduced variant of the same family: 2 layers,
    d_model ≤ 512, ≤ 4 experts — used by the per-arch smoke tests."""
    heads = min(cfg.num_heads, 4)
    ratio = max(cfg.num_heads // max(cfg.num_kv_heads, 1), 1)
    kv = max(1, heads // min(ratio, heads))
    head_dim = min(cfg.head_dim, 32)
    d_model = min(cfg.d_model, 256)
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        attn_chunk_q=64,
        attn_chunk_kv=64,
        moe_group_size=32,
        ssm_chunk=32,
        param_dtype="float32",
        dtype="float32",
        remat=False,
    )
    if cfg.num_experts:
        kw["num_experts"] = min(cfg.num_experts, 4)
        kw["num_experts_per_tok"] = min(cfg.num_experts_per_tok, 2)
        # drop-free capacity so decode (tiny groups) matches prefill exactly
        kw["capacity_factor"] = float(kw["num_experts"])
    if cfg.ssm_state:
        kw["ssm_state"] = min(cfg.ssm_state, 16)
        kw["ssm_head_dim"] = 32
    if cfg.attn_every:
        kw["attn_every"] = 2
    if cfg.sliding_window is not None:
        kw["sliding_window"] = 64
    if cfg.frontend:
        kw["frontend_dim"] = min(cfg.frontend_dim, 64)
        kw["frontend_tokens"] = min(cfg.frontend_tokens, 16)
    return cfg.replace(**kw)
