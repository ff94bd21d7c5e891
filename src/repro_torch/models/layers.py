"""Shared neural-net building blocks: norms, rotary embeddings, MLPs
(``repro/models/layers.py`` in PyTorch, same numerics)."""
from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .params import ParamSpec

__all__ = [
    "rmsnorm",
    "rmsnorm_spec",
    "rope",
    "apply_rope",
    "mlp_specs",
    "mlp",
    "embed_specs",
    "embed",
    "unembed",
]


def rmsnorm_spec(dim: int) -> dict:
    return {"scale": ParamSpec((dim,), ("embed",), init="ones")}


def rmsnorm(params: Mapping[str, Any], x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis, with the math in float32."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * params["scale"].float()).to(x.dtype)


def rope(positions: torch.Tensor, head_dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotary tables for integer positions ``(..., seq)`` → cos/sin of
    shape ``(..., seq, head_dim // 2)``, on the positions' device."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim//2).

    Rotates pairs (x[..., :half], x[..., half:]), the "half-split" RoPE
    convention of the reference.
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    out1 = x1 * c - x2 * s
    out2 = x2 * c + x1 * s
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def mlp_specs(cfg: ModelConfig) -> dict:
    """SwiGLU (gate/up/down) by default; plain GELU (up/down) otherwise."""
    d, f = cfg.d_model, cfg.d_ff
    specs = {
        "up": ParamSpec((d, f), ("embed", "mlp")),
        "down": ParamSpec((f, d), ("mlp", "embed")),
    }
    if cfg.mlp_gated:
        specs["gate"] = ParamSpec((d, f), ("embed", "mlp"))
    return specs


def mlp(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    u = x @ params["up"]
    if "gate" in params:
        g = x @ params["gate"]
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = F.gelu(u.float(), approximate="tanh").to(x.dtype)
    return h @ params["down"]


def embed_specs(cfg: ModelConfig) -> dict:
    return {"table": ParamSpec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), init="embed", scale=0.02)}


def embed(params: Mapping[str, Any], tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


def unembed(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Project hidden states to vocabulary logits (always f32 out)."""
    return x.float() @ params["table"].float().T
