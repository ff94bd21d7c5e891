"""Shared neural-net building blocks: norms, rotary embeddings, MLPs
(``repro/models/layers.py`` in PyTorch, same numerics).

``mlp``, ``embed`` and ``unembed`` take a ``distributed.tp.ModelParallel``
where their leaves are the rank's blocks over ``model`` (the caller
decides from the leaves' shapes): the MLP column-parallel in gate/up and
row-parallel in down, the embedding vocab-parallel.  Without one they
compute on whole leaves as before."""
from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.tp import ModelParallel, enter, leave
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


def mlp(params: Mapping[str, Any], x: torch.Tensor,
        tp: Optional[ModelParallel] = None) -> torch.Tensor:
    """``tp``: gate/up hold the rank's columns and down its rows; the
    partial outputs are summed over ``model``."""
    x = enter(x, tp)
    u = x @ params["up"]
    if "gate" in params:
        g = x @ params["gate"]
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = F.gelu(u.float(), approximate="tanh").to(x.dtype)
    return leave(h @ params["down"], tp)


def embed_specs(cfg: ModelConfig) -> dict:
    return {"table": ParamSpec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), init="embed", scale=0.02)}


def embed(params: Mapping[str, Any], tokens: torch.Tensor,
          tp: Optional[ModelParallel] = None) -> torch.Tensor:
    """``tp``: the table holds the rank's vocab rows; each rank looks up
    the tokens in its range, zeros the rest, and the rows are summed over
    ``model`` (one nonzero term: exact)."""
    table = params["table"]
    if tp is None:
        return table[tokens.long()]
    n = table.shape[0]
    local = tokens.long() - tp.index * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return leave(torch.where(inside[..., None], rows, 0.0), tp)


def unembed(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Project hidden states to vocabulary logits (always f32 out); over
    the table's rows, the rank's vocab columns where it is a block."""
    return x.float() @ params["table"].float().T
