"""Attention: GQA projections with optional qk-norm, full-sequence
attention through the flash kernel, and single-token decode through the
decode kernel against a ring-buffer KV cache.

The KV cache is updated in place: the new token's K/V are written into
their ring slot with ``index_copy_``, where the reference returns a new
cache each step.  At full qwen3-4b width with batch 4 and context 1024
the cache is about 1.2 GB, and a functional copy every step would double
that and move it through memory once per token.  A caller that wants an
earlier state must ``clone()`` it.
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional

import torch

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from .layers import apply_rope, rmsnorm, rope
from .params import ParamSpec

__all__ = [
    "attention_specs",
    "attention_block",
    "decode_attention_block",
    "KVCache",
    "init_kv_cache",
    "cache_write_slot",
]


def attention_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    specs: dict[str, Any] = {
        "wq": ParamSpec((d, cfg.num_heads, cfg.head_dim), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, cfg.num_kv_heads, cfg.head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, cfg.num_kv_heads, cfg.head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((cfg.num_heads, cfg.head_dim, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((cfg.num_heads, cfg.head_dim), ("heads", "head_dim"), init="zeros")
        specs["bk"] = ParamSpec((cfg.num_kv_heads, cfg.head_dim), ("kv_heads", "head_dim"), init="zeros")
        specs["bv"] = ParamSpec((cfg.num_kv_heads, cfg.head_dim), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        specs["q_norm"] = {"scale": ParamSpec((cfg.head_dim,), ("head_dim",), init="ones")}
        specs["k_norm"] = {"scale": ParamSpec((cfg.head_dim,), ("head_dim",), init="ones")}
    return specs


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,S,d) @ (d,H,Dh) → (B,S,H,Dh) as one matrix product."""
    d, h, dh = w.shape
    return (x @ w.reshape(d, h * dh)).unflatten(-1, (h, dh))


def _project_qkv(params: Mapping[str, Any], x: torch.Tensor, cfg: ModelConfig):
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B,S,H,Dh) @ (H,Dh,d) → (B,S,d)."""
    h, dh, d = wo.shape
    return out.flatten(-2) @ wo.reshape(h * dh, d)


class KVCache(NamedTuple):
    k: torch.Tensor          # (L, B, C, K, D) stacked over layers
    v: torch.Tensor          # (L, B, C, K, D)
    positions: torch.Tensor  # (C,) int32 absolute position per slot, -1 = empty
    next_pos: torch.Tensor   # () int32 next absolute position to write


def init_kv_cache(cfg: ModelConfig, batch: int, context: int, dtype: torch.dtype,
                  num_attn_layers: Optional[int] = None,
                  device: str | torch.device = "cuda") -> KVCache:
    """A cache with capacity ``min(context, window)`` slots (ring buffer
    when the arch uses a window at this context length)."""
    window = cfg.effective_window(context)
    cap = context if window is None else min(context, window)
    layers = num_attn_layers if num_attn_layers is not None else cfg.num_layers
    shape = (layers, batch, cap, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        positions=torch.full((cap,), -1, dtype=torch.int32, device=device),
        next_pos=torch.zeros((), dtype=torch.int32, device=device),
    )


def cache_write_slot(cache_positions: torch.Tensor, next_pos: torch.Tensor) -> torch.Tensor:
    """Ring-buffer slot for the next write, as a one-element int64 index
    on the cache's device (no host synchronisation)."""
    cap = cache_positions.shape[0]
    return torch.remainder(next_pos, cap).long().reshape(1)


def attention_block(params: Mapping[str, Any], x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence attention (prefill) through ``kernels.flash_attention``,
    as the reference routes it under ``attn_impl="pallas"``."""
    q, k, v = _project_qkv(params, x, cfg)
    cos, sin = rope(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = kernels.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=causal, window=window)
    return _out_proj(out, params["wo"])


def decode_attention_block(params: Mapping[str, Any], x: torch.Tensor, cfg: ModelConfig,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           cache_positions: torch.Tensor, next_pos: torch.Tensor,
                           slot: torch.Tensor,
                           window: Optional[int] = None) -> torch.Tensor:
    """One-token decode: write the new K/V into ring slot ``slot`` of this
    layer's caches (in place), then attend over the whole cache through
    ``kernels.decode_attention``.  ``cache_positions`` must already hold
    ``next_pos`` at ``slot``: ``Model.decode_step`` writes it once for all
    layers.  x (B,1,d) → (B,1,d)."""
    q, k, v = _project_qkv(params, x, cfg)  # (B,1,H,D) / (B,1,K,D)
    cos, sin = rope(next_pos.reshape(1), cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    k_cache.index_copy_(1, slot, k)
    v_cache.index_copy_(1, slot, v)
    out = kernels.decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                                   cache_positions, next_pos, window=window)
    return _out_proj(out[:, None], params["wo"])
