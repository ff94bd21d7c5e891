"""Attention: GQA projections with optional qk-norm, full-sequence
attention through the flash kernel, and single-token decode through the
decode kernel against a ring-buffer KV cache.

The KV cache is updated in place: the new token's K/V are written into
their ring slot with ``index_copy_``, where the reference returns a new
cache each step.  At full qwen3-4b width with batch 4 and context 1024
the cache is about 1.2 GB, and a functional copy every step would double
that and move it through memory once per token.  A caller that wants an
earlier state must ``clone()`` it.

Tensor-parallel (``tp``, a ``distributed.tp.ModelParallel``, where ``wq``
holds the rank's heads): q, the output projection and (where the KV heads
divide the model axis) k/v work on the rank's heads, with the GQA map by
global head index, and the output's partial sums are summed over
``model``.  Where the KV heads cannot split (a kv deficit: ``wk``/``wv``
whole), each rank computes the whole K/V and attends with its q heads over
the KV heads they map to.  In decode under a deficit the cache is the
rank's slot range (``decode_state_spec``'s slot split) or whole: q's
heads are gathered, the decode kernel attends every head over the rank's
slots and returns each row's log-sum-exp, and ``tp.merge_partials`` joins
the ranks' partials; the ring's write slot is written by the rank that
owns it.
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional

import torch

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.tp import ModelParallel, enter, gather_last, leave, \
    merge_partials, split_by
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


def _project_qkv(params: Mapping[str, Any], x: torch.Tensor, cfg: ModelConfig,
                 tp: Optional[ModelParallel] = None):
    """q on ``wq``'s heads, k/v on ``wk``'s.  ``tp`` (heads split): x, the
    qk-norm scales and the whole ``wk``/``wv``/``bk``/``bv`` of a kv
    deficit enter the split compute."""
    x = enter(x, tp)
    whole_kv = tp is not None and params["wk"].shape[1] == cfg.num_kv_heads
    kv = {n: enter(params[n], tp) if whole_kv else params[n]
          for n in ("wk", "wv", "bk", "bv") if n in params}
    q = _project(x, params["wq"])
    k = _project(x, kv["wk"])
    v = _project(x, kv["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + kv["bk"]
        v = v + kv["bv"]
    if cfg.qk_norm:
        q = rmsnorm({"scale": enter(params["q_norm"]["scale"], tp)}, q, cfg.norm_eps)
        k = rmsnorm({"scale": enter(params["k_norm"]["scale"], tp)}, k, cfg.norm_eps)
    return q, k, v


def _kv_for_heads(k: torch.Tensor, h0: int, hl: int, group: int) -> torch.Tensor:
    """Of whole K/V (..., K, D), the KV heads that q heads ``[h0, h0+hl)``
    map to (global head h uses KV head h // group), laid out so that the
    ``hl`` heads divide evenly over them: the one group the heads lie in
    (every kv deficit of the registry's archs), or else one KV head per q
    head."""
    if h0 // group == (h0 + hl - 1) // group:
        return k[..., h0 // group:h0 // group + 1, :]
    idx = torch.arange(h0, h0 + hl, device=k.device) // group
    return k.index_select(-2, idx)


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
                    window: Optional[int] = None,
                    tp: Optional[ModelParallel] = None) -> torch.Tensor:
    """Full-sequence attention (prefill) through ``kernels.flash_attention``,
    as the reference routes it under ``attn_impl="pallas"``; on the rank's
    heads where ``wq`` holds them (module docstring)."""
    tp = split_by(tp, params["wq"].shape[1], cfg.num_heads)
    q, k, v = _project_qkv(params, x, cfg, tp)
    cos, sin = rope(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if tp is not None and k.shape[-2] == cfg.num_kv_heads:
        hl, group = q.shape[-2], cfg.num_heads // cfg.num_kv_heads
        k = _kv_for_heads(k, tp.index * hl, hl, group)
        v = _kv_for_heads(v, tp.index * hl, hl, group)
    out = kernels.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=causal, window=window)
    return leave(_out_proj(out, params["wo"]), tp)


def decode_attention_block(params: Mapping[str, Any], x: torch.Tensor, cfg: ModelConfig,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           cache_positions: torch.Tensor, next_pos: torch.Tensor,
                           slot: torch.Tensor, window: Optional[int] = None,
                           tp: Optional[ModelParallel] = None) -> torch.Tensor:
    """One-token decode: write the new K/V into ring slot ``slot`` of this
    layer's caches (in place), then attend over the whole cache through
    ``kernels.decode_attention``.  ``cache_positions`` (the whole ring's)
    must already hold ``next_pos`` at ``slot``: ``Model.decode_step``
    writes it once for all layers.  x (B,1,d) → (B,1,d).  With the heads
    split, the caches are the rank's KV heads, or under a kv deficit its
    slot range or the whole ring (module docstring)."""
    tp = split_by(tp, params["wq"].shape[1], cfg.num_heads)
    q, k, v = _project_qkv(params, x, cfg, tp)  # (B,1,H,D) / (B,1,K,D)
    cos, sin = rope(next_pos.reshape(1), cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if tp is None or k.shape[-2] < cfg.num_kv_heads:
        k_cache.index_copy_(1, slot, k)
        v_cache.index_copy_(1, slot, v)
        out = kernels.decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                                       cache_positions, next_pos, window=window)
        return leave(_out_proj(out[:, None], params["wo"]), tp)
    # kv deficit: every head over the rank's slots [lo, lo + n)
    n, hl = k_cache.shape[1], q.shape[-2]
    lo = tp.index * n if split_by(tp, n, cache_positions.shape[0]) else 0
    local = slot - lo
    owned = ((local >= 0) & (local < n)).reshape(1, 1, 1, 1)
    local = local.clamp(0, n - 1)
    for cache, new in ((k_cache, k), (v_cache, v)):
        cache.index_copy_(1, local, torch.where(owned, new, cache.index_select(1, local)))
    q_all = gather_last(q[:, 0].flatten(-2), tp).unflatten(-1, (cfg.num_heads, cfg.head_dim))
    pos = cache_positions[lo:lo + n]
    if n < cache_positions.shape[0]:
        out, lse = kernels.decode_attention(q_all.contiguous(), k_cache, v_cache, pos,
                                            next_pos, window=window, lse=True)
        out = merge_partials(out, lse, tp.all_reduce)
    else:
        out = kernels.decode_attention(q_all.contiguous(), k_cache, v_cache, pos, next_pos,
                                       window=window)
    h0 = tp.index * hl
    return leave(_out_proj(out[:, None, h0:h0 + hl], params["wo"]), tp)
