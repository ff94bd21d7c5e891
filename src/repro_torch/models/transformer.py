"""The dense transformer stack (``repro/models/transformer.py`` for the
dense family), with the reference's functional API::

    init(seed, device)              → params (nested dict, layer-stacked)
    forward(params, batch)          → (logits, aux)           [prefill]
    prefill(params, batch)          → last-position logits (B, vocab)
    init_decode_state(batch, ctx)   → DecodeState
    decode_step(params, state, tok) → (logits, DecodeState)   [serving]

The reference's ``lax.scan`` over stacked layer weights is a Python loop
over the stacked axis.  Other families (MoE, SSM, hybrid, VLM, audio) and
``loss`` come with later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from . import layers as L
from .attention import (
    KVCache,
    attention_block,
    attention_specs,
    cache_write_slot,
    decode_attention_block,
    init_kv_cache,
)
from .params import ParamSpec, count_params, count_params_from_specs, init_params, \
    resolve_dtype, stack_specs

__all__ = ["Model", "DecodeState"]


class DecodeState(NamedTuple):
    """Decode state of the dense family (the reference's union state has
    ``ssm`` and ``rwkv`` fields for the families not ported yet)."""
    kv: KVCache


def _decode_window(cfg: ModelConfig, capacity: int) -> Optional[int]:
    """Window to apply during decode, derived from the cache capacity: a
    cache whose capacity equals the arch's SWA window or the long-context
    window is a ring buffer and attention must mask to the window."""
    if cfg.sliding_window is not None and capacity <= cfg.sliding_window:
        return cfg.sliding_window
    if cfg.long_context_window is not None and capacity == cfg.long_context_window:
        return cfg.long_context_window
    return None


def _dense_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "attn": attention_specs(cfg),
        "mlp": L.mlp_specs(cfg),
    }


def _layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a layer-stacked param tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    def __post_init__(self) -> None:
        if self.cfg.family != "dense":
            raise NotImplementedError(
                f"{self.cfg.name}: family {self.cfg.family!r} is not ported yet "
                "(repro_torch ports the dense family first; MoE, SSM, hybrid, "
                "VLM and audio come with later slices)")

    # ---------------- specs ----------------
    def specs(self) -> dict:
        cfg = self.cfg
        return {
            "final_ln": L.rmsnorm_spec(cfg.d_model),
            "embed": L.embed_specs(cfg),
            "lm_head": {"table": ParamSpec((cfg.padded_vocab, cfg.d_model),
                                           ("vocab", "embed"), scale=1.0)},
            "layers": stack_specs(_dense_layer_specs(cfg), cfg.num_layers),
        }

    def init(self, seed: int = 0, device: str | torch.device = "cuda") -> dict:
        """Random weights from a ``torch.Generator`` on ``device`` seeded
        with ``seed``, with the reference's distributions."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return init_params(self.specs(), gen, resolve_dtype(self.cfg.param_dtype), device)

    def num_params(self, params: Optional[dict] = None) -> int:
        if params is not None:
            return count_params(params)
        return count_params_from_specs(self.specs())

    # ---------------- embedding / head ----------------
    def _head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Vocab logits (f32, exactly vocab_size columns)."""
        cfg = self.cfg
        x = L.rmsnorm(params["final_ln"], x, cfg.norm_eps)
        logits = L.unembed(params["lm_head"], x)
        return logits[..., : cfg.vocab_size]

    # ---------------- forward (prefill) ----------------
    def _hidden(self, params: dict, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        tokens = batch["tokens"]
        x = L.embed(params["embed"], tokens).to(resolve_dtype(cfg.dtype))
        s = x.shape[1]
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        causal = not cfg.encoder_only
        window = cfg.effective_window(s)
        for i in range(cfg.num_layers):
            lp = _layer(params["layers"], i)
            h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
            x = x + attention_block(lp["attn"], h, cfg, positions, causal, window)
            h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
            x = x + L.mlp(lp["mlp"], h)
        return x

    def forward(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """Full logits (B, S, vocab_size) and an empty aux dict."""
        return self._head(params, self._hidden(params, batch)), {}

    def prefill(self, params: dict, batch: dict) -> torch.Tensor:
        """Next-token logits for the final position only (B, vocab)."""
        x = self._hidden(params, batch)
        return self._head(params, x[:, -1:, :])[:, 0]

    # ---------------- decode ----------------
    def init_decode_state(self, batch: int, context: int,
                          device: str | torch.device = "cuda") -> DecodeState:
        cfg = self.cfg
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        kv = init_kv_cache(cfg, batch, context, resolve_dtype(cfg.dtype),
                           cfg.num_layers, device=device)
        return DecodeState(kv=kv)

    def decode_step(self, params: dict, state: DecodeState,
                    tokens: torch.Tensor) -> tuple[torch.Tensor, DecodeState]:
        """tokens: (B,) one new token per sequence.  Updates ``state``'s
        cache in place and returns it with the logits (B, vocab)."""
        cfg = self.cfg
        cache = state.kv
        x = L.embed(params["embed"], tokens[:, None]).to(resolve_dtype(cfg.dtype))
        window = _decode_window(cfg, cache.positions.shape[0])
        slot = cache_write_slot(cache.positions, cache.next_pos)
        cache.positions.index_copy_(0, slot, cache.next_pos.reshape(1))
        for i in range(cfg.num_layers):
            lp = _layer(params["layers"], i)
            h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
            x = x + decode_attention_block(
                lp["attn"], h, cfg, cache.k[i], cache.v[i], cache.positions,
                cache.next_pos, slot, window)
            h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
            x = x + L.mlp(lp["mlp"], h)
        cache.next_pos.add_(1)
        return self._head(params, x)[:, 0], state
