"""RWKV6 "Finch" [arXiv:2404.05892] (``repro/models/rwkv6.py`` in PyTorch):
attention-free time mixing with data-dependent decay, plus the RWKV
channel-mix FFN.  Per head (dk = dv = head width):

    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

The full-sequence form (prefill, and training) runs the WKV scan through
``kernels.rwkv6_wkv`` from a zero state, which is how the reference's
``Model`` calls it (``state=None``; it drops the final state); under grad
its gradient is that of the reference's chunked form, ported as
``_wkv_chunked`` (``kernels.ref.rwkv6_wkv_chunked``).  Decode is
the O(1) recurrence in plain torch, with the layer's state updated in
place: at rwkv6-3b width and batch 4 the states are about 84 MB, and a
functional copy per token would move them through memory for nothing.

The reference's simplifications are kept: static token-shift
interpolation, and an RMSNorm over all of d_model after the scan (the
reference's docstring says per head; its code norms over d_model).
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import rwkv6_wkv_chunked as _wkv_chunked  # noqa: F401
from repro_torch.kernels.rwkv6_scan import STATE_TILE
from .layers import rmsnorm, rmsnorm_spec
from .params import ParamSpec

__all__ = [
    "rwkv6_specs",
    "rwkv6_time_mix",
    "rwkv6_channel_mix",
    "rwkv6_block",
    "rwkv6_decode_step",
    "RWKVState",
    "init_rwkv_state",
]

DECAY_LORA = 64


def rwkv6_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h = cfg.num_heads if cfg.num_heads else d // cfg.ssm_head_dim
    dk = d // h
    f = cfg.d_ff
    return {
        "time": {
            "mu_r": ParamSpec((d,), ("embed",), init="zeros"),
            "mu_k": ParamSpec((d,), ("embed",), init="zeros"),
            "mu_v": ParamSpec((d,), ("embed",), init="zeros"),
            "mu_g": ParamSpec((d,), ("embed",), init="zeros"),
            "mu_w": ParamSpec((d,), ("embed",), init="zeros"),
            "wr": ParamSpec((d, h, dk), ("embed", "heads", "head_dim")),
            "wk": ParamSpec((d, h, dk), ("embed", "heads", "head_dim")),
            "wv": ParamSpec((d, h, dk), ("embed", "heads", "head_dim")),
            "wg": ParamSpec((d, d), ("embed", "mlp")),
            "w_base": ParamSpec((h, dk), ("heads", "head_dim"), init="zeros"),
            "w_lora_a": ParamSpec((d, DECAY_LORA), ("embed", None)),
            "w_lora_b": ParamSpec((DECAY_LORA, h, dk), (None, "heads", "head_dim")),
            "bonus_u": ParamSpec((h, dk), ("heads", "head_dim"), init="zeros"),
            "ln_out": rmsnorm_spec(d),
            "wo": ParamSpec((d, d), ("mlp", "embed")),
        },
        "ln1": rmsnorm_spec(d),
        "ln2": rmsnorm_spec(d),
        "channel": {
            "mu_k": ParamSpec((d,), ("embed",), init="zeros"),
            "mu_r": ParamSpec((d,), ("embed",), init="zeros"),
            "wk": ParamSpec((d, f), ("embed", "mlp")),
            "wv": ParamSpec((f, d), ("mlp", "embed")),
            "wr": ParamSpec((d, d), ("embed", "mlp")),
        },
    }


class RWKVState(NamedTuple):
    s: torch.Tensor        # (L, B, H, dk, dv) f32 wkv state
    shift_t: torch.Tensor  # (L, B, d) last normed token of the time mix
    shift_c: torch.Tensor  # (L, B, d) last normed token of the channel mix


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype: torch.dtype, num_layers: int,
                    device: str | torch.device = "cuda") -> RWKVState:
    h = cfg.num_heads
    dk = cfg.d_model // h
    return RWKVState(
        s=torch.zeros((num_layers, batch, h, dk, dk), dtype=torch.float32, device=device),
        shift_t=torch.zeros((num_layers, batch, cfg.d_model), dtype=dtype, device=device),
        shift_c=torch.zeros((num_layers, batch, cfg.d_model), dtype=dtype, device=device),
    )


def _token_shift(x: torch.Tensor, mu: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x + mu ⊙ (shift(x) − x), where shift(x)_t = x_{t-1} and the first
    position takes ``prev`` (B,d), or zeros."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    else:
        prev = prev[:, None].to(x.dtype)
    xs = torch.cat([prev, x[:, :-1]], dim=1)
    return x + mu * (xs - x)


def _decay(params: Mapping[str, Any], xw: torch.Tensor) -> torch.Tensor:
    """log w_t ∈ (−inf, 0): low-rank data-dependent decay plus a base, in f32."""
    lora = torch.tanh((xw @ params["w_lora_a"]).float())
    lb = params["w_lora_b"].float()
    wraw = params["w_base"].float() + (lora @ lb.flatten(1)).unflatten(-1, lb.shape[1:])
    return -F.softplus(wraw)


def _project(params: Mapping[str, Any], x: torch.Tensor, mu_key: str,
             prev: Optional[torch.Tensor], wname: str) -> torch.Tensor:
    """Token-shifted (B,S,d) @ (d,H,dk) → (B,S,H,dk)."""
    w = params[wname]
    xm = _token_shift(x, params[mu_key], prev)
    return (xm @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _gate_and_out(params: Mapping[str, Any], y: torch.Tensor, g: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm over d_model, the SiLU gate, the output projection."""
    y = rmsnorm(params["ln_out"], y, cfg.norm_eps)
    y = y * F.silu(g.float()).to(y.dtype)
    return y @ params["wo"]


def _largest_divisor(s: int, cap: int) -> int:
    """The largest divisor of s up to cap (1 for s < 2), as the reference
    picks its chunk (``rwkv6.py:219-221``)."""
    chunk = min(cap, s) if s >= 2 else 1
    while s % chunk:
        chunk -= 1
    return chunk


def rwkv6_time_mix(params: Mapping[str, Any], x: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence time mix from a zero state: x (B,S,d) normed → (B,S,d).
    The scan runs through ``kernels.rwkv6_wkv`` (chunk chosen below)."""
    b, s, d = x.shape
    r = _project(params, x, "mu_r", None, "wr").float()
    k = _project(params, x, "mu_k", None, "wk").float()
    v = _project(params, x, "mu_v", None, "wv").float()
    g = _token_shift(x, params["mu_g"], None) @ params["wg"]
    logw = _decay(params, _token_shift(x, params["mu_w"], None))
    u = params["bonus_u"].float()

    # The reference's jnp ``_wkv_chunked`` takes the largest divisor of S up
    # to ssm_chunk, and any chunk gives it the same result (chunk invariance,
    # tests/test_kernels.py:96-149).  The kernel's check refuses a chunk above
    # the reference's fold tile that is not a multiple of it (48 at S = 96),
    # so the port takes the largest divisor of S up to min(ssm_chunk,
    # STATE_TILE), which passes it.  The CUDA kernel walks its own fold tile
    # whatever the chunk, so the chunk does not change its work.  The
    # gradient is the chunked form's at the reference's own chunk, the
    # arithmetic that jax.value_and_grad differentiates.
    y = kernels.rwkv6_wkv(r, k, v, logw, u, _largest_divisor(s, min(cfg.ssm_chunk, STATE_TILE)),
                          grad_chunk=_largest_divisor(s, cfg.ssm_chunk))
    return _gate_and_out(params, y.reshape(b, s, d).to(x.dtype), g, cfg)


def rwkv6_channel_mix(params: Mapping[str, Any], x: torch.Tensor,
                      prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    xk = _token_shift(x, params["mu_k"], prev)
    xr = _token_shift(x, params["mu_r"], prev)
    kk = torch.square(torch.relu((xk @ params["wk"]).float())).to(x.dtype)
    vv = kk @ params["wv"]
    rr = torch.sigmoid((xr @ params["wr"]).float()).to(x.dtype)
    return rr * vv


def rwkv6_block(params: Mapping[str, Any], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One RWKV6 layer over a full sequence from a zero state: pre-norm time
    mix and pre-norm channel mix, each with its residual."""
    x = x + rwkv6_time_mix(params["time"], rmsnorm(params["ln1"], x, cfg.norm_eps), cfg)
    return x + rwkv6_channel_mix(params["channel"], rmsnorm(params["ln2"], x, cfg.norm_eps))


def rwkv6_decode_step(params: Mapping[str, Any], x: torch.Tensor, cfg: ModelConfig,
                      s: torch.Tensor, shift_t: torch.Tensor,
                      shift_c: torch.Tensor) -> torch.Tensor:
    """O(1) decode of one layer: x (B,1,d) → (B,1,d).  Updates this layer's
    state in place: ``s`` (B,H,dk,dk) f32 and the token-shift rows
    ``shift_t`` / ``shift_c`` (B,d), which hold the *normed* streams."""
    b, _, d = x.shape
    tp = params["time"]
    xn = rmsnorm(params["ln1"], x, cfg.norm_eps)

    r = _project(tp, xn, "mu_r", shift_t, "wr").float()[:, 0]
    k = _project(tp, xn, "mu_k", shift_t, "wk").float()[:, 0]
    v = _project(tp, xn, "mu_v", shift_t, "wv").float()[:, 0]
    g = _token_shift(xn, tp["mu_g"], shift_t) @ tp["wg"]
    logw = _decay(tp, _token_shift(xn, tp["mu_w"], shift_t))[:, 0]
    u = tp["bonus_u"].float()

    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkj->bhj", r, s + u[None, :, :, None] * kv)
    s.mul_(torch.exp(logw)[..., None]).add_(kv)
    shift_t.copy_(xn[:, -1])

    x1 = x + _gate_and_out(tp, y.reshape(b, 1, d).to(x.dtype), g, cfg)
    xn2 = rmsnorm(params["ln2"], x1, cfg.norm_eps)
    out = x1 + rwkv6_channel_mix(params["channel"], xn2, shift_c)
    shift_c.copy_(xn2[:, -1])
    return out
