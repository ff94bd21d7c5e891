"""RWKV6 "Finch" [arXiv:2404.05892] (``repro/models/rwkv6.py`` in PyTorch):
attention-free time mixing with data-dependent decay, plus the RWKV
channel-mix FFN.  Per head (dk = dv = head width):

    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

The full-sequence form (prefill, and training) runs the WKV scan through
``kernels.rwkv6_wkv`` from a zero state, which is how the reference's
``Model`` calls it (``state=None``; it drops the final state); under grad
its gradient is that of the reference's chunked form, ported as
``_wkv_chunked`` (``kernels.ref.rwkv6_wkv_chunked``), which is the
recurrence's: the card's backward kernel computes it.  Decode is
the O(1) recurrence in plain torch, with the layer's state updated in
place: at rwkv6-3b width and batch 4 the states are about 84 MB, and a
functional copy per token would move them through memory for nothing.

The reference's simplifications are kept: static token-shift
interpolation, and an RMSNorm over all of d_model after the scan (the
reference's docstring says per head; its code norms over d_model).

Tensor-parallel (``tp``, a ``distributed.tp.ModelParallel``): each leaf
says by its shape whether it is the rank's block.  Where ``wr``/``wk``/
``wv`` hold the rank's heads, x enters the split compute once (with the
token-shift mixes and ``w_lora_a`` it meets there), the WKV scan runs on
the rank's heads and ``ln_out`` is ``tp.rmsnorm_split`` over their
columns.  Where ``wg``/``wo`` hold the rank's ``mlp`` columns the gate
multiplies those columns of y (entered and cut where the heads are whole:
rwkv6-3b at model 16, 40 heads) and ``wo``'s partial sums leave over
``model``.  The channel mix is column-parallel in ``wk`` and ``wr``,
row-parallel in ``wv``; the sigmoid gate's columns are gathered and the
product taken in replicated compute.  The decode state ``s`` holds the
rank's heads; the shift rows stay whole.
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.tp import ModelParallel, enter, gather_last, leave, \
    rmsnorm_split, split_by
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


def _decay(params: Mapping[str, Any], xw: torch.Tensor, lora_a: torch.Tensor) -> torch.Tensor:
    """log w_t ∈ (−inf, 0): low-rank data-dependent decay plus a base, in
    f32, on ``w_lora_b``'s heads; ``lora_a`` is ``w_lora_a`` as the split
    compute takes it."""
    lora = torch.tanh((xw @ lora_a).float())
    lb = params["w_lora_b"].float()
    wraw = params["w_base"].float() + (lora @ lb.flatten(1)).unflatten(-1, lb.shape[1:])
    return -F.softplus(wraw)


def _project(params: Mapping[str, Any], x: torch.Tensor, mu: torch.Tensor,
             prev: Optional[torch.Tensor], wname: str) -> torch.Tensor:
    """Token-shifted (B,S,d) @ (d,H,dk) → (B,S,H,dk)."""
    w = params[wname]
    xm = _token_shift(x, mu, prev)
    return (xm @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _largest_divisor(s: int, cap: int) -> int:
    """The largest divisor of s up to cap (1 for s < 2), as the reference
    picks its chunk (``rwkv6.py:219-221``)."""
    chunk = min(cap, s) if s >= 2 else 1
    while s % chunk:
        chunk -= 1
    return chunk


def _splits(params: Mapping[str, Any], d: int,
            tp: Optional[ModelParallel]) -> tuple[Optional[ModelParallel],
                                                  Optional[ModelParallel]]:
    """(``tp`` where ``wr`` holds the rank's heads, ``tp`` where ``wg``
    holds its ``mlp`` columns), each None where the leaf is whole."""
    _, h, dk = params["wr"].shape
    return split_by(tp, h, d // dk), split_by(tp, params["wg"].shape[1], d)


def _time_mix(params: Mapping[str, Any], x: torch.Tensor, cfg: ModelConfig,
              prev: Optional[torch.Tensor], tp: Optional[ModelParallel],
              wkv) -> torch.Tensor:
    """The time mix on x (B,S,d) normed, the first position shifted from
    ``prev`` (B,d) or zeros; ``wkv(r, k, v, logw, u)`` → y (B,S,H,dk) f32
    on the leaves' heads.  Split as the module docstring says."""
    b, s, d = x.shape
    th, tm = _splits(params, d, tp)
    xh = enter(x, th)
    mu = {n: enter(params[n], th) for n in ("mu_r", "mu_k", "mu_v", "mu_w")}
    r = _project(params, xh, mu["mu_r"], prev, "wr").float()
    k = _project(params, xh, mu["mu_k"], prev, "wk").float()
    v = _project(params, xh, mu["mu_v"], prev, "wv").float()
    logw = _decay(params, _token_shift(xh, mu["mu_w"], prev), enter(params["w_lora_a"], th))
    y = wkv(r, k, v, logw, params["bonus_u"].float())
    y = y.reshape(b, s, y.shape[-2] * y.shape[-1]).to(x.dtype)
    if th is None:
        y = rmsnorm(params["ln_out"], y, cfg.norm_eps)
    else:
        y = rmsnorm_split(params["ln_out"]["scale"], y, cfg.norm_eps, th, d)
        if tm is None:                      # the gate on whole wg/wo: y's columns joined
            y = gather_last(y, th)
    if tm is not None and th is None:       # heads whole: y enters, cut to wg's columns
        n = params["wg"].shape[1]
        y = enter(y, tm)[..., tm.index * n:(tm.index + 1) * n]
    xg = xh if th is not None and tm is not None else enter(x, tm)
    g = _token_shift(xg, enter(params["mu_g"], tm), prev) @ params["wg"]
    y = y * F.silu(g.float()).to(y.dtype)
    return leave(y @ params["wo"], tm)


def rwkv6_time_mix(params: Mapping[str, Any], x: torch.Tensor, cfg: ModelConfig,
                   tp: Optional[ModelParallel] = None) -> torch.Tensor:
    """Full-sequence time mix from a zero state: x (B,S,d) normed → (B,S,d).
    The scan runs through ``kernels.rwkv6_wkv`` (chunk chosen below)."""
    s = x.shape[1]
    # The reference's jnp ``_wkv_chunked`` takes the largest divisor of S up
    # to ssm_chunk, and any chunk gives it the same result (chunk invariance,
    # tests/test_kernels.py:96-149).  The kernel's check refuses a chunk above
    # the reference's fold tile that is not a multiple of it (48 at S = 96),
    # so the port takes the largest divisor of S up to min(ssm_chunk,
    # STATE_TILE), which passes it.  The CUDA kernel walks its own fold tile
    # whatever the chunk, so the chunk does not change its work.  The
    # gradient is the chunked form's at the reference's own chunk, the
    # arithmetic that jax.value_and_grad differentiates (on the card the
    # backward kernel checks it and computes the recurrence's gradient).
    chunk = _largest_divisor(s, min(cfg.ssm_chunk, STATE_TILE))
    grad_chunk = _largest_divisor(s, cfg.ssm_chunk)
    return _time_mix(params, x, cfg, None, tp, lambda r, k, v, logw, u: kernels.rwkv6_wkv(
        r, k, v, logw, u, chunk, grad_chunk=grad_chunk))


def rwkv6_channel_mix(params: Mapping[str, Any], x: torch.Tensor,
                      prev: Optional[torch.Tensor] = None,
                      tp: Optional[ModelParallel] = None) -> torch.Tensor:
    """The channel mix; where ``wk``/``wr`` hold the rank's ``mlp``
    columns and ``wv`` its rows (``tp``) the output is still replicated."""
    t = split_by(tp, params["wr"].shape[1], x.shape[-1])
    xe = enter(x, t)
    xk = _token_shift(xe, enter(params["mu_k"], t), prev)
    xr = _token_shift(xe, enter(params["mu_r"], t), prev)
    kk = torch.square(torch.relu((xk @ params["wk"]).float())).to(x.dtype)
    vv = leave(kk @ params["wv"], t)
    rr = gather_last(torch.sigmoid((xr @ params["wr"]).float()).to(x.dtype), t)
    return rr * vv


def rwkv6_block(params: Mapping[str, Any], x: torch.Tensor, cfg: ModelConfig,
                tp: Optional[ModelParallel] = None) -> torch.Tensor:
    """One RWKV6 layer over a full sequence from a zero state: pre-norm time
    mix and pre-norm channel mix, each with its residual."""
    x = x + rwkv6_time_mix(params["time"], rmsnorm(params["ln1"], x, cfg.norm_eps), cfg, tp)
    return x + rwkv6_channel_mix(params["channel"], rmsnorm(params["ln2"], x, cfg.norm_eps),
                                 tp=tp)


def rwkv6_decode_step(params: Mapping[str, Any], x: torch.Tensor, cfg: ModelConfig,
                      s: torch.Tensor, shift_t: torch.Tensor, shift_c: torch.Tensor,
                      tp: Optional[ModelParallel] = None) -> torch.Tensor:
    """O(1) decode of one layer: x (B,1,d) → (B,1,d).  Updates this layer's
    state in place: ``s`` (B,H,dk,dk) f32 (the rank's heads where ``wr``
    holds them) and the token-shift rows ``shift_t`` / ``shift_c`` (B,d),
    which hold the *normed* streams."""
    xn = rmsnorm(params["ln1"], x, cfg.norm_eps)

    def wkv(r, k, v, logw, u):
        r, k, v, logw = r[:, 0], k[:, 0], v[:, 0], logw[:, 0]
        kv = k[..., :, None] * v[..., None, :]
        y = torch.einsum("bhk,bhkj->bhj", r, s + u[None, :, :, None] * kv)
        s.mul_(torch.exp(logw)[..., None]).add_(kv)
        return y[:, None]

    x1 = x + _time_mix(params["time"], xn, cfg, shift_t, tp, wkv)
    shift_t.copy_(xn[:, -1])
    xn2 = rmsnorm(params["ln2"], x1, cfg.norm_eps)
    out = x1 + rwkv6_channel_mix(params["channel"], xn2, shift_c, tp)
    shift_c.copy_(xn2[:, -1])
    return out
