"""Mamba2 (SSD, state-space duality) block as Zamba2 uses it
[arXiv:2411.15242] (``repro/models/mamba2.py`` in PyTorch):

    h_t = exp(dt_t · A) ⊙ h_{t-1} + dt_t · x_t ⊗ B_t        (per head)
    y_t = C_t · h_t + D ⊙ x_t

The full-sequence form (prefill, and training) runs the SSD scan through
``kernels.mamba2_ssd`` from a zero state, which is how the reference's
``Model`` calls it (``state=None``; it drops the final state); under grad
its gradient is that of the reference's chunked form at ``ssm_chunk``,
ported as ``_ssd_chunked`` (``kernels.ref.mamba2_ssd_chunked``), which is
the recurrence's: the card's backward kernel computes it.  Decode is
the O(1) single-step update in plain torch, with the layer's state and conv
tail updated in place (about 283 MB of state at zamba2-2.7b width and
batch 4, which a functional copy per token would move for nothing).

d_inner = expand · d_model splits into heads of width ``ssm_head_dim`` (P);
N = ``ssm_state``; one B/C group; A is a scalar per head.

Tensor-parallel (``tp``, a ``distributed.tp.ModelParallel``, where
``in_z``/``in_x``/``conv_x`` hold the rank's ``d_inner`` columns and
``out`` its rows): the columns are the rank's contiguous SSM heads.  x
enters the split compute once, and so do the replicated leaves it meets
there (``in_b``, ``in_c``, ``in_dt``, ``dt_bias``, ``a_log``, ``d_skip``,
the norm's scale), dt, A and the D skip cut to the rank's heads; the scan
runs on those heads (``head_block`` from their count), the gated norm is
``tp.rmsnorm_split`` over the block and ``out``'s partial sums leave
over ``model``.  The decode state ``h`` and the conv tail are the rank's
heads and columns.
"""
from __future__ import annotations

import math
from typing import Any, Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.tp import ModelParallel, enter, leave, rmsnorm_split, split_by
from repro_torch.kernels.ref import mamba2_ssd_chunked as _ssd_chunked  # noqa: F401
from .layers import rmsnorm, rmsnorm_spec
from .params import ParamSpec

__all__ = ["mamba2_specs", "mamba2_block", "mamba2_decode_step", "SSMState", "init_ssm_state"]

HEAD_BLOCK = 8       # the reference kernel's default head_block


def mamba2_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = cfg.d_inner
    n = cfg.ssm_state
    h = cfg.ssm_heads
    return {
        "in_z": ParamSpec((d, di), ("embed", "mlp")),
        "in_x": ParamSpec((d, di), ("embed", "mlp")),
        "in_b": ParamSpec((d, n), ("embed", None)),
        "in_c": ParamSpec((d, n), ("embed", None)),
        "in_dt": ParamSpec((d, h), ("embed", None)),
        "dt_bias": ParamSpec((h,), (None,), init="zeros"),
        "a_log": ParamSpec((h,), (None,), init="zeros"),   # A = -exp(a_log)
        "d_skip": ParamSpec((h,), (None,), init="ones"),
        "conv_x": ParamSpec((cfg.ssm_conv, di), (None, "mlp"), scale=1.0),
        "norm": rmsnorm_spec(di),
        "out": ParamSpec((di, d), ("mlp", "embed")),
    }


class SSMState(NamedTuple):
    h: torch.Tensor      # (L, B, heads, P, N) f32 recurrent state
    conv: torch.Tensor   # (L, B, conv_width - 1, d_inner) conv tail


def init_ssm_state(cfg: ModelConfig, batch: int, dtype: torch.dtype, num_layers: int,
                   device: str | torch.device = "cuda") -> SSMState:
    h = (num_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    c = (num_layers, batch, cfg.ssm_conv - 1, cfg.d_inner)
    return SSMState(h=torch.zeros(h, dtype=torch.float32, device=device),
                    conv=torch.zeros(c, dtype=dtype, device=device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over (B,S,di) with w (width, di), summed from
    the oldest tap as the reference sums it; returns (silu(out), new tail)."""
    width = w.shape[0]
    if tail is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = tail.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + s] * w[i]
    new_tail = xp[:, xp.shape[1] - (width - 1):]
    return F.silu(out.float()).to(x.dtype), new_tail


def _heads(params: Mapping[str, Any], cfg: ModelConfig,
           tp: Optional[ModelParallel]) -> tuple[Optional[ModelParallel], int, int]:
    """(``tp`` where ``in_x`` holds the rank's ``d_inner`` columns, else
    None; the first of the rank's heads; their count).  Raises where the
    block is not a whole number of heads."""
    di, p = params["in_x"].shape[1], cfg.ssm_head_dim
    t = split_by(tp, di, cfg.d_inner)
    if di % p:
        raise ValueError(f"{cfg.name}: a rank's d_inner block of {di} (d_inner {cfg.d_inner} "
                         f"over a model axis of {tp.size if tp else 1}) is not a whole number "
                         f"of SSM heads of width {p}")
    nh = di // p
    return t, (t.index * nh if t is not None else 0), nh


def _inputs(params: Mapping[str, Any], x: torch.Tensor, cfg: ModelConfig,
            tp: Optional[ModelParallel]):
    """The rank's heads' ``(t, z, the conv input, B, C (f32), dt (f32,
    softplus'd), A (f32), D (f32))``, x entered where ``t``."""
    t, h0, nh = _heads(params, cfg, tp)
    x = enter(x, t)
    rep = {n: enter(params[n], t) for n in ("in_b", "in_c", "in_dt", "dt_bias", "a_log",
                                             "d_skip")}
    if t is not None:
        rep["in_dt"] = rep["in_dt"][:, h0:h0 + nh]
        for n in ("dt_bias", "a_log", "d_skip"):
            rep[n] = rep[n][h0:h0 + nh]
    z = x @ params["in_z"]
    xs = x @ params["in_x"]
    bmat = (x @ rep["in_b"]).float()
    cmat = (x @ rep["in_c"]).float()
    dt = F.softplus((x @ rep["in_dt"]).float() + rep["dt_bias"].float())
    a = -torch.exp(rep["a_log"].float())
    return t, z, xs, bmat, cmat, dt, a, rep["d_skip"].float()


def _gate_and_out(params: Mapping[str, Any], y: torch.Tensor, z: torch.Tensor,
                  cfg: ModelConfig, t: Optional[ModelParallel]) -> torch.Tensor:
    y = y * F.silu(z.float()).to(y.dtype)
    if t is None:
        y = rmsnorm(params["norm"], y, cfg.norm_eps)
    else:
        y = rmsnorm_split(params["norm"]["scale"], y, cfg.norm_eps, t, cfg.d_inner)
    return leave(y @ params["out"], t)


def mamba2_block(params: Mapping[str, Any], x: torch.Tensor, cfg: ModelConfig,
                 tp: Optional[ModelParallel] = None) -> torch.Tensor:
    """Full-sequence Mamba2 mixing from a zero state: x (B,S,d) → (B,S,d).
    The scan runs through ``kernels.mamba2_ssd`` at ``cfg.ssm_chunk``, as the
    reference passes it (so S must be a multiple of it), on the leaves'
    heads."""
    b, s, _ = x.shape
    p = cfg.ssm_head_dim
    t, z, xs, bmat, cmat, dt, a, d_skip = _inputs(params, x, cfg, tp)
    nh = xs.shape[-1] // p
    xs, _ = _causal_conv(xs, params["conv_x"], None)
    xh = xs.reshape(b, s, nh, p).float()
    y = kernels.mamba2_ssd(xh, dt, a, bmat, cmat, chunk=cfg.ssm_chunk,
                           head_block=math.gcd(nh, HEAD_BLOCK))
    y = y + xh * d_skip[None, None, :, None]
    return _gate_and_out(params, y.reshape(b, s, nh * p).to(x.dtype), z, cfg, t)


def mamba2_decode_step(params: Mapping[str, Any], x: torch.Tensor, cfg: ModelConfig,
                       h: torch.Tensor, conv_tail: torch.Tensor,
                       tp: Optional[ModelParallel] = None) -> torch.Tensor:
    """O(1) single-token update: x (B,1,d) → (B,1,d).  Updates this layer's
    ``h`` (B,H,P,N) f32 and ``conv_tail`` (B,conv-1,di) in place (the
    rank's heads and columns where the leaves are its blocks)."""
    b = x.shape[0]
    p = cfg.ssm_head_dim
    t, z, xs, bmat, cmat, dt, a, d_skip = _inputs(params, x, cfg, tp)
    nh = xs.shape[-1] // p
    xs, new_tail = _causal_conv(xs, params["conv_x"], conv_tail)
    conv_tail.copy_(new_tail)
    bmat, cmat, dt = bmat[:, 0], cmat[:, 0], dt[:, 0]

    xh = xs.reshape(b, nh, p).float()
    decay = torch.exp(dt * a[None, :])                             # (B,H)
    h.mul_(decay[..., None, None]).add_(
        (dt[:, :, None] * xh)[..., None] * bmat[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", cmat, h)
    y = y + xh * d_skip[None, :, None]
    return _gate_and_out(params, y.reshape(b, 1, nh * p).to(x.dtype), z, cfg, t)
