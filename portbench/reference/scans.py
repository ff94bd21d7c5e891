"""The plain chunked WKV scan in float32, for the reference of the ssm
family.

A frozen copy of the chunked form that the program keeps as its plain
version (``rwkv6_wkv_chunked``), from a zero state, with the heads taken a
block at a time so that the pairwise decay tensors of a 4096-row sequence
fit on one card.  Differentiable under autograd.  No kernel, no state
carried out.

    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ),  S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
"""
from __future__ import annotations

import torch

WKV_CHUNK = 32
WKV_HEAD_BLOCK = 8


def _largest_divisor(s: int, cap: int) -> int:
    c = min(cap, s)
    while s % c:
        c -= 1
    return c


def _masked_exp(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """exp(x) where ``keep``, else 0, with the dropped entries zeroed before
    the exp as well, so that neither the value nor the gradient overflows."""
    return torch.where(keep, torch.exp(torch.where(keep, x, 0.0)), 0.0)


def _carry(inputs: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """The state entering each chunk, from a zero state: s ← s·decay_c +
    inputs_c over axis 1."""
    s = torch.zeros_like(inputs[:, 0])
    starts = []
    for c in range(inputs.shape[1]):
        starts.append(s)
        s = s * decay[:, c] + inputs[:, c]
    return torch.stack(starts, dim=1)


def _wkv_heads(r, k, v, logw, u, chunk: int) -> torch.Tensor:
    b, s, h, dk = r.shape
    nc = s // chunk
    rc, kc, vc, lw = (t.reshape(b, nc, chunk, h, dk) for t in (r, k, v, logw))
    cum = torch.cumsum(lw, dim=2)
    total = cum[:, :, -1]
    cum_tm1 = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]], dim=2)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    pair = _masked_exp(cum_tm1[:, :, :, None] - cum[:, :, None], tri[:, :, None, None])
    amat = (rc[:, :, :, None] * kc[:, :, None] * pair).sum(-1)
    diag = (rc * u * kc).sum(-1)
    y = torch.einsum("bltuh,bluhk->blthk", amat, vc) + diag[..., None] * vc
    k_to_end = torch.exp(total[:, :, None] - cum) * kc
    state_in = torch.einsum("bluhk,bluhj->blhkj", k_to_end, vc)
    starts = _carry(state_in, torch.exp(total)[..., None])
    y = y + torch.einsum("blthk,blhkj->blthj", rc * torch.exp(cum_tm1), starts)
    return y.reshape(b, s, h, dk)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
        u: torch.Tensor) -> torch.Tensor:
    """r, k, v, logw (B,S,H,K) f32, u (H,K) → y (B,S,H,K) f32."""
    chunk = _largest_divisor(r.shape[1], WKV_CHUNK)
    outs = []
    for h0 in range(0, r.shape[2], WKV_HEAD_BLOCK):
        sl = slice(h0, h0 + WKV_HEAD_BLOCK)
        outs.append(_wkv_heads(r[:, :, sl], k[:, :, sl], v[:, :, sl], logw[:, :, sl], u[sl],
                               chunk))
    return torch.cat(outs, dim=2)

