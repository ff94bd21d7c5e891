"""Plain PyTorch versions of the ported kernels (the ``ref.py`` layer).

Dense masked softmax attention in float32, with the same signatures and
``(B, S, H, D)`` / ``(B, C, K, D)`` layouts as the reference's
``repro/kernels/ref.py``.  They follow the kernels' arithmetic: the scale
multiplies the f32 scores, masked scores are ``-1e30`` (never ``-inf``),
and the output is cast to ``q.dtype``.  (The reference's ``dense_attention``
instead folds the scale into q in q's dtype and casts the probabilities to
``v.dtype``; at bf16 the two differ by rounding, at f32 they agree.)

The kernel wrappers use these for CPU tensors; ``chip_smoke.py`` holds
each kernel against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["NEG_INF", "flash_attention_ref", "decode_attention_ref", "attention_mask"]

NEG_INF = -1e30


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                   window: Optional[int]) -> torch.Tensor:
    """(q, k) boolean allow-mask from position vectors; a negative k
    position marks an unwritten cache slot."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    allow = kp >= 0
    if causal:
        allow = allow & (kp <= qp)
    if window is not None:
        allow = allow & (kp > qp - window)
    return allow


def _dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           allow: torch.Tensor) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,T,K,D), allow (S,T) → (B,S,H,D) in q.dtype.
    Grouped-query: KV is never repeated to H heads."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    qg = q.float().reshape(b, s, kh, h // kh, d)
    scores = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) * (1.0 / math.sqrt(d))
    scores = scores.masked_fill(~allow, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    s = q.shape[1]
    pos = torch.arange(s, dtype=torch.int32, device=q.device)
    return _dense(q, k, v, attention_mask(pos, pos, causal, window))


def decode_attention_ref(q: torch.Tensor,           # (B, H, D)
                         k_cache: torch.Tensor,     # (B, C, K, D)
                         v_cache: torch.Tensor,
                         positions: torch.Tensor,   # (C,) int32, -1 = empty
                         next_pos: torch.Tensor,    # () int32
                         window: Optional[int] = None) -> torch.Tensor:
    allow = attention_mask(next_pos.reshape(1), positions, True, window)
    return _dense(q[:, None], k_cache, v_cache, allow)[:, 0]
