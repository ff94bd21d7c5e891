"""Plain PyTorch versions of the ported kernels (the ``ref.py`` layer).

Attention: dense masked softmax attention in float32, with the same
signatures and ``(B, S, H, D)`` / ``(B, C, K, D)`` layouts as the
reference's ``repro/kernels/ref.py``.  They follow the kernels' arithmetic: the scale
multiplies the f32 scores, masked scores are ``-1e30`` (never ``-inf``),
and the output is cast to ``q.dtype``.  (The reference's ``dense_attention``
instead folds the scale into q in q's dtype and casts the probabilities to
``v.dtype``; at bf16 the two differ by rounding, at f32 they agree.)

Attention's gradient: ``flash_attention_bwd_ref`` writes out the softmax
backward in formulas, the plain version of the backward kernel
``csrc/flash_attention_bwd.cu``; ``flash_attention_lse_ref`` is the plain
version of the rows' log-sum-exp that the forward kernel writes for it.

Scans: the step-by-step recurrences of the reference's ``rwkv6_wkv_ref``
(through ``rwkv6_recurrent``) and ``mamba2_ssd_ref``, in float32 from a
zero state, structurally unlike the chunked kernels they check.

The kernel wrappers use these for CPU tensors; ``chip_smoke.py`` holds
each kernel against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["NEG_INF", "flash_attention_ref", "flash_attention_lse_ref", "flash_attention_bwd_ref",
           "decode_attention_ref", "attention_mask",
           "rwkv6_recurrent", "rwkv6_wkv_ref", "mamba2_ssd_ref"]

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


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
                            window: Optional[int] = None) -> torch.Tensor:
    """Each row's log-sum-exp of the masked, scaled scores in the log2
    domain, the plain version of the forward kernel's ``lse`` output:
    q (B,S,H,D), k (B,S,K,D) → (B,H,S) float32 holding
    ``log2 Σ_t exp2(q·k_t · log2(e)/√D)`` over the allowed t, which is the
    natural log-sum-exp times log2(e)."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    pos = torch.arange(s, dtype=torch.int32, device=q.device)
    allow = attention_mask(pos, pos, causal, window)
    qg = q.float().reshape(b, s, kh, h // kh, d)
    scores = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) * (1.0 / math.sqrt(d))
    lse = torch.logsumexp(scores.masked_fill(~allow, NEG_INF), dim=-1)      # (B,K,G,S)
    return (lse * (1.0 / math.log(2.0))).reshape(b, h, s)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, do: torch.Tensor, causal: bool = True,
                            window: Optional[int] = None
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention_ref`` in formulas, in float32:
    q (B,S,H,D), k/v (B,S,K,D), the forward's output o and its gradient
    dO (B,S,H,D) → (dq, dk, dv) in the inputs' dtypes.  With
    ``P = softmax(mask(Q Kᵀ·scale))``: ``dV = Σ_group Pᵀ dO``,
    ``dP = dO Vᵀ``, ``dS = P ∘ (dP − rowsum(dO ∘ O))``, ``dQ = dS K·scale``,
    ``dK = Σ_group dSᵀ Q·scale``.  One KV head's group at a time, so the
    f32 (B, G, S, S) temporaries are a group's (mixtral's 8192-long
    prefill would need 13 GB for each of them over all heads)."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    pos = torch.arange(s, dtype=torch.int32, device=q.device)
    allow = attention_mask(pos, pos, causal, window)
    dqs, dks, dvs = [], [], []
    for j in range(kh):
        heads = slice(j * g, (j + 1) * g)
        qj, oj, doj = (t[:, :, heads].float() for t in (q, o, do))          # (B,S,G,D)
        kj, vj = k[:, :, j].float(), v[:, :, j].float()                      # (B,S,D)
        scores = torch.einsum("bqgd,btd->bgqt", qj, kj) * scale
        p = torch.softmax(scores.masked_fill(~allow, NEG_INF), dim=-1)
        dvs.append(torch.einsum("bgqt,bqgd->btd", p, doj))
        dp = torch.einsum("bqgd,btd->bgqt", doj, vj)
        delta = (doj * oj).sum(-1).transpose(1, 2)[..., None]               # (B,G,S,1)
        ds = p * (dp - delta)
        del scores, p, dp
        dqs.append(torch.einsum("bgqt,btd->bqgd", ds, kj) * scale)
        dks.append(torch.einsum("bgqt,bqgd->btd", ds, qj) * scale)
    dq = torch.cat(dqs, dim=2)
    dk, dv = torch.stack(dks, dim=2), torch.stack(dvs, dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(q: torch.Tensor,           # (B, H, D)
                         k_cache: torch.Tensor,     # (B, C, K, D)
                         v_cache: torch.Tensor,
                         positions: torch.Tensor,   # (C,) int32, -1 = empty
                         next_pos: torch.Tensor,    # () int32
                         window: Optional[int] = None) -> torch.Tensor:
    allow = attention_mask(next_pos.reshape(1), positions, True, window)
    return _dense(q[:, None], k_cache, v_cache, allow)[:, 0]


def rwkv6_recurrent(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    logw: torch.Tensor, u: torch.Tensor,
                    s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The RWKV6 recurrence one step at a time: r, k, v, logw (B,S,H,K), u
    (H,K), state s0 (B,H,K,K) → (y (B,S,H,K), final state).  Per step
    ``y_t = r_t · (S + diag(u) k_t v_tᵀ)``, ``S ← diag(exp(logw_t)) S + k_t v_tᵀ``."""
    s = s0
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B,H,K,K)
        ys.append(torch.einsum("bhk,bhkj->bhj", r[:, t], s + u[None, :, :, None] * kv))
        s = s * torch.exp(logw[:, t])[..., None] + kv
    return torch.stack(ys, dim=1), s


def rwkv6_wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The WKV scan from a zero state, in float32 → (B,S,H,K) float32."""
    b, _, h, dk = r.shape
    s0 = torch.zeros((b, h, dk, dk), dtype=torch.float32, device=r.device)
    y, _ = rwkv6_recurrent(r.float(), k.float(), v.float(), logw.float(), u.float(), s0)
    return y


def mamba2_ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   bmat: torch.Tensor, cmat: torch.Tensor) -> torch.Tensor:
    """The sequential SSD recurrence from a zero state, in float32:
    ``h_t = exp(dt_t a) h + dt_t x_t ⊗ B_t``, ``y_t = h_t · C_t``.
    x (B,S,H,P), dt (B,S,H), a (H,), B/C (B,S,N) → y (B,S,H,P) float32,
    without the D-skip term."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    x, dt, a, bmat, cmat = (t.float() for t in (x, dt, a, bmat, cmat))
    hst = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dec = torch.exp(dt[:, t] * a[None, :])                   # (B,H)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, t], bmat[:, t], x[:, t])
        hst = hst * dec[..., None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", cmat[:, t], hst))
    return torch.stack(ys, dim=1)
