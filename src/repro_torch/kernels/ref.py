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
zero state, structurally unlike the chunked kernels they check.  Beside
them the chunked forms that the reference differentiates,
``rwkv6_wkv_chunked`` (its ``models/rwkv6.py::_wkv_chunked``) and
``mamba2_ssd_chunked`` (``models/mamba2.py::_ssd_chunked``), each from an
initial state to a final one: the scan kernels' autograd Functions
recompute them for the gradient on the CPU.  The scans' gradients in the
backward kernels' formulas, ``rwkv6_wkv_bwd_ref`` and
``mamba2_ssd_bwd_ref``: the recurrence run forwards for the states and
backwards for their gradients, step by step.

The kernel wrappers use these for CPU tensors; ``chip_smoke.py`` holds
each kernel against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["NEG_INF", "flash_attention_ref", "flash_attention_lse_ref", "flash_attention_bwd_ref",
           "decode_attention_ref", "attention_mask",
           "rwkv6_recurrent", "rwkv6_wkv_ref", "rwkv6_wkv_chunked", "rwkv6_wkv_bwd_ref",
           "mamba2_ssd_ref", "mamba2_ssd_chunked", "mamba2_ssd_bwd_ref",
           "rwkv6_wkv_bwd_segments", "mamba2_ssd_bwd_segments"]

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
                         window: Optional[int] = None, lse: bool = False):
    """The decode kernel's plain version; with ``lse`` also each row's
    log-sum-exp of the allowed scaled scores (natural log, f32 (B,H),
    -inf for a row with no allowed slot), as the kernel writes it."""
    allow = attention_mask(next_pos.reshape(1), positions, True, window)
    out = _dense(q[:, None], k_cache, v_cache, allow)[:, 0]
    if not lse:
        return out
    b, h, d = q.shape
    kh = k_cache.shape[2]
    qg = q.float().reshape(b, kh, h // kh, d)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float()) * (1.0 / math.sqrt(d))
    rows = torch.logsumexp(scores.masked_fill(~allow[0], NEG_INF), dim=-1).reshape(b, h)
    return out, torch.where(allow.any(), rows, torch.full_like(rows, -math.inf))


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


def _masked_exp(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``where(keep, exp(x), 0)`` with the dropped entries zeroed before the
    exp as well as after.  The value is the reference's ``jnp.where(tri,
    jnp.exp(x), 0.0)`` bit for bit.  Its gradient is the reference's
    wherever that is finite: above the diagonal the log-decay differences
    are positive and exp overflows to inf at strong decay (zamba2's 256-row
    chunk at its initial dt·A ≈ -0.69, or logw = -25), and the reference's
    gradient there is 0·inf = NaN."""
    return torch.where(keep, torch.exp(torch.where(keep, x, 0.0)), 0.0)


def _carry(inputs: torch.Tensor, decay: torch.Tensor,
           s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunk-to-chunk carry ``s ← s·decay_c + inputs_c`` over the chunk
    axis 1, one Python step per chunk (the reference's ``lax.scan``):
    inputs (B,nc,H,X,Y), decay (B,nc,H,X,1) or (B,nc,H,1,1) → (the state
    entering each chunk (B,nc,H,X,Y), the final state)."""
    s, starts = s0, []
    for c in range(inputs.shape[1]):
        starts.append(s)
        s = s * decay[:, c] + inputs[:, c]
    return torch.stack(starts, dim=1), s


def rwkv6_wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      logw: torch.Tensor, u: torch.Tensor, chunk: int,
                      s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's chunked WKV scan (``_wkv_chunked``) in float32: r, k,
    v, logw (B,S,H,K), u (H,K), state s0 (B,H,K,K) → (y (B,S,H,K), final
    state).  Within a chunk the pairwise decays ``exp(cum[t-1] - cum[u])``
    of the strictly lower triangle (the exp after the difference); across
    chunks the state carried one chunk at a time."""
    b, s, h, dk = r.shape
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk
    rc, kc, vc, lw = (t.reshape(b, nc, chunk, h, dk) for t in (r, k, v, logw))
    cum = torch.cumsum(lw, dim=2)                                   # inclusive
    total = cum[:, :, -1]                                           # (b,nc,h,k)
    cum_tm1 = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]], dim=2)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    pair = _masked_exp(cum_tm1[:, :, :, None] - cum[:, :, None],  # (b,nc,t,u,h,k)
                       tri[:, :, None, None])
    amat = (rc[:, :, :, None] * kc[:, :, None] * pair).sum(-1)      # (b,nc,t,u,h)
    diag = (rc * u * kc).sum(-1)                                    # (b,nc,t,h)
    y_intra = torch.einsum("bltuh,bluhk->blthk", amat, vc) + diag[..., None] * vc
    k_to_end = torch.exp(total[:, :, None] - cum) * kc              # decayed to chunk end
    state_in = torch.einsum("bluhk,bluhj->blhkj", k_to_end, vc)     # (b,nc,h,k,k)
    s_starts, s_final = _carry(state_in, torch.exp(total)[..., None], s0)
    y_inter = torch.einsum("blthk,blhkj->blthj", rc * torch.exp(cum_tm1), s_starts)
    return (y_intra + y_inter).reshape(b, s, h, dk), s_final


def mamba2_ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
                       h0: Optional[torch.Tensor] = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's chunked SSD scan (``_ssd_chunked``) in float32: x
    (B,S,H,P), dt (B,S,H), a (H,), B/C (B,S,N), state h0 (B,H,P,N) or None
    for zeros → (y (B,S,H,P) without the D-skip term, final state).  Within
    a chunk the decays ``exp(cum[t] - cum[u])`` of the inclusive lower
    triangle; across chunks the state carried one chunk at a time."""
    b, s, nh, p = x.shape
    n = bmat.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by ssm_chunk {chunk}")
    nc = s // chunk
    xr = x.reshape(b, nc, chunk, nh, p)
    dtr = dt.reshape(b, nc, chunk, nh)
    br, cr = bmat.reshape(b, nc, chunk, n), cmat.reshape(b, nc, chunk, n)
    cum = torch.cumsum(dtr * a, dim=2)                              # (b,nc,l,h) inclusive
    total = cum[:, :, -1:]                                          # (b,nc,1,h)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    wmat = _masked_exp(cum[:, :, :, None] - cum[:, :, None], tri[:, :, None])  # (b,nc,t,u,h)
    scores = torch.einsum("bltn,blun->bltu", cr, br)
    gated = scores[..., None] * wmat * dtr[:, :, None]
    y_intra = torch.einsum("bltuh,bluhp->blthp", gated, xr)
    weighted = (torch.exp(total - cum) * dtr)[..., None] * xr       # (b,nc,l,h,p)
    state_in = torch.einsum("blthp,bltn->blhpn", weighted, br)       # (b,nc,h,p,n)
    if h0 is None:
        h0 = torch.zeros((b, nh, p, n), dtype=x.dtype, device=x.device)
    h_prev, h_final = _carry(state_in, torch.exp(total[:, :, 0])[..., None, None], h0.to(x.dtype))
    y_inter = torch.einsum("bltn,blhpn->blthp", cr, h_prev) * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(b, s, nh, p), h_final


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


def _reverse_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Σ_{t' >= t} x[:, t'] along axis 1."""
    return x.flip(1).cumsum(1).flip(1)


def rwkv6_wkv_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      logw: torch.Tensor, u: torch.Tensor,
                      dy: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The WKV scan's gradient from a zero state in the backward kernel's
    formulas (``csrc/rwkv6_scan_bwd.cu``), in the inputs' dtype: r, k, v,
    logw (B,S,H,K), u (H,K) and dy → (dr, dk, dv, dlogw, du).  The states
    S_t forwards give dr^s_t = S_{t-1} dy_t; D_t = ∂L/∂S_t backwards
    (D_{t-1} = diag(w_t) D_t + r_t dy_tᵀ) gives dk^s_t = D_t v_t and
    dv^s_t = D_tᵀ k_t; the bonus adds u ⊙ k (v·dy), u ⊙ r (v·dy) and
    (Σ r u k) dy; du = Σ r ⊙ k (v·dy); and dlogw_s = Σ_{t>s} r ⊙ dr^s −
    Σ_{t≥s} k ⊙ dk^s."""
    b, s, h, dk = r.shape
    w = torch.exp(logw)
    st = torch.zeros((b, h, dk, dk), dtype=r.dtype, device=r.device)
    drs = []
    for t in range(s):
        drs.append(torch.einsum("bhij,bhj->bhi", st, dy[:, t]))
        st = st * w[:, t, :, :, None] + k[:, t, :, :, None] * v[:, t, :, None, :]
    d = torch.zeros_like(st)
    dks, dvs = [None] * s, [None] * s
    for t in reversed(range(s)):
        dks[t] = torch.einsum("bhij,bhj->bhi", d, v[:, t])
        dvs[t] = torch.einsum("bhij,bhi->bhj", d, k[:, t])
        d = d * w[:, t, :, :, None] + r[:, t, :, :, None] * dy[:, t, :, None, :]
    drs, dks, dvs = (torch.stack(x, dim=1) for x in (drs, dks, dvs))
    vdy = (v * dy).sum(-1, keepdim=True)
    rdr, kdk = r * drs, k * dks
    return (drs + u * k * vdy, dks + u * r * vdy,
            dvs + (r * u * k).sum(-1, keepdim=True) * dy,
            _reverse_cumsum(rdr) - rdr - _reverse_cumsum(kdk),
            (r * k * vdy).sum((0, 1)))


def mamba2_ssd_bwd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       bmat: torch.Tensor, cmat: torch.Tensor,
                       dy: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The SSD scan's gradient from a zero state in the backward kernel's
    formulas (``csrc/mamba2_ssd_bwd.cu``), in the inputs' dtype: x
    (B,S,H,P), dt (B,S,H), a (H,), B/C (B,S,N) and dy (B,S,H,P) → (dx,
    ddt, da, dB, dC).  With z = dt·x, the states h_t forwards give y_t and
    dC_t = Σ_h dy_tᵀ h_t; G_t = ∂L/∂h_t = dy_t ⊗ C_t + α_{t+1} G_{t+1}
    backwards gives dz_t = G_t B_t and dB_t = Σ_h z_tᵀ G_t; dx = dt·dz; and
    with dl the reverse cumulative sum of ⟨dy, y⟩ − ⟨dz, z⟩ per head,
    ddt = a·dl + ⟨dz, x⟩ and da = Σ dt·dl."""
    b, s, nh, p = x.shape
    n = bmat.shape[-1]
    alpha = torch.exp(dt * a)
    z = dt[..., None] * x
    hst = torch.zeros((b, nh, p, n), dtype=x.dtype, device=x.device)
    ys, dcs = [], []
    for t in range(s):
        hst = hst * alpha[:, t, :, None, None] + z[:, t, :, :, None] * bmat[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", hst, cmat[:, t]))
        dcs.append(torch.einsum("bhpn,bhp->bn", hst, dy[:, t]))
    g = torch.zeros_like(hst)
    dzs, dbs = [None] * s, [None] * s
    for t in reversed(range(s)):
        g = g + dy[:, t, :, :, None] * cmat[:, t, None, None, :]
        dzs[t] = torch.einsum("bhpn,bn->bhp", g, bmat[:, t])
        dbs[t] = torch.einsum("bhpn,bhp->bn", g, z[:, t])
        g = g * alpha[:, t, :, None, None]
    y, dz, dbm, dcm = (torch.stack(v, dim=1) for v in (ys, dzs, dbs, dcs))
    dl = _reverse_cumsum((dy * y).sum(-1) - (dz * z).sum(-1))
    return dt[..., None] * dz, a * dl + (dz * x).sum(-1), (dt * dl).sum((0, 1)), dbm, dcm


def _segments(x: torch.Tensor, seg: int) -> torch.Tensor:
    """(B, S, ...) → (B, nseg, seg, ...), the last segment padded with zeros
    (a padded row's log-decay 0 is a decay of 1, and its inputs feed
    nothing)."""
    b, s = x.shape[:2]
    pad = -s % seg
    if pad:
        x = torch.cat([x, x.new_zeros((b, pad, *x.shape[2:]))], dim=1)
    return x.reshape(b, -1, seg, *x.shape[2:])


def _unsegment(x: torch.Tensor, s: int) -> torch.Tensor:
    """The inverse of ``_segments``: (B, nseg, seg, ...) → (B, S, ...)."""
    return x.reshape(x.shape[0], -1, *x.shape[3:])[:, :s]


def _segment_decays(lw: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Per row of each segment of the log-decays lw (B, nseg, L, ...), each
    a direct sum over the segment's rows, never a difference: the exclusive
    and inclusive prefixes from the segment's start, the exclusive suffix
    from its end, and the segment's total."""
    inc = torch.cumsum(lw, dim=2)
    exc = torch.cat([torch.zeros_like(inc[:, :, :1]), inc[:, :, :-1]], dim=2)
    suf = torch.cumsum(lw.flip(2), dim=2).flip(2)
    suf = torch.cat([suf[:, :, 1:], torch.zeros_like(suf[:, :, :1])], dim=2)
    return exc, inc, suf, inc[:, :, -1]


def _seg_carry(parts: torch.Tensor, decay: torch.Tensor, reverse: bool) -> torch.Tensor:
    """The carry across segments: parts (B, nseg, ...) each segment's
    contribution from a zero start, decay (B, nseg, ...) its total decay
    (broadcast) → the value entering each segment, forwards (reverse False:
    x_0 = 0, x_{j+1} = decay_j x_j + parts_j) or backwards (x_last = 0,
    x_{j-1} = decay_j x_j + parts_j)."""
    order = range(parts.shape[1] - 1, -1, -1) if reverse else range(parts.shape[1])
    out = [None] * parts.shape[1]
    x = torch.zeros_like(parts[:, 0])
    for j in order:
        out[j] = x
        x = decay[:, j] * x + parts[:, j]
    return torch.stack(out, dim=1)


def _later_totals(tot: torch.Tensor) -> torch.Tensor:
    """Σ_{j' > j} tot[:, j'] along the segment axis 1, summed from the last
    segment."""
    rc = torch.cumsum(tot.flip(1), dim=1).flip(1)
    return torch.cat([rc[:, 1:], torch.zeros_like(rc[:, :1])], dim=1)


def rwkv6_wkv_bwd_segments(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           logw: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
                           seg: int) -> tuple[torch.Tensor, ...]:
    """The segment form of ``rwkv6_wkv_bwd_ref``, the plain mirror of the
    backward kernel ``csrc/rwkv6_scan_bwd.cu`` with its segment length
    ``seg`` (the kernel's SEG) as an argument: → (dr, dk, dv, dlogw, du).
    The sequence is cut into segments of ``seg`` rows (the last ragged).
    Summaries of each segment from a zero start: its state
    U = Σ_t (k_t ⊙ e^{suffix_t}) v_tᵀ, its part of D entering the previous
    segment W = Σ_t (r_t ⊙ e^{prefix_t}) dy_tᵀ (suffix and prefix the
    exclusive sums of logw from the segment's end and start) and its total
    decay; the carry takes the state to each segment's start and D to
    each segment's last row; the step recurrence then runs inside every
    segment from those.  dlogw is each segment's own reverse sum plus one
    offset, the later segments' totals."""
    b, s, h, dk = r.shape
    rs, ks, vs, lws, dys = (_segments(t, seg) for t in (r, k, v, logw, dy))
    exc, _, suf, total = _segment_decays(lws)
    dec = torch.exp(total)[..., None]                                   # (b,nseg,h,k,1)
    ustate = torch.einsum("bjlhi,bjlhc->bjhic", ks * torch.exp(suf), vs)
    wgrad = torch.einsum("bjlhi,bjlhc->bjhic", rs * torch.exp(exc), dys)
    st = _seg_carry(ustate, dec, reverse=False)                         # S entering segment j
    dd = _seg_carry(wgrad, dec, reverse=True)                           # D at its last row
    w = torch.exp(lws)
    drs, dks, dvs = [None] * seg, [None] * seg, [None] * seg
    for t in range(seg):
        drs[t] = torch.einsum("bjhic,bjhc->bjhi", st, dys[:, :, t])
        st = st * w[:, :, t, :, :, None] + ks[:, :, t, :, :, None] * vs[:, :, t, :, None, :]
    for t in reversed(range(seg)):
        dks[t] = torch.einsum("bjhic,bjhc->bjhi", dd, vs[:, :, t])
        dvs[t] = torch.einsum("bjhic,bjhi->bjhc", dd, ks[:, :, t])
        dd = dd * w[:, :, t, :, :, None] + rs[:, :, t, :, :, None] * dys[:, :, t, :, None, :]
    drs, dks, dvs = (torch.stack(x, dim=2) for x in (drs, dks, dvs))  # (b,nseg,L,h,k)
    kdk = ks * dks
    term = rs * drs - kdk
    rc = torch.cumsum(term.flip(2), dim=2).flip(2)                    # Σ_{t' >= t} in segment
    after = torch.cat([rc[:, :, 1:], torch.zeros_like(rc[:, :, :1])], dim=2)
    dlogw = after - kdk + _later_totals(rc[:, :, 0])[:, :, None]
    vdy = (vs * dys).sum(-1, keepdim=True)
    grads = (drs + u * ks * vdy, dks + u * rs * vdy,
             dvs + (rs * u * ks).sum(-1, keepdim=True) * dys, dlogw)
    return (*(_unsegment(g, s) for g in grads), (rs * ks * vdy).sum((0, 1, 2)))


def mamba2_ssd_bwd_segments(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                            bmat: torch.Tensor, cmat: torch.Tensor, dy: torch.Tensor,
                            seg: int) -> tuple[torch.Tensor, ...]:
    """The segment form of ``mamba2_ssd_bwd_ref``, the plain mirror of the
    backward kernel ``csrc/mamba2_ssd_bwd.cu`` with its segment length
    ``seg`` as an argument: → (dx, ddt, da, dB, dC).  Summaries of each
    segment from a zero start: its state U = Σ_t e^{suffix_t} z_t ⊗ B_t,
    its part of G carried into the previous segment
    V = Σ_t e^{prefix_t} dy_t ⊗ C_t (suffix the exclusive sum of dt·a from
    the segment's end, prefix the inclusive one from its start) and its
    total decay; the carry; the step recurrence inside every segment, with
    ⟨dy, y⟩ = ⟨C, dC's head term⟩; dl is each segment's own reverse sum
    plus one offset, the later segments' totals."""
    b, s, nh, p = x.shape
    xs, dts, bs, cs, dys = (_segments(t, seg) for t in (x, dt, bmat, cmat, dy))
    adt = dts * a                                                       # (b,nseg,L,h)
    _, inc, suf, total = _segment_decays(adt)
    dec = torch.exp(total)[..., None, None]                             # (b,nseg,h,1,1)
    z = dts[..., None] * xs
    ustate = torch.einsum("bjlhp,bjln->bjhpn", z * torch.exp(suf)[..., None], bs)
    gcarry = torch.einsum("bjlhp,bjln->bjhpn", dys * torch.exp(inc)[..., None], cs)
    hst = _seg_carry(ustate, dec, reverse=False)                        # h entering segment j
    g = _seg_carry(gcarry, dec, reverse=True)                           # α G from the later ones
    alpha = torch.exp(adt)[..., None, None]
    dcs, dzs, dbs = [None] * seg, [None] * seg, [None] * seg
    for t in range(seg):
        hst = hst * alpha[:, :, t] + z[:, :, t, :, :, None] * bs[:, :, t, None, None, :]
        dcs[t] = torch.einsum("bjhpn,bjhp->bjhn", hst, dys[:, :, t])
    for t in reversed(range(seg)):
        g = g + dys[:, :, t, :, :, None] * cs[:, :, t, None, None, :]
        dzs[t] = torch.einsum("bjhpn,bjn->bjhp", g, bs[:, :, t])
        dbs[t] = torch.einsum("bjhpn,bjhp->bjhn", g, z[:, :, t])
        g = g * alpha[:, :, t]
    dch, dz, dbh = (torch.stack(v, dim=2) for v in (dcs, dzs, dbs))  # (b,nseg,L,h,·)
    dc = (dch * cs[:, :, :, None]).sum(-1) - (dz * z).sum(-1)
    local = torch.cumsum(dc.flip(2), dim=2).flip(2)
    dl = local + _later_totals(local[:, :, 0])[:, :, None]
    return (_unsegment(dts[..., None] * dz, s), _unsegment(a * dl + (dz * xs).sum(-1), s),
            (dts * dl).sum((0, 1, 2)), _unsegment(dbh.sum(3), s), _unsegment(dch.sum(3), s))
