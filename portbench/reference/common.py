"""Plain building blocks shared by the families' references: norms, rotary
tables, attention, the SwiGLU MLP, the cross-entropy and AdamW, in float32
with TF32 off, written from the published equations with plain ``torch``
operations.  Imports nothing of the program.

Every matrix product goes through ``Numerics.mm``.  The reference runs with
``Numerics()`` (float32).  Its lower-precision control, ``Numerics(fp8=True)``,
rounds both operands of every product to float8 e4m3 (a scale per row of the
activations and one per weight, as an fp8 deployment would) and multiplies
in float32: the step below bf16 that a later change could be tempted to take.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Iterator

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0


@contextmanager
def exact_f32() -> Iterator[None]:
    """float32 products without TF32, for the reference's whole run."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _fp8(x: torch.Tensor, dims: tuple) -> torch.Tensor:
    """x rounded to e4m3 with a scale per slice over ``dims`` (amax to 448);
    the gradient passes straight through."""
    amax = x.detach().abs().amax(dim=dims, keepdim=True).clamp_min(1e-30)
    scale = E4M3_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x.detach())


class Numerics:
    """How the reference multiplies: float32, or (``fp8``) the control."""

    def __init__(self, fp8: bool = False) -> None:
        self.fp8 = fp8

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., K) @ w (K, N) in float32."""
        x, w = x.float(), w.float()
        if self.fp8:
            x, w = _fp8(x, (-1,)), _fp8(w, tuple(range(w.dim())))
        return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def shift(x: torch.Tensor) -> torch.Tensor:
    """x_{t-1} along axis 1, zeros before the first position."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding on (B,S,H,D), positions 0..S-1, pairs
    (x[..., :D/2], x[..., D/2:])."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    c, sn = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn], dim=-1)


ATTN_BLOCK = 512


def _attn_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q0: int) -> torch.Tensor:
    """Causal softmax attention of query rows q0.. (q (B,H,R,D)) over k, v
    (B,H,S,D)."""
    rows = q.shape[2]
    scores = torch.einsum("bhrd,bhsd->bhrs", q, k) / math.sqrt(q.shape[-1])
    qpos = torch.arange(q0, q0 + rows, device=q.device)[:, None]
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    scores = scores.masked_fill(kpos > qpos, -torch.inf)
    return torch.einsum("bhrs,bhsd->bhrd", torch.softmax(scores, dim=-1), v)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,S,KV,D), H a multiple of KV → (B,S,H,D); query rows
    in blocks, each checkpointed under grad so that one block's scores are
    live at a time."""
    h, kv = q.shape[2], k.shape[2]
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if kv != h:
        k, v = (t.repeat_interleave(h // kv, dim=1) for t in (k, v))
    outs = []
    for q0 in range(0, q.shape[2], ATTN_BLOCK):
        qb = q[:, :, q0:q0 + ATTN_BLOCK]
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attn_rows, qb, k, v, q0, use_reentrant=False))
        else:
            outs.append(_attn_rows(qb, k, v, q0))
    return torch.cat(outs, dim=2).transpose(1, 2)


def swiglu(num: Numerics, p: dict, x: torch.Tensor) -> torch.Tensor:
    return num.mm(F.silu(num.mm(x, p["gate"])) * num.mm(x, p["up"]), p["down"])


def logits(num: Numerics, params: dict, x: torch.Tensor, eps: float, vocab: int) -> torch.Tensor:
    """The head: the final norm, then the vocabulary's rows of the table."""
    x = rmsnorm(x, params["final_ln"]["scale"], eps)
    return num.mm(x, params["lm_head"]["table"][:vocab].T)


LOSS_CHUNK = 1024


def _chunk_nll(num, head, h, t, eps, vocab):
    lg = logits(num, head, h, eps, vocab)
    return (torch.logsumexp(lg, dim=-1) - lg.gather(-1, t[..., None])[..., 0]).sum()


def next_token_ce(num: Numerics, params: dict, hidden: torch.Tensor, tokens: torch.Tensor,
                  eps: float, vocab: int) -> torch.Tensor:
    """Mean cross-entropy of each position's next token, in sequence chunks
    (each checkpointed under grad) so that the f32 logits are never all
    live."""
    h, t = hidden[:, :-1], tokens[:, 1:].long()
    head = {"final_ln": params["final_ln"], "lm_head": params["lm_head"]}
    total = hidden.new_zeros(())
    for i in range(0, h.shape[1], LOSS_CHUNK):
        args = (num, head, h[:, i:i + LOSS_CHUNK], t[:, i:i + LOSS_CHUNK], eps, vocab)
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            total = total + _chunk_nll(*args)
    return total / t.numel()


def unstack(tree: dict) -> list:
    """The layers of a layer-stacked tree, each leaf split by one ``unbind``
    (whose gradient is one ``stack``)."""
    per = {k: unstack(v) if isinstance(v, dict) else torch.unbind(v, 0) for k, v in tree.items()}
    n = len(next(iter(per.values())))
    return [{k: per[k][i] for k in per} for i in range(n)]


def leaves(tree: dict, path: tuple = ()) -> Iterator[tuple[tuple, torch.Tensor]]:
    """(key path, leaf) of a nested dict, in sorted key order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def nest(pairs) -> dict:
    """The nested dict of (key path, leaf) pairs: ``leaves``' inverse."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def decays(path: tuple, leaf: torch.Tensor) -> bool:
    """The training job's weight-decay rule: none on norm scales, the
    Mamba2 dt bias, A and skip, the RWKV bonus and token-shift mixes, or
    two-letter biases; otherwise on every leaf of more than one axis as it
    is stored (a stacked leaf counts its layer axes)."""
    no_decay = {"scale", "dt_bias", "a_log", "d_skip", "bonus_u"}
    if any(n in no_decay or n.startswith("mu_") or (n.startswith("b") and len(n) == 2)
           for n in path):
        return False
    return leaf.dim() > 1


def adamw(params: dict, grads: dict, state: dict, opt: dict, step: int,
          store_dtype: torch.dtype) -> float:
    """One AdamW step in float32 on the f32 ``params`` (updated in place),
    with a linear warm-up then a cosine decay of the rate, the gradients
    clipped by their global norm, bias-corrected moments, and decoupled
    weight decay on matrices.  The parameters are then rounded to
    ``store_dtype``, the dtype the configuration stores them in.  Returns
    the gradients' global norm."""
    lr0, b1, b2, eps = opt["lr"], opt["b1"], opt["b2"], opt["eps"]
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1),
                0.0), 1.0)
    lr = lr0 * warm * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5
                       * (1 + math.cos(math.pi * t)))
    gnorm = torch.sqrt(sum(g.double().square().sum() for _, g in leaves(grads))).item()
    clip = min(opt["grad_clip"] / max(gnorm, 1e-9), 1.0)
    for path, p in leaves(params):
        g = grads
        for key in path:
            g = g[key]
        m, v = state.setdefault(path, (torch.zeros_like(p), torch.zeros_like(p)))
        g = g * clip
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (m / (1 - b1 ** step)) / (torch.sqrt(v / (1 - b2 ** step)) + eps)
        if decays(path, p):
            delta = delta + opt["weight_decay"] * p
        p.sub_(lr * delta)
        p.copy_(p.to(store_dtype).float())
    return gnorm
