"""Plain reference of the ``ssm`` family: RWKV-6 "Finch" [arXiv:2404.05892]
as the program runs it, in float32 with plain ``torch``.

Per layer, pre-norm time mix then pre-norm channel mix, each with its
residual.  Time mix on the normed x, with static token-shift mixes
``x + mu ⊙ (x_{t-1} − x)``: r, k, v on (d → H × K) projections, the
decay ``log w = −softplus(w_base + tanh(x_w A) B)`` (a rank-64 LoRA), the
WKV scan from a zero state with the bonus u, an RMSNorm over all of d
(the program's simplification of the per-head group norm), the SiLU gate
and the output projection.  Channel mix: ``sigmoid(x_r W_r) ⊙
(relu(x_k W_k)² W_v)``.  The head is an RMSNorm and the table's rows.

Departures from the published model that the program shares: static
token-shift mixes (no data-dependent LoRA on them) and the norm after the
scan over d rather than per head.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import scans
from .common import Numerics, logits, next_token_ce, rmsnorm, shift, unstack

DECAY_LORA = 64


def layout(cfg: dict) -> dict:
    """Each weight's shape (a layer axis first for the stacked ones) and how
    the benchmark draws it (``weights.INITS``): N(0, 1/fan_in), the
    projections that write into the residual stream 1/sqrt(2 · layers)
    smaller, as GPT-2's and Mamba's inits scale them."""
    d, h, f, n = cfg["d_model"], cfg["num_heads"], cfg["d_ff"], cfg["num_layers"]
    dk = d // h
    v = -(-cfg["vocab_size"] // cfg["vocab_pad_to"]) * cfg["vocab_pad_to"]
    mix = ((n, d), ("uniform", 0.0, 1.0))
    depth = 2 * n          # residual additions: outputs drawn 1/sqrt(depth) smaller
    return {
        "embed": {"table": ((v, d), ("std", 0.02))},
        "final_ln": {"scale": ((d,), ("ones",))},
        "lm_head": {"table": ((v, d), ("normal", d))},
        "layers": {
            "ln1": {"scale": ((n, d), ("ones",))},
            "ln2": {"scale": ((n, d), ("ones",))},
            "time": {
                "mu_r": mix, "mu_k": mix, "mu_v": mix, "mu_g": mix, "mu_w": mix,
                "wr": ((n, d, h, dk), ("normal", d)),
                "wk": ((n, d, h, dk), ("normal", d)),
                "wv": ((n, d, h, dk), ("normal", d)),
                "wg": ((n, d, d), ("normal", d)),
                "w_base": ((n, h, dk), ("uniform", -6.0, -1.0)),
                "w_lora_a": ((n, d, DECAY_LORA), ("normal", d)),
                "w_lora_b": ((n, DECAY_LORA, h, dk), ("normal", DECAY_LORA)),
                "bonus_u": ((n, h, dk), ("std", 0.5)),
                "ln_out": {"scale": ((n, d), ("ones",))},
                "wo": ((n, d, d), ("normal", d * depth)),
            },
            "channel": {
                "mu_k": mix, "mu_r": mix,
                "wk": ((n, d, f), ("normal", d)),
                "wv": ((n, f, d), ("normal", f * depth)),
                "wr": ((n, d, d), ("normal", d)),
            },
        },
    }


def _mix(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + mu.float() * (shift(x) - x)


def _layer(num: Numerics, eps: float, p: dict, x: torch.Tensor) -> torch.Tensor:
    b, s, d = x.shape
    t, c = p["time"], p["channel"]
    h, dk = t["wr"].shape[1:]
    xn = rmsnorm(x, p["ln1"]["scale"], eps)
    r, k, v = (num.mm(_mix(xn, t[f"mu_{n}"]), t[f"w{n}"].reshape(d, h * dk)).reshape(b, s, h, dk)
               for n in ("r", "k", "v"))
    lora = torch.tanh(num.mm(_mix(xn, t["mu_w"]), t["w_lora_a"]))
    logw = -F.softplus(t["w_base"].float()
                       + num.mm(lora, t["w_lora_b"].reshape(DECAY_LORA, h * dk)).reshape(b, s, h, dk))
    y = scans.wkv(r, k, v, logw, t["bonus_u"].float()).reshape(b, s, d)
    y = rmsnorm(y, t["ln_out"]["scale"], eps)
    y = y * F.silu(num.mm(_mix(xn, t["mu_g"]), t["wg"]))
    x = x + num.mm(y, t["wo"])
    xn = rmsnorm(x, p["ln2"]["scale"], eps)
    kk = torch.relu(num.mm(_mix(xn, c["mu_k"]), c["wk"])).square()
    rr = torch.sigmoid(num.mm(_mix(xn, c["mu_r"]), c["wr"]))
    return x + rr * num.mm(kk, c["wv"])


def hidden(num: Numerics, params: dict, tokens: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The hidden states (B,S,d) before the head; each layer checkpointed
    under grad."""
    x = params["embed"]["table"][tokens.long()].float()
    for lp in unstack(params["layers"]):
        if torch.is_grad_enabled():
            x = checkpoint(_layer, num, cfg["norm_eps"], lp, x, use_reentrant=False)
        else:
            x = _layer(num, cfg["norm_eps"], lp, x)
    return x


def last_logits(num: Numerics, params: dict, tokens: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The next-token logits at the last position (B, vocab)."""
    x = hidden(num, params, tokens, cfg)[:, -1:]
    return logits(num, params, x, cfg["norm_eps"], cfg["vocab_size"])[:, 0]


def loss(num: Numerics, params: dict, tokens: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Mean next-token cross-entropy over the batch."""
    return next_token_ce(num, params, hidden(num, params, tokens, cfg), tokens,
                         cfg["norm_eps"], cfg["vocab_size"])
