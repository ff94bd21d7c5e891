"""Mixture-of-Experts with fixed-capacity grouped dispatch
(``repro/models/moe.py`` in PyTorch, same numerics).

The data-dependent quantity in MoE is *expert load*, the analogue of the
paper's proposal-count variance source.  The compute shape stays static
with capacity-``C`` dispatch tensors, and the data dependence is surfaced
as a metric (``drop_fraction``) instead of a latency term.

Tokens are reshaped to ``(G groups, tokens_per_group)``; the dispatch and
combine tensors are ``(G, t, E, C)`` with ``C = ceil(t·k/E · capacity_factor)``
rounded up to a multiple of 4.  The reference writes dispatch, expert
compute and combine as einsums; here each is a pairwise matrix product in
a fixed order (the combine never builds a ``(g, t, k, e, C)`` product).
The reference computes all of it in XLA, with no Pallas kernel, so the
port's plain torch products are its counterpart.

Tensor-parallel (``tp``, where the expert leaves are the rank's blocks over
``model``): routing stays replicated (every rank computes the same
logits, capacity and drops, so the reference's semantics hold exactly);
the tokens and the combine weights enter the split compute; the rank runs
its ``E/m`` experts (dispatch and combine over those experts only), or
every expert on its share of the hidden dim where the experts do not
divide the axis; the combined outputs are summed over ``model``.  The aux
terms come from the replicated routing: the same on every rank, counted
once.
"""
from __future__ import annotations

import math
from typing import Any, Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.tp import ModelParallel, enter, leave, split_by
from .params import ParamSpec

__all__ = ["moe_specs", "moe_block", "expert_capacity", "group_size", "route",
           "dispatch_and_combine", "Routing"]


def moe_specs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamSpec((d, e), ("embed", None), scale=0.5),
        "gate": ParamSpec((e, d, f), ("expert", "embed", "mlp")),
        "up": ParamSpec((e, d, f), ("expert", "embed", "mlp")),
        "down": ParamSpec((e, f, d), ("expert", "mlp", "embed")),
    }


def expert_capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    raw = tokens_per_group * cfg.num_experts_per_tok / cfg.num_experts
    cap = int(math.ceil(raw * cfg.capacity_factor))
    return max(4, -(-cap // 4) * 4)  # round up to a multiple of 4, ≥ 4


def group_size(t_total: int, cfg: ModelConfig) -> int:
    """Tokens per dispatch group: ``moe_group_size``, shrunk to a divisor
    of the token count (decode batches are small and arbitrary)."""
    tpg = min(cfg.moe_group_size, t_total)
    while t_total % tpg:
        tpg -= 1
    return tpg


class Routing(NamedTuple):
    logits: torch.Tensor   # (g, t, e) f32 router logits
    probs: torch.Tensor    # (g, t, e) f32 softmax
    top_w: torch.Tensor    # (g, t, k) f32, renormalised over the k choices
    top_ids: torch.Tensor  # (g, t, k) int64, descending probability
    pos: torch.Tensor      # (g, t, k) int64 slot in the expert's buffer
    keep: torch.Tensor     # (g, t, k) bool: the choice fits the capacity
    capacity: int


def route(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig) -> Routing:
    """Top-k routing of grouped tokens xt (g, t, d) with capacity taken in
    (token, choice) order within each group."""
    g, t, _ = xt.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = expert_capacity(t, cfg)
    logits = (xt @ router).float()
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: descending, ties to the lower expert index (a stable sort;
    # torch.topk promises no order among ties)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_ids = srt[..., :k], order[..., :k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # position of each (token, choice) within its expert's capacity buffer:
    # a cumsum over the flattened (t, k) axis, so later tokens drop first.
    # The hits are laid out (g, e, t·k) so the scan runs along the last
    # axis: on the H100 an int64 scan along the outer axis of (g, t·k, e)
    # took 1.0 ms a layer at olmoe's prefill (chip_smoke.py's profile).
    flat_ids = top_ids.reshape(g, 1, t * k)
    hits = (flat_ids == torch.arange(e, device=xt.device)[:, None]).to(torch.int32)
    pos = (hits.cumsum(-1, dtype=torch.int32) - 1).gather(1, flat_ids).reshape(g, t, k).long()
    keep = (pos < cap) & (top_w > 0)
    return Routing(logits, probs, top_w, top_ids, pos, keep, cap)


def dispatch_and_combine(r: Routing, e: int, dtype: torch.dtype,
                         experts: Optional[slice] = None,
                         top_w: Optional[torch.Tensor] = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (g, t, e, C) dispatch and combine tensors in ``dtype`` (over
    ``experts`` only, where given).  A dropped choice has slot index C,
    whose one-hot row is all zeros (as ``jax.nn.one_hot`` gives out of
    range); the combine weights (``top_w``, default ``r.top_w``) are
    rounded to ``dtype`` before they are placed, as in the reference."""
    cap = r.capacity
    idx = torch.where(r.keep, r.pos, cap)
    slot = (idx[..., None] == torch.arange(cap, device=idx.device)).to(dtype)   # (g,t,k,C)
    ohf = F.one_hot(r.top_ids, e)
    if experts is not None:
        ohf = ohf[..., experts]
    ohf_t = ohf.to(dtype).transpose(-1, -2)                                     # (g,t,e,k)
    w = r.top_w if top_w is None else top_w
    dispatch = ohf_t @ slot
    combine = (ohf_t * w.to(dtype)[..., None, :]) @ slot
    return dispatch, combine


def moe_block(params: Mapping[str, Any], x: torch.Tensor, cfg: ModelConfig,
              tp: Optional[ModelParallel] = None
              ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """x (B, S, d) → (B, S, d), plus aux = {load_balance_loss,
    router_z_loss, drop_fraction} (f32 scalars).  ``tp``: the expert
    leaves may be the rank's blocks (module docstring)."""
    b, s, d = x.shape
    e = cfg.num_experts
    tpg = group_size(b * s, cfg)
    g = b * s // tpg
    xt = x.reshape(g, tpg, d)
    r = route(params["router"], xt, cfg)
    cap = r.capacity
    el = params["gate"].shape[0]
    tp = split_by(tp, el, e) or split_by(tp, params["gate"].shape[-1], cfg.d_ff)
    experts = slice(tp.index * el, (tp.index + 1) * el) if tp is not None and el < e else None
    dispatch, combine = dispatch_and_combine(r, e, x.dtype, experts, enter(r.top_w, tp))
    xt = enter(xt, tp)

    # expert compute (static shapes): (el, g·C, d) rows per expert
    ex_in = dispatch.reshape(g, tpg, el * cap).transpose(1, 2) @ xt        # (g, el·C, d)
    ex_in = ex_in.reshape(g, el, cap, d).transpose(0, 1).reshape(el, g * cap, d)
    h_gate = ex_in @ params["gate"]
    h_up = ex_in @ params["up"]
    h = F.silu(h_gate.float()).to(x.dtype) * h_up
    y = (h @ params["down"]).reshape(el, g, cap, d).transpose(0, 1)         # (g, el, C, d)
    out = leave(combine.reshape(g, tpg, el * cap) @ y.reshape(g, el * cap, d), tp)  # (g, t, d)

    # aux: switch-style load-balance loss, router z-loss, drop fraction
    per_expert_frac = F.one_hot(r.top_ids, e).float().sum(2).mean(1)       # (g, e)
    per_expert_prob = r.probs.mean(1)                                        # (g, e)
    aux = {
        "load_balance_loss": e * (per_expert_frac * per_expert_prob).sum(-1).mean(),
        "router_z_loss": (torch.logsumexp(r.logits, dim=-1) ** 2).mean(),
        "drop_fraction": 1.0 - r.keep.float().mean(),
    }
    return out.reshape(b, s, d), aux
