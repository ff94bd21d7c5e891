"""AdamW and its cosine schedule on nested dicts of tensors
(``repro/train/optimizer.py`` in PyTorch).

The same arithmetic as the reference: f32 moments, the gradients clipped
by their f32 global norm, f32 bias corrections ``1 − b**step``, the update
in f32 and the result cast back to the parameter's dtype.  Unlike the
reference's pure update, ``adamw_update`` writes the parameters and the
moments in place: at qwen3-4b's width a functional update would hold a
second copy of 44 GB of weights and moments.  Each leaf is taken in
pieces of at most ``PIECE`` elements along its first axis (a layer at a
time for the stacked leaves), so the f32 temporaries stay small: a whole
``layers/mlp`` leaf of qwen3-4b is 0.9 G elements, 3.6 GB in f32.  Every
scalar (step, lr, clip, bias corrections) stays a tensor on the
parameters' device, so a step never waits on the host.

On a training mesh the same update runs on each rank's blocks of the
parameters, gradients and moments (a block keeps its leaf's rank, so
``_decay_mask`` holds); only the gradients' norm needs the other ranks:
``global_norm(grads, groups)`` all-reduces each split leaf's sum of
squares over the ranks that hold its other blocks, once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, NamedTuple

import torch
import torch.distributed as dist

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm"]

PIECE = 1 << 24     # elements of a leaf updated at once


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor        # () int32
    mu: Any                   # first moment, f32 (a tree like params)
    nu: Any                   # second moment, f32
    loss_scale: torch.Tensor  # () f32; reserved for fp16-style scaling, 1.0 for bf16


def cosine_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``lr`` over ``warmup_steps``, then a cosine decay
    to ``min_lr_ratio·lr`` at ``total_steps``; f32 on the step's device."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
        return cfg.lr * warm * frac

    return sched


def _walk(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, torch.Tensor]]:
    """(key path, leaf) of a nested dict in sorted key order (the
    reference's pytree order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield path, tree


def _pieces(t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Views of ``t`` along its first axis of at most ``PIECE`` elements
    (whole rows; a whole small leaf)."""
    if t.dim() == 0 or t.numel() <= PIECE:
        return (t,)
    row = t.numel() // t.shape[0]
    return t.split(max(1, PIECE // row), dim=0)


def global_norm(tree: Any, groups: Any = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32.

    ``groups`` (a tree like ``tree``, or None) gives for a leaf that is a
    block of a larger one the process group of the ranks holding its other
    blocks, or None for a whole leaf.  A whole leaf is counted once, as it
    is; a block's sum of squares is all-reduced over its group (one
    all-reduce per group for all its leaves), so every leaf counts once on
    every rank."""
    total = None
    split: dict[int, tuple[Any, list]] = {}
    for path, leaf in _walk(tree):
        group = None if groups is None else _leaf(groups, path)
        sums = split.setdefault(id(group), (group, []))[1] if group is not None else None
        for piece in _pieces(leaf):
            sq = piece.float().square().sum()
            if sums is not None:
                sums.append(sq)
            else:
                total = sq if total is None else total + sq
    for group, sums in split.values():
        v = torch.stack(sums)
        dist.all_reduce(v, group=group)
        total = v.sum() if total is None else total + v.sum()
    return torch.sqrt(total)


def adamw_init(params: Any) -> AdamWState:
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)

    device = next(_walk(params))[1].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), mu=zeros(params),
                      nu=zeros(params),
                      loss_scale=torch.ones((), dtype=torch.float32, device=device))


def _decay_mask(path: tuple, leaf: torch.Tensor) -> bool:
    """No weight decay on norms / biases / 1-d params (standard practice).
    The reference's predicate as written, precedence included: ``and``
    binds tighter than ``or``."""
    names = list(path)
    if any(n in ("scale", "dt_bias", "a_log", "d_skip", "bonus_u") or n.startswith("mu_") or n.startswith("b") and len(n) == 2 for n in names):  # noqa: E501
        return False
    return leaf.dim() > 1


def _leaf(tree: Any, path: tuple) -> torch.Tensor:
    for k in path:
        tree = tree[k]
    return tree


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, state: AdamWState,
                 gnorm: Any = None) -> tuple[Any, AdamWState, dict]:
    """One AdamW step: updates ``params`` and the moments of ``state`` in
    place and returns (params, the new state, {"lr", "grad_norm"}).  The
    clip takes ``gnorm`` where given (a sharded trainer's global norm of
    the gradients' blocks), else ``global_norm(grads)``."""
    step = state.step + 1
    lr = cosine_schedule(cfg)(step)
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)

    for path, p in _walk(params):
        g, m, v = _leaf(grads, path), _leaf(state.mu, path), _leaf(state.nu, path)
        wd = _decay_mask(path, p)
        for pp, gp, mp, vp in zip(_pieces(p), _pieces(g), _pieces(m), _pieces(v)):
            g32 = gp.float() * clip
            mp.copy_(cfg.b1 * mp + (1 - cfg.b1) * g32)
            vp.copy_(cfg.b2 * vp + (1 - cfg.b2) * g32 * g32)
            delta = (mp / b1c) / (torch.sqrt(vp / b2c) + cfg.eps)
            if wd:
                delta = delta + cfg.weight_decay * pp.float()
            pp.copy_(pp.float() - lr * delta)
    new_state = AdamWState(step=step, mu=state.mu, nu=state.nu, loss_scale=state.loss_scale)
    return params, new_state, {"lr": lr, "grad_norm": gnorm}
