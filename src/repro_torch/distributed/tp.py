"""Tensor-parallel compute over the ``model`` axis: what GSPMD inserts into
the reference's meshed steps (``repro/launch/lowering.py``, its ``Trainer``)
when the ruleset splits ``heads``, ``kv_heads``, ``mlp``, ``expert`` and
``vocab`` over ``model``, written out for the port's eager steps.

A ``ModelParallel`` is the ``model`` process group, this rank's index along
it and the axis size; the model (``models.Model(cfg, tp)``) computes on its
blocks of the leaves split over ``model`` and crosses between split and
replicated compute only through three autograd Functions:

- ``enter`` (forward identity, backward all-reduce over ``model``): every
  replicated tensor that enters split compute passes through it,
  activations (x before q/k/v, before gate/up and the experts; the MoE
  combine weights) and replicated leaves used on the rank's heads
  (``q_norm``/``k_norm``; ``wk``/``wv``/``bk``/``bv`` when the KV heads
  cannot split).  So every replicated leaf's gradient is whole and equal on
  every model rank, and nothing sums it over ``model`` again (which would
  multiply it by the axis size);
- ``leave`` (forward all-reduce sum, backward identity): the row-parallel
  partial sums (attention's and the MLP's output projections, the experts'
  combine, the vocab-parallel embedding lookup and cross-entropy sums);
- ``gather_last`` (forward all-gather along the last dim, backward the
  rank's slice): the vocab logits of prefill and decode, q's heads under a
  slot split, RWKV6's channel-mix gate.

``rmsnorm_split`` is the RMSNorm over a dim ``model`` splits (RWKV6's
``ln_out`` after the rank's heads, Mamba2's gated norm over its
``d_inner`` block): the rank's sum of squares summed over ``model`` both
ways (``enter(leave(.))``: each rank then normalises its own columns, so
the sum's gradient is partial on each rank too), the replicated scale
entered and cut to the rank's columns.

Sums over ``model`` are taken in f32 (cast up, all-reduce, cast back), so
a bf16 partial is rounded once more than a product over the whole K, not
once per addition.  ``merge_partials`` joins partial decode attentions
over slot ranges by their rows' log-sum-exp.  Every collective goes
through ``layout.all_gather_flat`` or ``dist.all_reduce``, looked up on
the module at call time inside a ``collective:<op>`` profiler range, so
``launch.lowering.record_collectives`` sees them.

``split_spec`` divides a leaf's spec into the part the layer computes on
(the TP axes mapped to ``model``: the leaf stays a block along them) and
the rest (the data axes under FSDP: gathered unit by unit by the feed,
``distributed/fsdp.py``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

from . import layout

__all__ = ["ModelParallel", "TP_AXES", "split_by", "enter", "leave", "gather_last",
           "rmsnorm_split", "merge_partials", "split_spec"]

# the logical axes a layer computes on in blocks when the ruleset maps them
# onto `model`
TP_AXES = ("heads", "kv_heads", "mlp", "expert", "vocab")


class ModelParallel:
    """The ``model`` axis of a training mesh: its process group (None on a
    mesh of one, or a stand-in the lowering's recorder names), this rank's
    index along it and its size."""

    def __init__(self, group, index: int, size: int) -> None:
        self.group, self.index, self.size = group, int(index), int(size)

    @classmethod
    def of(cls, mesh) -> Optional["ModelParallel"]:
        """The ``model`` axis of ``mesh`` (a ``TrainMesh``), or None where
        it holds one rank."""
        size = mesh.shape.get("model", 1)
        if size == 1:
            return None
        return cls(mesh.group("model"), mesh.index("model"), size)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` summed (or maxed) over the axis, in f32, cast back to its
        dtype; ``x`` itself is not written."""
        y = x.to(torch.float32, copy=True)
        red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        with record_function("collective:all_reduce"):
            dist.all_reduce(y, op=red, group=self.group)
        return y.to(x.dtype)

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` side by side along the last dim, in rank
        order."""
        flat = x.contiguous().reshape(-1)
        out = torch.empty(self.size * flat.numel(), dtype=x.dtype, device=x.device)
        with record_function("collective:all_gather"):
            layout.all_gather_flat(out, flat, self.group)
        parts = out.reshape(self.size, *x.shape).movedim(0, -2)
        return parts.reshape(*x.shape[:-1], self.size * x.shape[-1])

    def __repr__(self) -> str:
        return f"ModelParallel(index={self.index}, size={self.size})"


def active(tp: Optional[ModelParallel]) -> bool:
    return tp is not None and tp.size > 1


def split_by(tp: Optional[ModelParallel], local: int, full: int) -> Optional[ModelParallel]:
    """``tp`` where a dim of ``full`` is held as this rank's ``local``
    share, None where it is whole (raises where it is neither)."""
    if not active(tp) or local == full:
        return None
    if local * tp.size != full:
        raise ValueError(f"a dim of {full} held as {local} on a model axis of {tp.size}")
    return tp


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, x.shape[-1]
        return tp.all_gather_last(x)

    @staticmethod
    def backward(ctx, g):
        i = ctx.tp.index * ctx.n
        return g[..., i:i + ctx.n].contiguous(), None


def enter(x: torch.Tensor, tp: Optional[ModelParallel]) -> torch.Tensor:
    """A replicated tensor entering split compute (identity without a
    model axis)."""
    return _Enter.apply(x, tp) if active(tp) else x


def leave(x: torch.Tensor, tp: Optional[ModelParallel]) -> torch.Tensor:
    """The sum over the model ranks of their partial ``x``."""
    return _Leave.apply(x, tp) if active(tp) else x


def gather_last(x: torch.Tensor, tp: Optional[ModelParallel]) -> torch.Tensor:
    """The ranks' ``x`` joined along the last dim."""
    return _GatherLast.apply(x, tp) if active(tp) else x


def rmsnorm_split(scale: torch.Tensor, y: torch.Tensor, eps: float, tp: ModelParallel,
                  full_dim: int) -> torch.Tensor:
    """``models.layers.rmsnorm`` over a last dim of ``full_dim`` of which
    ``y`` holds this rank's contiguous block: f32 math, the mean of
    squares over the whole dim, ``rsqrt(var + eps)``, the replicated
    ``scale`` (``full_dim``,) on the block's columns, cast back to ``y``'s
    dtype."""
    y32 = y.float()
    ss = enter(leave((y32 * y32).sum(-1, keepdim=True), tp), tp)
    n = y.shape[-1]
    sc = enter(scale, tp)[tp.index * n:(tp.index + 1) * n]
    return (y32 * torch.rsqrt(ss / full_dim + eps) * sc.float()).to(y.dtype)


def merge_partials(out: torch.Tensor, lse: torch.Tensor,
                   reduce: Callable[[torch.Tensor, str], torch.Tensor]) -> torch.Tensor:
    """Attention over the whole cache from each rank's attention over its
    slot range: ``out`` (B,H,D) and its rows' log-sum-exp ``lse`` (B,H)
    f32, ``reduce(t, "max" | "sum")`` the reduction over the ranks.  Each
    rank's weight is ``exp(lse - max lse)``; a rank with no allowed slot
    (lse = -inf) weighs 0, and so does every rank where none has one."""
    m = reduce(lse, "max")
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    w = torch.exp(lse - m)[..., None]
    s = reduce(torch.cat([out.float() * w, w], dim=-1), "sum")
    num, den = s[..., :-1], s[..., -1:]
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0).to(out.dtype)


def split_spec(axes: tuple, spec: tuple, mesh) -> tuple[tuple, tuple]:
    """(``keep``, ``rest``) of a leaf with logical ``axes`` under ``spec``:
    ``keep`` the dims a TP axis splits over ``model`` alone (the layer
    computes on the block), ``rest`` every other split (gathered by the
    FSDP feed).  A TP axis split over ``model`` together with another axis
    raises."""
    keep, rest = [], []
    for a, e in zip(axes, spec):
        names = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        if a in TP_AXES and "model" in names and mesh.shape.get("model", 1) > 1:
            if names != ("model",):
                raise ValueError(f"logical axis {a!r} split over {names}: tensor-parallel "
                                 f"compute takes it over 'model' alone")
            keep.append("model")
            rest.append(None)
        else:
            keep.append(None)
            rest.append(e)
    return tuple(keep), tuple(rest)
