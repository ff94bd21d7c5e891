"""FSDP as the reference's meshed steps run it: each *unit* of the model
gathered over the data axes where it is used, one unit ahead, and each
unit's gradient reduced to the rank's blocks as soon as the backward has
made it.

The reference shards ``embed`` over the data axes (``default_rules(...,
fsdp=True)``), jits its steps on the blocks and runs the layers as a
``lax.scan`` over the stacked weights; XLA places each layer's all-gather
inside the scan body and its reduce-scatter inside the backward scan, so a
step never holds a stacked leaf gathered whole or a whole-model gradient.
The port's eager steps do the same through a ``Feed`` that the model draws
its leaves from (``Model(cfg, tp, feed)``).  The units, in the order a step
uses them (``unit_order``):

- ``"embed"``: the token table, or the audio family's ``frontend_proj``;
- ``"projector"``: the VLM's patch projector (prefill and training);
- ``"shared"``: Zamba2's shared block, used at every site: gathered once a
  step and held to its end; in training its gradient is the sum over the
  sites, reduced once;
- ``0 … n-1``: index ``i`` of ``params["layers"]`` (a layer, or a Zamba2
  site of ``attn_every`` Mamba2 layers).  The layer axis is never split,
  so a unit is the slice ``[i]`` of each stacked block;
- ``"head"``: ``final_ln`` and ``lm_head``.

**Forward** (``take``): taking unit ``k`` frees the unit before it (not a
held one), waits for ``k``'s gather and issues ``k+1``'s asynchronously
(one all-gather of its leaves side by side, ``async_op=True``, gloo and
NCCL), so at most two units are gathered at once, besides the shared
block.  **Backward** (training): each unit's
leaves are the outputs of an ``autograd.Function`` (``_Gathered``) whose
backward reduces their gradient with ``layout.reduce_grads`` (in f32: one
reduce-scatter over the data axes for the leaves split over them, one
all-reduce for the others) into a preallocated
block-gradient buffer of the rank: each leaf's buffer in its dtype, or in
f32 where microbatches accumulate; no stacked gradient is ever made at the
gathered shape.  A unit is gathered again in the backward where its
leaves are needed: under remat, by the recompute of its checkpointed body
(as the reference's ``jax.checkpoint`` body gathers again); without it,
by the first saved tensor of the unit that autograd unpacks (the unit's
compute runs under ``saved_tensors_hooks`` that save a gathered leaf as a
handle, not as the tensor).  Either gather issues the gather of the stack
unit before it, so the backward prefetches one unit in its order too; the
first, the last stack unit's, is issued as the backward starts, and runs
under the head's backward.  The head is held from its forward use through
its backward (the cross-entropy's checkpointed chunks take it as an
input); the embedding table is not needed by its backward and is not
gathered again.

**The gauge.**  ``Schedule`` is the bookkeeping of those rules on unit
names: which units are live, what is gathered, freed and reduced when.
The feed is a ``Schedule`` whose hooks move tensors; ``plan`` replays the
same ``Schedule`` over the order a step takes the units (forward in
order, backward in reverse, as autograd runs the ``_Gathered`` nodes), so
the dry-run's bytes (``launch.lowering.build_lowered``) and the feed's
cannot disagree unless the step departs from its plan — which the
tests hold.  It counts, per unit, ``gathered`` (the bytes its gathers
make: its leaves split over the data axes, at the shape the model takes
them) and ``grad`` (the bytes of its gradient while it is reduced: as
autograd hands it over, in the leaves' dtype, and its f32 copy); ``high``
is the most gathered bytes live at once, ``high_total`` the most with the
gradients being reduced; ``gathers`` and ``reductions`` count per unit,
for the step just run (``reset``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import layout

__all__ = ["Leaf", "Unit", "units_of", "unit_order", "Schedule", "Feed", "plan"]

# the leaves outside the stack, by the unit that gathers them
TABLES = {"embed": "embed", "frontend_proj": "embed", "projector": "projector",
          "shared_attn": "shared", "final_ln": "head", "lm_head": "head"}
# held from their first take to the end of the step (the head is the last
# unit: nothing frees it before its backward or the step's end)
HELD = ("shared",)
# the tables a backward gathers again (the projector's second product saves
# its weight; the token lookup and the frame projection save none)
REGATHERED = ("projector",)


class Leaf(NamedTuple):
    """A leaf of a unit: its key path in the parameter tree, its position
    in the sorted-key walk (the step's block and buffer lists), the
    splits its gather undoes and its shape as the model takes it (for a
    stacked leaf, one unit's slice)."""
    path: tuple
    index: int
    rest: tuple
    shape: tuple


class Unit(NamedTuple):
    name: Any                      # a stack index, or a table's name
    leaves: tuple
    gathered: int                  # bytes its gathers make
    grad: int                      # bytes of its gradient while reduced
    stack: bool


def _gathers(leaf: Leaf, mesh) -> bool:
    return bool(layout.split_axes(leaf.rest, mesh))


def units_of(items: list, mesh, itemsize: int) -> dict:
    """The units of a meshed step, by name, from ``MeshedLayout.items``
    (path, spec, rest, local shape) in sorted-key order; ``itemsize`` is
    the parameters' element size."""
    by: dict = {}
    for j, (path, _, rest, shape) in enumerate(items):
        if path[0] == "layers":
            for i in range(shape[0]):
                by.setdefault(i, []).append(Leaf(path, j, tuple(rest[1:]), tuple(shape[1:])))
        else:
            by.setdefault(TABLES[path[0]], []).append(Leaf(path, j, tuple(rest), tuple(shape)))
    out = {}
    for name, leaves in by.items():
        n = [math.prod(lf.shape) for lf in leaves]
        out[name] = Unit(name, tuple(leaves),
                         sum(k * itemsize for k, lf in zip(n, leaves) if _gathers(lf, mesh)),
                         sum(k * (itemsize + 4) for k in n), isinstance(name, int))
    return out


def unit_order(cfg, n_stack: int, kind: str) -> list:
    """The order a step takes its units: ``kind`` is ``train``, ``prefill``
    or ``decode`` (the VLM decodes text only)."""
    order: list = ["embed"]
    if cfg.family == "vlm" and kind != "decode":
        order.append("projector")
    if cfg.family == "hybrid":
        order.append("shared")
    return order + list(range(n_stack)) + ["head"]


class Schedule:
    """The feed's bookkeeping (module docstring), on unit names; the
    tensor work is in the hooks ``_start``, ``_ready`` and ``_reduce``,
    which a ``Feed`` fills in (a live unit's entry holds its gathered
    leaves: releasing it frees them)."""

    def __init__(self, units: dict, order: list) -> None:
        self.units, self.order = units, order
        self.stack = [n for n in order if units[n].stack]
        self.reset()
        self._begin()

    def reset(self) -> None:
        """Zero the counters for a new step (microbatches add up)."""
        self.high = self.high_total = 0
        self.gathers = dict.fromkeys(self.order, 0)
        self.reductions = dict.fromkeys(self.order, 0)

    def _begin(self) -> None:
        self.live: dict = {}
        self.ready: set = set()
        self.reduced: list = []
        self.params = self.grads = 0
        self.pos = 0
        self.backward_phase = False

    # ---- tensor hooks (none in a plan)
    def _start(self, unit: Unit) -> Any:
        return True

    def _ready(self, unit: Unit) -> Any:
        return None

    def _reduce(self, unit: Unit, grads) -> None:
        pass

    # ---- the rules
    def _mark(self) -> None:
        self.high = max(self.high, self.params)
        self.high_total = max(self.high_total, self.params + self.grads)

    def _gather(self, name) -> None:
        unit = self.units[name]
        if name in self.live or not unit.gathered:
            return
        self.live[name] = self._start(unit)
        self.params += unit.gathered
        self.gathers[name] += 1
        self._mark()

    def _release(self, name) -> None:
        if self.live.pop(name, None) is not None:
            self.params -= self.units[name].gathered
        self.ready.discard(name)

    def _leaves(self, name) -> Any:
        self.ready.add(name)
        return self._ready(self.units[name])

    def take(self, name) -> Any:
        """The unit's leaves where the model uses them: in the forward, in
        ``order``; in the backward, a recompute's gather (``regather``)."""
        if self.backward_phase:
            return self.regather(name)
        if self.pos >= len(self.order) or self.order[self.pos] != name:
            raise RuntimeError(f"fsdp: the step took unit {name!r} where its order "
                               f"{self.order} has {self.order[self.pos:self.pos + 1]}")
        if self.pos and self.order[self.pos - 1] not in HELD:
            self._release(self.order[self.pos - 1])
        self._gather(name)
        leaves = self._leaves(name)
        if self.pos + 1 < len(self.order):
            self._gather(self.order[self.pos + 1])
        self.pos += 1
        return leaves

    def backward(self) -> None:
        """The backward begins: prefetch the last stack unit."""
        self.backward_phase = True
        if self.stack:
            self._gather(self.stack[-1])

    def regather(self, name) -> Any:
        """The unit's leaves in the backward; its first gather there
        issues the previous stack unit's."""
        first = name not in self.ready
        self._gather(name)
        leaves = self._leaves(name)
        if first and self.units[name].stack:
            k = self.stack.index(name)
            if k:
                self._gather(self.stack[k - 1])
        return leaves

    def reduce(self, name, grads=None) -> None:
        """The unit's gradient is complete: free its leaves and reduce it."""
        self._release(name)
        unit = self.units[name]
        self.grads += unit.grad
        self._mark()
        self._reduce(unit, grads)
        self.grads -= unit.grad
        self.reductions[name] += 1
        self.reduced.append(name)

    def end(self, grad: bool) -> None:
        """The step is over: free what is live; a train step must have
        reduced every unit once, in the reverse of its order."""
        for name in list(self.live):
            self._release(name)
        if grad and self.reduced != self.order[::-1]:
            raise RuntimeError(f"fsdp: the backward reduced {self.reduced}, expected "
                               f"{self.order[::-1]}")
        self._begin()

    def summary(self) -> dict:
        """The counters of the step just run."""
        return {"high": self.high, "high_total": self.high_total,
                "gathers": dict(self.gathers), "reductions": dict(self.reductions)}


def plan(units: dict, order: list, grad: bool, micro: int = 1) -> Schedule:
    """The ``Schedule`` of a step that takes ``order`` (``micro`` times,
    with the backward where ``grad``), as the feed runs it."""
    s = Schedule(units, order)
    for _ in range(micro):
        for name in order:
            s.take(name)
        if grad:
            s.backward()
            for name in order[::-1]:
                if units[name].stack or name in REGATHERED:
                    s.regather(name)
                s.reduce(name)
        s.end(grad)
    return s


class _Saved:
    """A gathered leaf saved for the backward, as its place in its unit."""
    __slots__ = ("j", "size", "stride", "offset")

    def __init__(self, j: int, t: torch.Tensor) -> None:
        self.j = j
        self.size, self.stride, self.offset = t.size(), t.stride(), t.storage_offset()


def _root(t: torch.Tensor) -> torch.Tensor:
    return t._base if t._base is not None else t


class _Gathered(torch.autograd.Function):
    """A unit's leaves (forward: the feed's ``take``); backward: the
    feed reduces their gradient into its buffers."""

    @staticmethod
    def forward(ctx, anchor, feed, name):
        ctx.feed, ctx.name = feed, name
        return tuple(feed.take(name))

    @staticmethod
    def backward(ctx, *grads):
        ctx.feed.reduce(ctx.name, grads)
        return ctx.feed.anchor.new_zeros(()), None, None


class Feed(Schedule):
    """The feed of one meshed step function (``kind`` ``train``,
    ``prefill`` or ``decode``) on ``lay`` (a ``train.loop.MeshedLayout``):
    ``step(params, ...)`` binds the rank's blocks for one step (one
    microbatch), ``run`` and ``tree`` give the model its units, and in
    training ``backward`` starts the backward, whose ``_Gathered`` nodes
    reduce into ``grads``.  ``anchor`` is the one tensor that every
    unit's node hangs from: the step asks autograd for its gradient."""

    def __init__(self, lay, mesh, cfg, kind: str, data_axes: tuple = ()) -> None:
        self.mesh, self.data_axes = mesh, tuple(data_axes)
        itemsize = torch.empty((), dtype=getattr(torch, cfg.param_dtype)).element_size()
        units = units_of(lay.items, mesh, itemsize)
        n = max([u for u in units if isinstance(u, int)], default=-1) + 1
        super().__init__(units, unit_order(cfg, n, kind))
        self.blocks = self.bufs = self.anchor = None
        self.accumulate = False

    @classmethod
    def of(cls, lay, mesh, cfg, kind: str, data_axes: tuple = ()) -> Optional["Feed"]:
        """The feed of the step, or None where it runs without one: a
        train step has one wherever its gradients reduce over data ranks,
        prefill and decode wherever a unit is split over them."""
        feed = cls(lay, mesh, cfg, kind, data_axes)
        if kind == "train":
            need = mesh.axis_size(feed.data_axes) > 1
        else:
            need = any(u.gathered for u in feed.units.values())
        return feed if need else None

    @contextlib.contextmanager
    def step(self, params: dict, grads: Optional[list] = None, accumulate: bool = False):
        """Bind the rank's blocks (``params``) for one step or microbatch;
        in training ``grads`` are the block-gradient buffers, one a leaf
        in sorted-key order (added to where ``accumulate``)."""
        self.blocks = [p.detach() for p in _sorted_leaves(params)]
        self.bufs, self.accumulate = grads, accumulate
        dev = self.blocks[0].device
        self.anchor = torch.zeros((), device=dev, requires_grad=True) if grads is not None \
            else None
        try:
            yield self
            self.end(grads is not None)
        finally:
            self._begin()
            self.blocks = self.bufs = self.anchor = None

    # ---- tensor hooks
    def _block(self, unit: Unit, leaf: Leaf) -> torch.Tensor:
        b = self.blocks[leaf.index]
        return b[unit.name] if unit.stack else b

    def _start(self, unit: Unit) -> list:
        """One asynchronous all-gather for the unit's leaves split over the
        same axes (in practice all its split leaves)."""
        groups: dict = {}
        for j, lf in enumerate(unit.leaves):
            if _gathers(lf, self.mesh):
                groups.setdefault(layout.split_axes(lf.rest, self.mesh), []).append(j)
        return [(js, layout.gather_start([self._block(unit, unit.leaves[j]) for j in js],
                                         [unit.leaves[j].rest for j in js],
                                         [unit.leaves[j].shape for j in js], self.mesh,
                                         async_op=True))
                for js in groups.values()]

    def _ready(self, unit: Unit) -> list:
        entry = self.live.get(unit.name)
        if entry is None:
            return [self._block(unit, lf) for lf in unit.leaves]
        if isinstance(entry, list):
            got = {}
            for js, wait in entry:
                got.update(zip(js, wait()))
            entry = tuple(got.get(j) for j in range(len(unit.leaves)))
            self.live[unit.name] = entry
        return [t if t is not None else self._block(unit, lf)
                for t, lf in zip(entry, unit.leaves)]

    def _reduce(self, unit: Unit, grads) -> None:
        if grads is None:
            return
        if self.accumulate:
            grads = [g.float() for g in grads]
        blocks = layout.reduce_grads(list(grads), [lf.rest for lf in unit.leaves], self.mesh,
                                     self.data_axes)
        for lf, blk in zip(unit.leaves, blocks):
            buf = self.bufs[lf.index]
            buf = buf[unit.name] if unit.stack else buf
            if self.accumulate:
                buf.add_(blk)
            else:
                buf.copy_(blk)

    # ---- the model's side
    def tree(self, name, leaves) -> dict:
        """The unit's leaves as the model's dict: a layer's (its keys under
        ``layers``) or the tables' top-level keys."""
        out: dict = {}
        for lf, t in zip(self.units[name].leaves, leaves):
            node = out
            path = lf.path[1:] if self.units[name].stack else lf.path
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
        return out

    def _gathered(self, name) -> list:
        """The unit's leaves in its order; in training, under grad, the
        outputs of its ``_Gathered`` node."""
        if self.anchor is None or not torch.is_grad_enabled():
            return self.take(name)
        return list(_Gathered.apply(self.anchor, self, name))

    def leaves(self, name) -> dict:
        """The unit's leaves as the model's dict (``tree``)."""
        return self.tree(name, self._gathered(name))

    def run(self, name, fn: Callable, *args, remat: bool = False):
        """``fn(the unit's leaves, *args)``.  In training a stack unit runs
        checkpointed under ``remat``; else the unit's compute saves its
        gathered leaves as handles, which the backward gathers again."""
        if self.anchor is None or not torch.is_grad_enabled():
            return fn(self.leaves(name), *args)
        if remat and self.units[name].stack:
            return checkpoint(lambda *a: fn(self.leaves(name), *a), *args,
                              use_reentrant=False)
        ts = self._gathered(name)
        roots = {id(_root(t)): j for j, (lf, t) in enumerate(zip(self.units[name].leaves, ts))
                 if _gathers(lf, self.mesh)}

        def pack(t):
            j = roots.get(id(_root(t)))
            return t if j is None else _Saved(j, t)

        def unpack(h):
            if not isinstance(h, _Saved):
                return h
            t = self.regather(name)[h.j]
            return _root(t).as_strided(h.size, h.stride, h.offset)

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            return fn(self.tree(name, ts), *args)


def _sorted_leaves(tree: dict) -> list:
    """The tensors of a nested dict in sorted-key order (the order of
    ``MeshedLayout.items``)."""
    return [t for k in sorted(tree)
            for t in (_sorted_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]
