"""Shared lowering utilities for the dry-run and the roofline: the step
the port runs for one (arch × input shape) on one rank of a mesh, built on
fake tensors, never allocated and never run.

``build_lowered`` lays the parameters out by the sharding rules
(``default_rules``, FSDP by ``auto_policies``) on a ``LogicalMesh`` seen
from rank 0 (``rank_view``: no process group, so 256 or 512 ranks cost
nothing) and returns the step with its arguments as meta tensors at one
rank's shapes (``layout.block_shape`` of each leaf; the rank's rows of
the batch).  It counts **the step the port runs**, not the step GSPMD
would run:

* ``train_step`` — the meshed ``Trainer``'s step
  (``train.loop.make_sharded_train_step``): every leaf gathered to full,
  ``Model.loss`` and its gradient on the rank's rows (``grad_accum``
  microbatches), the gradients reduced to the rank's blocks, AdamW on the
  blocks.  The ``model`` axis splits storage only, so the ranks of a data
  row repeat the same compute (tensor-parallel compute is ROADMAP Queue 1
  step 8b);
* ``prefill_step`` / ``serve_step`` — the port has no meshed serving step,
  so the same rule: every leaf gathered to full, then ``Model.prefill``
  (next-token logits) or one ``Model.decode_step`` on the rank's rows of
  the batch and of the decode state.

Collectives are not issued: while a step is counted, ``layout``'s
``all_gather_flat``/``reduce_scatter_flat`` and ``dist.all_reduce`` are
replaced by recorders (``record_collectives``), which give the table of
the collectives one step issues per rank, with their result bytes (the
reference's convention for its HLO table): ``collective_table``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.cert.costs import Counts, count_program
from repro_torch.configs import SHAPES, InputShape, get_config, input_specs, shape_applicability
from repro_torch.distributed import layout
from repro_torch.distributed.mesh import LogicalMesh, TrainMesh
from repro_torch.distributed.sharding import (Ruleset, _data_or_replicated, axis_size,
                                              default_rules, shard_params_spec)
from repro_torch.models import Model
from repro_torch.models.params import ParamSpec, resolve_dtype
from repro_torch.train.loop import make_sharded_train_step
from repro_torch.train.optimizer import AdamWConfig, AdamWState, _walk

__all__ = ["LoweredStep", "build_lowered", "param_shapes", "opt_shapes", "auto_policies",
           "rank_view", "record_collectives", "MICRO_TOKENS",
           "FSDP_BYTES_THRESHOLD"]

MICRO_TOKENS = 8192          # target tokens per device per microbatch
FSDP_BYTES_THRESHOLD = 8e9   # params+opt bytes/device above which FSDP kicks in


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def param_shapes(model: Model) -> dict:
    """The parameters as meta tensors (no allocation)."""
    dtype = resolve_dtype(model.cfg.param_dtype)

    def walk(node):
        if isinstance(node, ParamSpec):
            return _meta(node.shape, dtype)
        return {k: walk(v) for k, v in node.items()}

    return walk(model.specs())


def opt_shapes(params: Any) -> AdamWState:
    """AdamW's state for ``params`` as meta tensors: f32 moments."""
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return _meta(tree.shape, torch.float32)

    return AdamWState(step=_meta((), torch.int32), mu=zeros(params), nu=zeros(params),
                      loss_scale=_meta((), torch.float32))


def auto_policies(cfg, model: Model, mesh, shape: InputShape, fsdp: Optional[bool],
                  grad_accum: Optional[int]) -> tuple[bool, int]:
    """Resolve production memory policies (recorded per dry-run record):

    * FSDP: params are kept bf16 + f32 Adam moments = 10 bytes/param; if
      10·N / model_axis exceeds the threshold, shard the ``embed`` dim over
      the data axes too (ZeRO-3 style).  For inference (prefill/decode)
      there is no optimizer state but the same applies at 2.2 bytes/param.
    * grad accumulation: cap per-device tokens per microbatch at
      ``MICRO_TOKENS``.

    The reference's rule (``repro/launch/lowering.py``), unchanged.
    """
    msize = mesh.shape.get("model", 1)
    if fsdp is None:
        n = model.num_params()
        bytes_per_param = 10.0 if shape.kind == "train" else 2.2
        fsdp = (bytes_per_param * n / msize) > FSDP_BYTES_THRESHOLD
    if grad_accum is None:
        if shape.kind == "train":
            data_axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
            dsz = axis_size(mesh, data_axes) if data_axes else 1
            b_loc = max(shape.global_batch // dsz, 1)
            tokens_loc = b_loc * shape.seq_len
            grad_accum = 1
            while (tokens_loc // grad_accum > MICRO_TOKENS and grad_accum < b_loc
                   and b_loc % (grad_accum * 2) == 0):
                grad_accum *= 2
        else:
            grad_accum = 1
    return fsdp, grad_accum


class _Group:
    """A process group that no process holds: the ranks along ``axes``."""

    def __init__(self, axes: tuple, size: int) -> None:
        self.axes, self.size = axes, size

    def __repr__(self) -> str:
        return f"_Group({self.axes}, {self.size} ranks)"


def rank_view(mesh: LogicalMesh, rank: int = 0) -> TrainMesh:
    """``mesh`` as rank ``rank`` of a training mesh sees it (coordinates,
    axis sizes, a group object per set of axes), with no process group
    behind it: what ``layout`` and the meshed train step need to compute
    one rank's shapes and to name the collectives it would issue."""
    view = TrainMesh.__new__(TrainMesh)
    LogicalMesh.__init__(view, tuple(mesh.shape.values()), mesh.axis_names)
    view.device = torch.device("cpu")
    view.rank = rank
    sizes = tuple(view.shape.values())
    view.coords = {a: int(i) for a, i in zip(view.axis_names, np.unravel_index(rank, sizes))}
    view._groups = {}
    for k in range(1, len(sizes) + 1):
        for axes in itertools.combinations(view.axis_names, k):
            n = math.prod(view.shape[a] for a in axes)
            if n > 1:
                view._groups[axes] = _Group(axes, n)
    return view


@contextlib.contextmanager
def record_collectives(table: dict):
    """Replace the collectives the port's layout and train step issue by
    recorders that add ``{op: {"count", "bytes"}}`` to ``table`` (result
    bytes) and move nothing."""
    def bump(op: str, t: torch.Tensor) -> None:
        rec = table.setdefault(op, {"count": 0, "bytes": 0.0})
        rec["count"] += 1
        rec["bytes"] += float(t.numel() * t.element_size())

    saved = (layout.all_gather_flat, layout.reduce_scatter_flat, dist.all_reduce)
    layout.all_gather_flat = lambda out, inp, group: bump("all_gather", out)
    layout.reduce_scatter_flat = lambda out, inp, group: bump("reduce_scatter", out)
    dist.all_reduce = lambda t, *a, **kw: bump("all_reduce", t)
    try:
        yield table
    finally:
        layout.all_gather_flat, layout.reduce_scatter_flat, dist.all_reduce = saved


@dataclasses.dataclass
class LoweredStep:
    """One rank's step of (arch × shape) on a mesh, ready to count."""

    arch: str
    shape: str
    mesh_desc: str
    kind: str                     # train_step | prefill_step | serve_step
    fn: Callable
    args: tuple                   # meta tensors / trees at one rank's shapes
    cfg: Any
    mesh: TrainMesh
    rules: Ruleset
    fsdp: bool
    grad_accum: int
    resident: dict                # per-rank bytes at rest by part
    gathered: dict                # per-rank bytes a step gathers or makes full
    input_shape: InputShape

    def count(self) -> tuple[Counts, dict]:
        """The step counted on fake tensors, and its collective table."""
        table: dict = {}
        with record_collectives(table):
            counts, _ = count_program(self.fn, *self.args)
        return counts, table


def _tree_bytes(tree) -> float:
    return float(sum(t.numel() * t.element_size() for _, t in _walk(tree)
                     if isinstance(t, torch.Tensor)))


def _blocks(full: dict, spec: dict, mesh) -> dict:
    """Meta tensors of the rank's block of each leaf of ``full``."""
    out = {}
    for k, v in full.items():
        if isinstance(v, dict):
            out[k] = _blocks(v, spec[k], mesh)
        else:
            layout.check_spec(spec[k], tuple(v.shape), mesh, k)
            out[k] = _meta(layout.block_shape(tuple(v.shape), spec[k], mesh), v.dtype)
    return out


def _rows(batch: dict, mesh, rules, grad_accum: int = 1) -> dict:
    """Meta tensors of the rank's rows of a global batch (``batch_rows``'
    rule: each microbatch's rows over the data axes)."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        micro = b // grad_accum
        n = mesh.axis_size(_data_or_replicated(mesh, rules, micro))
        out[k] = _meta((grad_accum * (micro // n), *v.shape[1:]), v.dtype)
    return out


def _state_rows(state, mesh, rules):
    """The decode state's tensors at the rank's rows (dim 1 of every
    stacked leaf, dim 0 of the per-slot scalars never splits)."""
    def rows(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.dim() < 2:
            return t
        n = mesh.axis_size(_data_or_replicated(mesh, rules, t.shape[1]))
        return _meta((t.shape[0], t.shape[1] // n, *t.shape[2:]), t.dtype)

    return type(state)(*[_map(rows, x) for x in state])


def _map(fn, x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        return type(x)(*[_map(fn, y) for y in x])
    return x


def _gathered_step(model: Model, mesh, spec: dict, shapes: dict, inner: Callable) -> Callable:
    """A step that gathers every leaf of the rank's blocks to full, as the
    meshed trainer does, and runs ``inner(full_params, *rest)``."""
    from repro_torch.train.loop import _rebuild

    items = list(_walk(spec))

    def step(params, *rest):
        full = _rebuild(params, iter(layout.gather(p, sp, shapes[path], mesh)
                                     for (path, sp), (_, p) in zip(items, _walk(params))))
        with torch.no_grad():
            return inner(full, *rest)

    return step


def build_lowered(arch: str, shape: str | InputShape, mesh: LogicalMesh, *,
                  rules: Optional[Ruleset] = None, fsdp: Optional[bool] = None,
                  grad_accum: Optional[int] = None,
                  cfg_overrides: Optional[dict] = None) -> LoweredStep:
    """One (arch × shape) step on rank 0 of ``mesh`` (module docstring).
    ``fsdp`` and ``grad_accum`` default to ``auto_policies``;
    ``cfg_overrides`` replace fields of the registry's config."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    ok, why = shape_applicability(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} × {shape.name} skipped by design: {why}")

    model = Model(cfg)
    view = rank_view(mesh)
    fsdp, grad_accum = auto_policies(cfg, model, view, shape, fsdp, grad_accum)
    rules = rules or default_rules(cfg, view, fsdp=fsdp)
    spec = shard_params_spec(model, rules)
    full = param_shapes(model)
    shapes = {path: tuple(t.shape) for path, t in _walk(full)}
    blocks = _blocks(full, spec, view)
    mesh_desc = "x".join(str(n) for n in view.shape.values())
    resident = {"params": _tree_bytes(blocks)}
    gathered = {"params_full": _tree_bytes(full)}
    batch = input_specs(cfg, shape)

    if shape.kind == "train":
        opt = opt_shapes(blocks)
        resident["adamw"] = _tree_bytes({"mu": opt.mu, "nu": opt.nu}) + 8.0
        gathered["grads_full"] = _tree_bytes(full)
        rows = _rows(batch, view, rules, grad_accum)
        resident["batch"] = _tree_bytes(rows)
        fn = make_sharded_train_step(model, AdamWConfig(), view, rules, spec, grad_accum)
        args = (blocks, opt, rows)
        kind = "train_step"
    elif shape.kind == "prefill":
        rows = _rows(batch, view, rules)
        resident["batch"] = _tree_bytes(rows)
        fn = _gathered_step(model, view, spec, shapes, model.prefill)
        args = (blocks, rows)
        kind = "prefill_step"
    else:
        state = _state_rows(model.init_decode_state(shape.global_batch, shape.seq_len,
                                                    device="meta"), view, rules)
        rows = _rows(batch, view, rules)
        resident["decode_state"] = _tree_bytes(
            {str(i): t for i, t in enumerate(_leaves(state))})
        resident["batch"] = _tree_bytes(rows)

        def serve(p, st, tokens):
            logits, st = model.decode_step(p, st, tokens)
            return torch.argmax(logits, -1).to(torch.int32), st

        fn = _gathered_step(model, view, spec, shapes, serve)
        args = (blocks, state, rows["tokens"])
        kind = "serve_step"
    return LoweredStep(arch=arch, shape=shape.name, mesh_desc=mesh_desc, kind=kind, fn=fn,
                       args=args, cfg=cfg, mesh=view, rules=rules, fsdp=fsdp,
                       grad_accum=grad_accum, resident=resident, gathered=gathered,
                       input_shape=shape)


def _leaves(x) -> list:
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for y in x for t in _leaves(y)]
    return []
